"""TensorFlow / Keras model inference factory (reference
``dspeed/processors/tf_model.py:10``; JAX package
``dspeed_tpu/processors/tf_model.py``).

TensorFlow is imported when the factory runs; without it the factory raises
``DSPFatal``. With it, the loaded model predicts on the host (the rows copied
to numpy, which on the card synchronises the stream): the layers of
:mod:`.ml` are the native path for networks defined in a configuration.
"""

from __future__ import annotations

import numpy as np
import torch

from ..errors import DSPFatal
from ._kernel import Kernel

__all__ = ["tf_model"]


def tf_model(model_file: str) -> Kernel:
    """A ``(n)->(m)`` processor: the Keras model of ``model_file`` applied to
    each row, float64 (``m`` its last output dimension)."""
    try:
        from tensorflow import keras  # noqa: PLC0415
    except ImportError as e:
        raise DSPFatal(
            "tf_model requires tensorflow, which is not installed; use the "
            "dspeed_tpu_torch.processors.ml layers for config-defined networks"
        ) from e
    model = keras.models.load_model(model_file)
    out_dim = int(model.output_shape[-1])

    def fn(w_in):
        # a host round trip: the copy to numpy waits for the card
        x = w_in.cpu().numpy()
        flat = x.reshape(-1, x.shape[-1])
        pred = np.asarray(model.predict(flat, verbose=0)).astype(np.float64)
        return torch.from_numpy(pred.reshape(*x.shape[:-1], out_dim)).to(w_in.device)

    return Kernel(fn, "(n)->(m)", ["f->d", "d->d"], name="tf_model")
