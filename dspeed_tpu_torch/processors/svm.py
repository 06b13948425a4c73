"""SVM inference factory (reference ``dspeed/processors/svm.py:13``; JAX
package ``dspeed_tpu/processors/svm.py``).

Unpickles a scikit-learn SVM when the chain is built and runs its
``.predict`` on the host, as the reference's object-mode wrapper and the
JAX package's ``pure_callback`` do. The step copies the rows to host numpy
and its result back, so on the card it synchronises the stream: a
configuration that runs it pays one device round trip a chunk.
"""

from __future__ import annotations

import pickle

import numpy as np
import torch

from ..errors import DSPFatal
from ._kernel import Kernel

__all__ = ["svm_predict"]


def svm_predict(svm_file: str) -> Kernel:
    """A ``(n)->()`` processor: the SVM of the pickle ``svm_file`` applied to
    each row (NaN samples read as 0 by the model), float64; NaN where the
    row holds a NaN. The file is the user's own model: unpickling runs its
    code."""
    try:
        with open(svm_file, "rb") as f:
            svm = pickle.load(f)
    except OSError as e:
        raise DSPFatal(f"could not load SVM pickle {svm_file!r}") from e
    if not hasattr(svm, "predict"):
        raise DSPFatal(f"{svm_file!r} does not contain an object with .predict")

    def fn(w_in):
        # a host round trip: the copy to numpy waits for the card
        x = torch.nan_to_num(w_in).double().cpu().numpy()
        flat = x.reshape(-1, x.shape[-1])
        pred = np.asarray(svm.predict(flat), dtype=np.float64).reshape(x.shape[:-1])
        out = torch.from_numpy(pred).to(w_in.device)
        # reference svm.py:55: NaN for a row with a NaN
        return torch.where(torch.isnan(w_in).any(-1),
                           torch.full((), float("nan"), dtype=out.dtype,
                                      device=out.device), out)

    return Kernel(fn, "(n)->()", ["f->d", "d->d"], name="svm_predict")
