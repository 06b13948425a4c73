"""dspeed_tpu_torch: the PyTorch / CUDA port of dspeed_tpu.

JSON/YAML-declared DSP graphs over batched LH5 waveform tables, run eagerly
on an NVIDIA H100 (or, when the caller asks for it, on the CPU). The hot
waveform passes of the main path are hand-written CUDA kernels
(``processors/_cuda.py``, ``csrc/``).

Top-level API mirrors the JAX package and the reference:
``build_dsp``, ``ProcessingChain``, ``build_processing_chain``.
"""

from __future__ import annotations

__version__ = "0.1.0"

__all__ = [
    "__version__",
    "build_dsp",
    "ProcessingChain",
    "build_processing_chain",
]


def __getattr__(name):
    # lazy imports keep `import dspeed_tpu_torch.lh5` cheap (no torch import)
    if name == "build_dsp":
        from .build_dsp import build_dsp

        # the submodule import binds `dspeed_tpu_torch.build_dsp` to the
        # module; rebind to the function so repeated imports stay callable
        globals()["build_dsp"] = build_dsp
        return build_dsp
    if name in ("ProcessingChain", "build_processing_chain"):
        from . import processing_chain

        val = getattr(processing_chain, name)
        globals()[name] = val
        return val
    raise AttributeError(name)
