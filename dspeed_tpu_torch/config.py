"""Numerical and device policy for dspeed_tpu_torch.

The reference performs its hot recursions in float64 scratch buffers even for
float32 data (e.g. ``dspeed/processors/pole_zero.py:62-73``). Both the CPU and
the H100 run float64 natively, so the prefix-sum reformulations of those
recursions accumulate in float64 (:func:`accum_dtype`), as the JAX package
does under x64 (``dspeed_tpu/config.py:28-31``). Whether the card should
accumulate in float32 instead is a question for measurement; this function is
the one place that decides.

Entry points take a ``device`` argument; ``None`` means ``DEFAULT_DEVICE``
(``"cuda"``). Asking for CUDA on a machine without a card raises: the port
never moves to the CPU on its own.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def accum_dtype() -> torch.dtype:
    """The dtype prefix sums and fit moments accumulate in."""
    return torch.float64


def resolve_device(device=None) -> torch.device:
    """The ``torch.device`` an entry point runs on; raises when CUDA is asked
    for and no card is present."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "dspeed_tpu_torch: device 'cuda' requested but no CUDA device is "
            "available; pass device='cpu' to run on the CPU"
        )
    return dev
