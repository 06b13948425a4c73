"""Prefix sums at accumulation precision and zero-filled shifts.

The JAX package reformulates the reference's sequential recursions as
differences of prefix sums and, for the TPU, carries those sums in
compensated float32 (``dspeed_tpu/processors/_numerics.py``). Both the CPU
and the H100 run float64 natively, so here a prefix sum is one ``cumsum`` in
the accumulation dtype of :mod:`dspeed_tpu_torch.config`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import config

__all__ = ["hp_cumsum", "shift_right", "true_div"]


def hp_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum over the last axis at accumulation precision."""
    return torch.cumsum(x.to(config.accum_dtype()), dim=-1)


def true_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` rounded once, with ``d`` in ``x``'s type. On CUDA PyTorch
    divides by a python scalar as a product with its rounded reciprocal; a
    divisor on the device is a true division, as in the kernels and the JAX
    package."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def shift_right(x: torch.Tensor, k: int, fill: float = 0.0) -> torch.Tensor:
    """``x[..., i - k]`` along the last axis, ``fill`` where ``i < k``."""
    if k == 0:
        return x
    n = x.shape[-1]
    k = min(k, n)
    return F.pad(x[..., : n - k], (k, 0), value=fill)
