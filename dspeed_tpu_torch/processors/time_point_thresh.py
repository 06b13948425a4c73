"""Threshold-crossing predicates (reference
``dspeed/processors/time_point_thresh.py:76-92``).

Only the crossing-mask helper that the fused energy front's mask outputs use
is ported so far; ``time_point_thresh`` and its variants are queued in
ROADMAP (timing slice).
"""

from __future__ import annotations

import torch

__all__ = ["_crossing_masks"]


def _crossing_masks(w_in, a):
    """Forward/backward threshold-crossing predicates.

    fwd[i] (i in [0, n-2]): crossing between samples i and i+1, either
    direction; reported index is i (reference ``time_point_thresh.py:76-83``).
    bwd[i] (i in [1, n-1]): crossing between i-1 and i with the reference's
    strict/inclusive orientation (``:85-92``); reported index is i.
    """
    if isinstance(a, torch.Tensor) and a.ndim:
        a = a[..., None]
    w0 = w_in[..., :-1]
    w1 = w_in[..., 1:]
    zero = torch.zeros(w_in.shape[:-1] + (1,), dtype=torch.bool,
                       device=w_in.device)
    up = (w0 <= a) & (a < w1)
    dn = (w0 >= a) & (a > w1)
    fwd = torch.cat([up | dn, zero], dim=-1)
    upb = (w0 < a) & (a <= w1)
    dnb = (w0 > a) & (a >= w1)
    bwd = torch.cat([zero, upb | dnb], dim=-1)
    return fwd, bwd
