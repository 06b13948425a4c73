"""Threshold-crossing time-point finders (reference
``dspeed/processors/time_point_thresh.py``; JAX package
``dspeed_tpu/processors/time_point_thresh.py``).

The reference's sequential early-exit walk "first crossing from ``t_start``
in direction ``d``" becomes a masked min/max reduction over a vectorized
crossing predicate, as in the JAX package. Data-dependent ``DSPFatal``
conditions of the reference (non-integral or out-of-range ``t_start``) give
NaN for the affected event instead of aborting.

Ported so far: :func:`time_point_thresh` and :func:`tp_from_cross_mask`;
the interpolated and multi variants and the checked-mode ``checker`` are
queued in ROADMAP.
"""

from __future__ import annotations

import numpy as np
import torch

from ._helpers import as_tensor, isnan_any, nanmask
from ._kernel import Kernel, kernel

__all__ = ["time_point_thresh", "tp_from_cross_mask"]


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


def _first_true_from(mask, start, direction):
    """Index of the first true in ``mask`` walking from ``start``
    (inclusive) in ``direction`` (+1/-1); returns ``(idx, found)``. A
    masked min/max over the positions (JAX package
    ``time_point_thresh.py:34``); ``idx`` is 0 (forward) or n-1 (backward)
    where nothing is found."""
    n = mask.shape[-1]
    pos = torch.arange(n, device=mask.device)
    if direction > 0:
        valid = mask & (pos >= start[..., None])
        idx = torch.where(valid, pos, n).amin(dim=-1)
        found = idx < n
        return torch.where(found, idx, 0), found
    valid = mask & (pos <= start[..., None])
    idx = torch.where(valid, pos, -1).amax(dim=-1)
    found = idx >= 0
    return torch.where(found, idx, n - 1), found


def _start_index(t_start, lead, n, device):
    """``(t, ti, ok)``: the start as a floating tensor, its truncation as an
    integer index (0 where it is not usable) and whether it is integral and
    inside ``[0, n)`` — the start-index rule of the JAX package
    (``time_point_thresh.py:94-123``). NaN starts are not ok."""
    t = torch.as_tensor(t_start, device=device)
    if not t.is_floating_point():
        t = t.to(torch.float64)
    tt = torch.trunc(t)
    ok = (tt >= 0) & (tt < n) & (tt == t)
    ti = torch.where(ok, tt, torch.zeros((), dtype=t.dtype, device=device))
    ti = ti.to(torch.int64).expand(lead)
    return t, ti, ok.expand(lead)


@kernel("(n),(),(),()->()", ["ffff->f", "dddd->d"], badrow_arg=0)
def time_point_thresh(w_in, a_threshold, t_start, walk_forward, badrow=None):
    """Index just before the threshold crossing, walking forward or back
    from ``t_start`` (reference ``time_point_thresh.py:20``). NaN where the
    row holds a NaN, the threshold or the start is NaN, the start is not an
    integral index inside the row, or no crossing is found."""
    n = w_in.shape[-1]
    lead = w_in.shape[:-1]
    a = as_tensor(a_threshold, w_in, w_in.dtype)
    if a.ndim == 0:
        a = a.expand(lead)
    t, ti, ok = _start_index(t_start, lead, n, w_in.device)
    fwd, bwd = _crossing_masks(w_in, a)
    if isinstance(walk_forward, (int, float, np.integer, np.floating)):
        mask, sgn = (fwd, +1) if int(walk_forward) == 1 else (bwd, -1)
        idx, found = _first_true_from(mask, ti, sgn)
    else:
        idx_f, found_f = _first_true_from(fwd, ti, +1)
        idx_b, found_b = _first_true_from(bwd, ti, -1)
        forward = as_tensor(walk_forward, w_in) == 1
        idx = torch.where(forward, idx_f, idx_b)
        found = torch.where(forward, found_f, found_b)
    row = isnan_any(w_in, 1) if badrow is None else badrow
    bad = row | torch.isnan(a) | isnan_any(t) | ~ok | ~found
    return nanmask(bad, idx.to(w_in.dtype))


def tp_from_cross_mask(walk_forward: int) -> Kernel:
    """Factory: finish a :func:`time_point_thresh` whose crossing
    predicates a fused front emitted as a uint8 bit plane (bit 0: forward
    crossing at ``i``, bit 1: backward crossing at ``i`` — exactly
    :func:`_crossing_masks`' positions; JAX package
    ``time_point_thresh.py:543``). Bit-identical to ``time_point_thresh(
    trap, a, t_start, walk)``: a poisoned row or a NaN threshold arrives as
    an all-zero plane (not found -> NaN), and the start-index rule is the
    original kernel's. The engine substitutes it for searches over traps
    the energy front holds (the flagship's ``tp_0_atrap``)."""
    wf = int(walk_forward)

    def fn(mask_in, t_start):
        n = mask_in.shape[-1]
        lead = mask_in.shape[:-1]
        t, ti, ok = _start_index(t_start, lead, n, mask_in.device)
        m = (mask_in & (1 if wf == 1 else 2)) != 0
        idx, found = _first_true_from(m, ti, +1 if wf == 1 else -1)
        bad = isnan_any(t) | ~ok | ~found
        return nanmask(bad, idx.to(torch.float32))

    return Kernel(
        fn, "(n),()->()", ["Bf->f", "Bd->d"], name="tp_from_cross_mask"
    )


# generic row-tile fusion (the JAX package's flags)
time_point_thresh.tile_safe = True
