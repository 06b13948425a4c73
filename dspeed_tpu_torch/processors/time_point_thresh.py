"""Threshold-crossing time-point finders (reference
``dspeed/processors/time_point_thresh.py``; JAX package
``dspeed_tpu/processors/time_point_thresh.py``).

The reference's sequential early-exit walk "first crossing from ``t_start``
in direction ``d``" becomes a masked min/max reduction over a vectorized
crossing predicate, as in the JAX package. Data-dependent ``DSPFatal``
conditions of the reference (non-integral or out-of-range ``t_start``) give
NaN for the affected event instead of aborting.

:func:`multi_time_point_thresh` runs its chained searches over the m
thresholds as plain tensor ops; :func:`bi_level_zero_crossing_time_points`
sweeps every sample of a row with its five-flag state machine, which runs as
a hand kernel on the card (:func:`._cuda.bilevel_scan`, ``csrc/bilevel_scan.cu``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..errors import DSPFatal
from ._helpers import any_bad, as_tensor, isnan_any, nanmask, static_int, take_per_row
from ._kernel import Kernel, kernel

__all__ = [
    "time_point_thresh",
    "interpolated_time_point_thresh",
    "multi_time_point_thresh",
    "bi_level_zero_crossing_time_points",
    "tp_from_cross_mask",
]

MODES = tuple(ord(c) for c in "iabrnlfc")


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


def _float_of(x, like):
    """``x`` as a floating tensor on ``like``'s device (float64 unless it is
    a floating tensor already)."""
    t = torch.as_tensor(x, device=like.device)
    return t if t.is_floating_point() else t.to(torch.float64)


def _start_index_checker(w_in, a, t, nan_extra=None):
    """The checked-mode flag of the reference's per-event start-index
    fatals (``time_point_thresh.py:66-74``; NaN inputs give NaN outputs
    first, so they do not flag): 1 = a start that is not an integer, 2 = a
    start out of range (JAX package ``time_point_thresh.py:126``)."""
    n = w_in.shape[-1]
    t = torch.as_tensor(t, device=w_in.device)
    skip = any_bad(isnan_any(w_in, 1), isnan_any(_float_of(a, w_in)), isnan_any(t))
    if nan_extra is not None:
        skip = any_bad(skip, nan_extra)
    if t.is_floating_point():
        nonint = torch.floor(t) != t
        ti = torch.floor(t)
    else:
        nonint = torch.zeros(t.shape, dtype=torch.bool, device=t.device)
        ti = t
    oor = (ti < 0) | (ti >= n)
    code = torch.where(nonint, 1, torch.where(oor, 2, 0)).to(torch.int32)
    if isinstance(skip, torch.Tensor):
        code = torch.where(skip, 0, code)
    elif skip:
        code = torch.zeros_like(code)
    return code.expand(torch.broadcast_shapes(code.shape, w_in.shape[:-1]))


def _tpt_checker(w_in, a_threshold, t_start, walk_forward, badrow=None):
    return _start_index_checker(w_in, a_threshold, t_start)


time_point_thresh.checker = _tpt_checker
time_point_thresh.check_messages = {
    1: "The starting index must be an integer",
    2: "The starting index is out of range",
}


@kernel("(n),(),(),(),()->()", ["fffib->f", "dddlb->d"], static=[4])
def interpolated_time_point_thresh(w_in, a_threshold, t_start, walk_forward, mode_in):
    """The crossing time with sub-sample interpolation (reference
    ``time_point_thresh.py:103``), ``mode_in`` one of ``iabrnlfc``. The
    backward walk covers ``i >= 2`` only and reports ``i - 1``, as the
    reference's loop does. NaN where the row, the threshold or the start
    holds a NaN, the start lies outside ``[0, n)`` or nothing is found."""
    mode = static_int(mode_in, "interpolated_time_point_thresh", "mode_in")
    if mode not in MODES:
        raise DSPFatal("Unrecognized interpolation mode")
    n = w_in.shape[-1]
    lead = w_in.shape[:-1]
    a = as_tensor(a_threshold, w_in, w_in.dtype)
    if a.ndim == 0:
        a = a.expand(lead)
    t = _float_of(t_start, w_in)
    ti = torch.trunc(torch.nan_to_num(t)).clamp(-1, n).to(torch.int64).expand(lead)
    fwd, bwd = _crossing_masks(w_in, a)
    bwd = bwd & (torch.arange(n, device=w_in.device) >= 2)
    if isinstance(walk_forward, (int, float, np.integer, np.floating)):
        if walk_forward > 0:
            i_cross, found = _first_true_from(fwd, ti, +1)
        else:
            i_cross, found = _first_true_from(bwd, ti, -1)
            i_cross = i_cross - 1
    else:
        idx_f, found_f = _first_true_from(fwd, ti, +1)
        idx_b, found_b = _first_true_from(bwd, ti, -1)
        cond = as_tensor(walk_forward, w_in) > 0
        i_cross = torch.where(cond, idx_f, idx_b - 1)
        found = torch.where(cond, found_f, found_b)
    dt = w_in.dtype
    w_c = take_per_row(w_in, i_cross[..., None])[..., 0]
    w_c1 = take_per_row(w_in, i_cross[..., None] + 1)[..., 0]
    fi = i_cross.to(dt)
    ch = chr(mode)
    if ch in ("i", "b", "c"):
        val = fi
    elif ch in ("a", "f"):
        val = (i_cross + 1).to(dt)
    elif ch == "r":
        val = torch.where((a - w_c).abs() < (a - w_c1).abs(), i_cross,
                          i_cross + 1).to(dt)
    elif ch == "n":
        val = fi + 0.5
    else:  # 'l'
        val = fi + (a - w_c) / (w_c1 - w_c)
    in_range = (t >= 0) & (t < n)
    bad = isnan_any(w_in, 1) | torch.isnan(a) | isnan_any(t) | ~in_range | ~found
    return nanmask(bad, val)


@kernel("(n),(m),(),(),()->(m)", ["ffffb->f", "ddddb->d"], static=[4])
def multi_time_point_thresh(w_in, a_threshold, t_start, polarity, mode_in):
    """Every threshold of ``a_threshold`` in one sweep (reference
    ``time_point_thresh.py:233``; JAX package :221). The thresholds are
    sorted and split at ``w[t_start]``: the up side walks along
    ``polarity`` from ``t_start``, the down side against it from
    ``t_start - 1``, each threshold from its predecessor's crossing, and
    once one is not found every later one on that side stays NaN (so
    independent first-crossing searches would be wrong on a row that is not
    monotone). With polarity -1 the walks wrap around as the reference's
    negative indices do (``roll``, and a virtual start at -1). Mode ``'r'``
    compares ``a - w_c < w_cp - a``, without absolute values. The
    polarity must be static."""
    mode = static_int(mode_in, "multi_time_point_thresh", "mode_in")
    if mode not in MODES:
        raise DSPFatal("Unrecognized interpolation mode")
    if not isinstance(polarity, (int, float, np.integer, np.floating)) or (
            isinstance(polarity, torch.Tensor)):
        raise DSPFatal("multi_time_point_thresh requires a static polarity")
    if polarity == 0:
        raise DSPFatal("polarity cannot be 0")
    pol = 1 if polarity > 0 else -1
    n = w_in.shape[-1]
    dev, dt = w_in.device, w_in.dtype
    a = as_tensor(a_threshold, w_in, dt)
    t = _float_of(t_start, w_in)
    ti = torch.trunc(torch.nan_to_num(t)).clamp(-1, n).to(torch.int64)
    m = a.shape[-1]
    bshape = torch.broadcast_shapes(w_in.shape[:-1], a.shape[:-1], ti.shape)
    w = w_in.expand(*bshape, n)
    ab = a.expand(*bshape, m)
    tib = ti.expand(bshape)
    a_start = take_per_row(w, tib[..., None])[..., 0]
    w_next = torch.roll(w, -pol, dims=-1)  # wraps as negative indices do
    pos = torch.arange(n, device=dev)
    order = torch.sort(ab, dim=-1, stable=True).indices
    a_sorted = torch.gather(ab, -1, order)
    up = a_sorted >= a_start[..., None]

    def chain(ks, p0, increasing, virtual_minus1):
        """The chained walk over the thresholds ``ks`` in order (side mask
        ``up`` or not per row); returns ``{k: (idx, hit)}``."""
        p = p0
        alive = torch.ones(bshape, dtype=torch.bool, device=dev)
        res = {}
        for k, want_up in ks:
            thr = a_sorted[..., k]
            active = up[..., k] if want_up else ~up[..., k]
            tcol = thr[..., None]
            cross = (w <= tcol) & (tcol < w_next)
            if increasing:
                valid = cross & (pos >= p.clamp(min=0)[..., None]) & (pos <= n - 2)
                idx = torch.where(valid, pos, n).amin(-1)
                found = idx < n
                idx = torch.where(found, idx, 0)
                if virtual_minus1:
                    vhit = (p <= -1) & cross[..., n - 1]
                    idx = torch.where(vhit, -1, idx)
                    found = found | vhit
            else:
                valid = cross & (pos <= p[..., None])
                idx = torch.where(valid, pos, -1).amax(-1)
                found = idx >= 0
                idx = torch.where(found, idx, 0)
            hit = active & alive & found
            p = torch.where(hit, idx, p)
            alive = alive & (found | ~active)
            res[k] = (torch.where(hit, idx, 0), hit)
        return res

    up_res = chain([(k, True) for k in range(m)], tib, pol > 0, False)
    dn_res = chain([(k, False) for k in reversed(range(m))], tib - 1, pol < 0,
                   pol < 0)
    idx_sorted = torch.stack([torch.where(up[..., k], up_res[k][0], dn_res[k][0])
                              for k in range(m)], -1)
    hit_sorted = torch.stack([torch.where(up[..., k], up_res[k][1], dn_res[k][1])
                              for k in range(m)], -1)
    inv = torch.argsort(order, dim=-1)
    idx = torch.gather(idx_sorted, -1, inv)
    found = torch.gather(hit_sorted, -1, inv)
    # the reference's negative index at idx + pol = -1 wraps to n - 1
    wb = w[..., None, :].expand(*bshape, m, n)
    w_c = torch.gather(wb, -1, torch.remainder(idx, n)[..., None])[..., 0]
    w_cp = torch.gather(wb, -1, torch.remainder(idx + pol, n)[..., None])[..., 0]
    fi = idx.to(dt)
    ch = chr(mode)
    if ch == "i":
        val = fi
    elif ch in ("a", "f"):
        val = fi if pol < 0 else fi + 1
    elif ch in ("b", "c"):
        val = fi if pol > 0 else fi - 1
    elif ch == "r":
        val = torch.where(ab - w_c < w_cp - ab, fi, fi + pol)
    elif ch == "n":
        val = fi + 0.5 * pol
    else:  # 'l'
        val = fi + (ab - w_c) / (w_cp - w_c)
    in_range = (t >= 0) & (t < n)
    bad = isnan_any(w_in, 1) | isnan_any(a, 1) | isnan_any(t) | ~in_range
    val = torch.where(found, val, torch.full((), float("nan"), dtype=dt, device=dev))
    return nanmask(bad, val)


def _mtpt_checker(w_in, a_threshold, t_start, polarity, mode_in):
    """The checked-mode flag of the reference's polarity fatal
    (``time_point_thresh.py:313-314``): 1 = polarity 0. NaN inputs and a
    start out of range give NaN outputs first (``:302-307``) and do not
    flag (JAX package :576)."""
    n = w_in.shape[-1]
    a = as_tensor(a_threshold, w_in)
    t = _float_of(t_start, w_in)
    skip = isnan_any(w_in, 1) | isnan_any(a, 1) | isnan_any(t) | (t < 0) | (t >= n)
    pol = torch.as_tensor(polarity, device=w_in.device)
    code = (~skip & (pol == 0)).to(torch.int32)
    return code.expand(torch.broadcast_shapes(code.shape, w_in.shape[:-1]))


multi_time_point_thresh.checker = _mtpt_checker
multi_time_point_thresh.check_messages = {1: "polarity cannot be 0"}


@kernel(
    "(n),(),(),(),(),(),(m),(m)",
    ["fffff" + "Iff", "ddddd" + "Idd"],
    nout=3,
    uses_dims=True,
)
def bi_level_zero_crossing_time_points(
    w_in, a_pos_threshold_in, a_neg_threshold_in, gate_time_in, t_start_in, dims
):
    """The gated bipolar-threshold zero-crossing trigger (reference
    ``time_point_thresh.py:412``; JAX package :400): zero crossings
    bracketed by a crossing of one threshold and a return through the
    opposite one within ``gate_time`` samples. The RC-CR² filter's
    companion. Outputs ``(n_crossings uint32, polarity (m), t_trig_times
    (m))``: the count keeps going past the ``m`` slots, a slot holds 0 or 1
    and the zero crossing's sample in the row's type, the rest NaN. A row
    holding a NaN, or whose start is not an integer inside the row, gives 0
    crossings and NaN slots. The sweep is :func:`._cuda.bilevel_scan`."""
    from ._cuda import bilevel_scan

    m = dims["m"]
    n = w_in.shape[-1]
    lead = w_in.shape[:-1]
    dt, dev = w_in.dtype, w_in.device
    wf = w_in.reshape(-1, n)
    B = wf.shape[0]

    def rows(x, dtype):
        return torch.as_tensor(x, device=dev).to(dtype).expand(lead).reshape(B)

    gate = _float_of(gate_time_in, w_in)
    tstart = _float_of(t_start_in, w_in)
    pos = rows(as_tensor(a_pos_threshold_in, w_in, dt), dt)
    neg = rows(as_tensor(a_neg_threshold_in, w_in, dt), dt)

    def index(x):
        # a NaN (a poisoned row) as 0; the row's outputs are masked below
        return rows(torch.trunc(torch.nan_to_num(x)).clamp(-2**31, 2**31 - 1),
                    torch.int32)

    nc, pol, trig = bilevel_scan(wf.contiguous(), pos.contiguous(),
                                 neg.contiguous(), index(gate), index(tstart), m)
    ts = tstart.to(torch.float64 if dt == torch.float64 else torch.float32)
    tt = torch.trunc(ts)
    bad = (isnan_any(w_in, 1) | torch.isnan(pos.reshape(lead))
           | torch.isnan(neg.reshape(lead)) | isnan_any(gate) | isnan_any(ts)
           | (torch.floor(ts) != ts) | (tt < 0) | (tt >= n))
    pol = nanmask(bad, pol.reshape(*lead, m))
    trig = nanmask(bad, trig.reshape(*lead, m))
    nc_out = torch.where(bad, 0, nc.reshape(lead).to(torch.int64)).to(torch.uint32)
    return nc_out, pol, trig


def _bilevel_checker(w_in, a_pos_threshold_in, a_neg_threshold_in, gate_time_in,
                     t_start_in, dims=None):
    """The checked-mode flag of the reference's per-event start-index
    fatals (``time_point_thresh.py:478-483``); NaN thresholds and rows give
    NaN outputs first (JAX package :523)."""
    nan_extra = isnan_any(_float_of(a_neg_threshold_in, w_in))
    return _start_index_checker(w_in, a_pos_threshold_in, t_start_in,
                                nan_extra=nan_extra)


bi_level_zero_crossing_time_points.checker = _bilevel_checker
bi_level_zero_crossing_time_points.check_messages = {
    1: "The starting index must be an integer",
    2: "The starting index is out of range",
}


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
interpolated_time_point_thresh.tile_safe = True
