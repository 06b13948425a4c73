"""Multi-peak finding: the Billauer peak finder and its companions
(reference ``dspeed/processors/get_multi_local_extrema.py:20``,
``peak_snr_threshold.py:19``, ``multi_t_filter.py:22,88``,
``multi_a_filter.py:20``; JAX package
``dspeed_tpu/processors/peak_finding.py``).

The hysteresis state machine is sequential along the row. The JAX package
scans it (``lax.scan``); here one direction is one launch of the hand
kernel ``csrc/peakdet_scan.cu``, a warp per event
(:func:`~dspeed_tpu_torch.processors._cuda.peakdet_scan`; its plain
version on the CPU). Everything around it (the merge of two directions,
duplicate removal, the SNR windows, the amplitudes) is batched PyTorch
over the fixed slot arrays, with the JAX package's rules.
"""

from __future__ import annotations

import torch

from ..errors import DSPFatal
from ._helpers import (
    any_bad, as_tensor, isnan_any, nanmask, per_row, static_int, take_per_row,
)
from ._kernel import kernel

__all__ = [
    "get_multi_local_extrema",
    "peak_snr_threshold",
    "multi_t_filter",
    "remove_duplicates",
    "multi_a_filter",
]


def _cdim(x):
    """A slot axis appended to per-row scalars, for broadcasting."""
    if isinstance(x, torch.Tensor) and x.ndim:
        return x[..., None]
    return x


def _compact_keep(vals, keep, m):
    """The ``keep``-marked entries moved to the front in their order, NaN
    after them, ``m`` slots."""
    pos = torch.cumsum(keep.to(torch.int64), dim=-1) - 1
    slots = torch.arange(m, device=vals.device)
    onto = (pos[..., None, :] == slots[:, None]) & keep[..., None, :]
    filled = slots < keep.sum(dim=-1, keepdim=True)
    zero = torch.zeros((), dtype=vals.dtype, device=vals.device)
    out = torch.where(onto, vals[..., None, :], zero).sum(dim=-1)
    nan = torch.full((), float("nan"), dtype=vals.dtype, device=vals.device)
    return torch.where(filled, out, nan).to(vals.dtype)


def _compact_sorted_unique(vals, m):
    """Sorted unique values of NaN-padded rows, NaN-padded to ``m`` slots."""
    s, _ = torch.sort(vals, dim=-1)  # NaNs go last
    first = torch.ones_like(s, dtype=torch.bool)
    first[..., 1:] = s[..., 1:] != s[..., :-1]
    keep = first & ~torch.isnan(s)
    return _compact_keep(s, keep, m)


def _coincidence(left, right, m):
    """The values of ``left`` that also appear in ``right``, in ``left``'s
    order."""
    eq = left[..., :, None] == right[..., None, :]
    keep = eq.any(dim=-1) & ~torch.isnan(left)
    return _compact_keep(left, keep, m)


@kernel(
    "(n),(),(),(),(),(),(m),(p),(),()",
    ["ffffff" + "ffff", "dddddd" + "dddd"],
    nout=4,
    static=[3],
    uses_dims=True,
)
def get_multi_local_extrema(
    w_in, a_delta_max_in, a_delta_min_in, search_direction, a_abs_max_in,
    a_abs_min_in, dims,
):
    """Billauer peakdet: NaN-padded index lists of local maxima and minima,
    and their counts (reference ``get_multi_local_extrema.py:20``).
    ``search_direction`` 0 sweeps left to right, 1 right to left, 2 keeps
    what both find, 3 what either finds.

    As in the JAX package, mode 2's minima coincidence uses the minima
    arrays (the reference indexes ``right_vt_max`` there,
    ``get_multi_local_extrema.py:255-256``) and mode 3's union is
    NaN-compacted.
    """
    from ._cuda import peakdet_scan

    direction = static_int(
        search_direction, "get_multi_local_extrema", "search_direction"
    )
    if direction not in (0, 1, 2, 3):
        raise DSPFatal("search direction type not found.")
    m_max, m_min = dims["m"], dims["p"]
    n = w_in.shape[-1]
    if m_max >= n or m_min >= n:
        raise DSPFatal(
            "The length of your return array must be smaller than the "
            "length of your waveform"
        )
    lead = w_in.shape[:-1]
    dm, dn, am, an = (per_row(x, w_in).reshape(-1)
                      for x in (a_delta_max_in, a_delta_min_in, a_abs_max_in,
                                a_abs_min_in))
    wf = w_in.reshape(-1, n)
    if direction in (0, 2, 3):
        vl_max, vl_min, nl_max, nl_min = peakdet_scan(wf, dm, dn, am, an,
                                                      m_max, m_min)
    if direction in (1, 2, 3):
        # the right-to-left sweep records true sample indices
        vr_max, vr_min, nr_max, nr_min = peakdet_scan(wf, dm, dn, am, an,
                                                      m_max, m_min, reverse=True)
    if direction == 0:
        vmax, vmin, nmx, nmn = vl_max, vl_min, nl_max, nl_min
    elif direction == 1:
        vmax, vmin, nmx, nmn = vr_max, vr_min, nr_max, nr_min
    else:
        if direction == 2:
            vmax = _coincidence(vl_max, torch.sort(vr_max, dim=-1)[0], m_max)
            vmin = _coincidence(vl_min, torch.sort(vr_min, dim=-1)[0], m_min)
        else:
            vmax = _compact_sorted_unique(torch.cat([vl_max, vr_max], -1), m_max)
            vmin = _compact_sorted_unique(torch.cat([vl_min, vr_min], -1), m_min)
        nmx = (~torch.isnan(vmax)).sum(dim=-1).to(torch.int32)
        nmn = (~torch.isnan(vmin)).sum(dim=-1).to(torch.int32)
    vmax = vmax.reshape(*lead, m_max)
    vmin = vmin.reshape(*lead, m_min)
    nmx = nmx.reshape(lead)
    nmn = nmn.reshape(lead)

    bad = (isnan_any(w_in, 1) | torch.isnan(dm).reshape(lead)
           | torch.isnan(dn).reshape(lead))
    zero = torch.zeros_like(nmx)
    return (
        nanmask(bad, vmax),
        nanmask(bad, vmin),
        torch.where(bad, zero, nmx).to(w_in.dtype),
        torch.where(bad, zero, nmn).to(w_in.dtype),
    )


def _take(w, idx):
    return torch.gather(w, -1, idx.long())


@kernel("(n),(m),(),(),(m),()", ["fffff" + "f", "ddddd" + "d"], nout=2)
def peak_snr_threshold(w_in, idx_in, ratio_in, width_in):
    """Keep the candidate peaks whose windowed local minimum over the peak
    is below ``ratio_in`` (reference ``peak_snr_threshold.py:19``): the
    JAX package's CPU form, a gather of each window."""
    width = static_int(width_in, "peak_snr_threshold", "width_in")
    n = w_in.shape[-1]
    m = idx_in.shape[-1]
    idx = torch.nan_to_num(idx_in, nan=0.0).to(torch.int32)
    valid = ~torch.isnan(idx_in)

    a = torch.clamp(idx - width, 0, n - 1)
    b = torch.clamp(idx + width, 0, n - 1)  # exclusive, clipped like the reference
    # window positions a .. a+2w-1, masked to < b (the reference's range(a, b))
    offs = torch.arange(2 * width, device=w_in.device, dtype=torch.int32)
    pos = a[..., None] + offs  # (..., m, 2w)
    in_win = pos < b[..., None]
    lead = pos.shape[:-2]
    wvals = _take(w_in, pos.clamp(0, n - 1).reshape(*lead, m * 2 * width))
    wvals = wvals.reshape(*lead, m, 2 * width)
    inf = torch.full((), float("inf"), dtype=w_in.dtype, device=w_in.device)
    wvals = torch.where(in_win, wvals, inf)
    # an empty window (b <= a) takes its minimum at a, like the reference
    wa = _take(w_in, a)
    wmin = torch.minimum(wvals.amin(dim=-1), wa) if width > 0 else wa
    peak = _take(w_in, idx.clamp(0, n - 1))
    passing = valid & (torch.abs(wmin / peak) < _cdim(ratio_in))
    idx_out = _compact_keep(idx_in, passing, m)
    n_out = passing.sum(dim=-1).to(w_in.dtype)
    return idx_out, n_out


@kernel("(n),(n)->(n)", ["ff->f", "dd->d"])
def remove_duplicates(t_in, vt_min_in):
    """De-duplicate time points, each repeat replaced by the matching
    minimum (reference ``multi_t_filter.py:22``); a leading index 0 is
    shifted out."""
    m = t_in.shape[-1]
    i1 = torch.arange(m, device=t_in.device)
    eq = (t_in[..., :, None] == t_in[..., None, :]) & (i1[:, None] < i1[None, :])
    # the last i1 < i2 with an equal value wins (the reference's loop order)
    best = torch.where(eq, i1[:, None], -1).amax(dim=-2)
    dup = best >= 0
    repl = _take(vt_min_in, best.clamp(0, m - 1))
    nan = torch.full((), float("nan"), dtype=t_in.dtype, device=t_in.device)
    t_out = torch.where(dup, repl, torch.where(torch.isnan(t_in), nan, t_in))
    # a first entry at index 0 shifts everything left
    shift = t_out[..., 0] == 0
    shifted = torch.cat([t_out[..., 1:], torch.full_like(t_out[..., :1], float("nan"))],
                        dim=-1)
    t_out = torch.where(shift[..., None], shifted, t_out)
    all_nan = torch.isnan(t_in).all(dim=-1) & torch.isnan(vt_min_in).all(dim=-1)
    return nanmask(all_nan, t_out)


@kernel("(n),(),(m),(m),(m)", ["fffff", "ddddd"], nout=1)
def multi_t_filter(w_in, a_threshold_in, vt_max_in, vt_min_in):
    """Leading-edge times of the found maxima: the port's
    ``time_point_thresh`` walking back from each maximum, then duplicate
    removal (reference ``multi_t_filter.py:88``)."""
    from .time_point_thresh import time_point_thresh

    m = vt_max_in.shape[-1]
    n = w_in.shape[-1]
    if m > n:
        raise DSPFatal(
            "The length of your return array must be smaller than the "
            "length of your waveform"
        )
    lead = torch.broadcast_shapes(w_in.shape[:-1], vt_max_in.shape[:-1])
    planes = w_in[..., None, :].expand(*lead, m, n)
    a = as_tensor(a_threshold_in, w_in, w_in.dtype)
    a = (a[..., None] if a.ndim else a).expand(*lead, m)
    (tp,) = time_point_thresh(planes, a, vt_max_in.expand(*lead, m), 0)
    (t_out,) = remove_duplicates(tp, vt_min_in)
    bad = any_bad(isnan_any(w_in, 1), isnan_any(a_threshold_in))
    return nanmask(bad, t_out)


@kernel("(n),(m)->(m)", ["ff->f", "dd->d"])
def multi_a_filter(w_in, vt_max_in):
    """Amplitudes at the found maxima (reference ``multi_a_filter.py:20``)."""
    n = w_in.shape[-1]
    idx = torch.nan_to_num(vt_max_in, nan=0.0).to(torch.int32)
    valid = ~torch.isnan(vt_max_in) & (idx >= 0) & (idx < n)
    vals = take_per_row(w_in, idx)
    nan = torch.full((), float("nan"), dtype=w_in.dtype, device=w_in.device)
    out = torch.where(valid, vals, nan).to(w_in.dtype)
    return nanmask(isnan_any(w_in, 1), out)


# generic row-tile fusion: the JAX package's flag (the sweep and the
# gathers of peak_snr_threshold stay out of groups)
multi_a_filter.tile_safe = True
