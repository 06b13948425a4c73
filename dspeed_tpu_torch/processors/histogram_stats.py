"""Histogram statistics (reference ``dspeed/processors/histogram_stats.py``;
JAX package ``dspeed_tpu/processors/histogram_stats.py``).

The mode, HWHM and FWHM searches of the reference's sequential walks become
masked reductions over the fixed bin axis, with the JAX package's
first-occurrence rules on ties (``_first_max``, ``_first_min``,
``_first_true``) and ``torch.gather`` for its picks.
"""

from __future__ import annotations

import torch

from ..errors import DSPFatal
from ._helpers import isnan_any, nanmask, per_row, static_int
from ._kernel import kernel

__all__ = ["histogram_stats", "histogram_peakstats"]


def _pos(x):
    return torch.arange(x.shape[-1], device=x.device)


def _first_true(mask):
    """(index, found) of the first true along the last axis; index 0 where
    none is."""
    nb = mask.shape[-1]
    idx = torch.where(mask, _pos(mask), nb).amin(dim=-1)
    found = idx < nb
    return torch.where(found, idx, 0), found


def _first_max(w):
    """First index of the row maximum (``argmax``'s ties); 0 on an all-NaN
    row, which every caller NaN-masks."""
    nb = w.shape[-1]
    mx = w.amax(dim=-1, keepdim=True)
    idx = torch.where(w == mx, _pos(w), nb).amin(dim=-1)
    return torch.where(idx >= nb, 0, idx)


def _first_min(w):
    """First index of the row minimum (``argmin``'s ties)."""
    nb = w.shape[-1]
    mn = w.amin(dim=-1, keepdim=True)
    idx = torch.where(w == mn, _pos(w), nb).amin(dim=-1)
    return torch.where(idx >= nb, 0, idx)


def _take(x, idx):
    return torch.gather(x, -1, idx[..., None].long())[..., 0]


@kernel(
    "(n),(m),(),(),(),()",
    ["ffffff", "dddddd"],
    out_indices=[2, 3, 4],
)
def histogram_stats(weights_in, edges_in, max_in):
    """Mode index, mode edge value and the (larger-side) FWHM of a histogram
    (reference ``histogram_stats.py:165``). The outputs sit mid-signature
    like the reference's gufunc: ``(weights, edges, mode_out, max_out,
    fwhm_out, max_in)``."""
    nb = weights_in.shape[-1]
    if nb + 1 != edges_in.shape[-1]:
        raise DSPFatal(
            "length edges_in must be exactly 1 + length of weights_in"
        )
    w = weights_in
    e = edges_in
    mx = per_row(max_in, w)

    auto_idx = _first_max(w)
    # given a maximum: the closest left edge (first of equal distances),
    # the last bin beyond the last left edge
    dist = torch.abs(mx[..., None] - e[..., :nb])
    close_idx = _first_min(dist)
    over = mx > e[..., -2]
    user_idx = torch.where(over, nb - 1, close_idx)
    max_index = torch.where(torch.isnan(mx), auto_idx, user_idx)

    max_out = _take(e, max_index)
    wmax = _take(w, max_index)
    half = 0.5 * wmax

    pos = _pos(w)
    right_mask = (pos >= max_index[..., None]) & (w <= half[..., None]) & (w != 0)
    ridx, rfound = _first_true(right_mask)
    fwhm_r = torch.abs(max_out - _take(e, ridx))

    left_mask = (pos < max_index[..., None]) & (w >= half[..., None]) & (w != 0)
    lidx, lfound = _first_true(left_mask)
    fwhm_l = torch.abs(max_out - _take(e, lidx))

    # the left side only widens a right FWHM that was found (the
    # reference's `if fwhm_out[0] < ...`, histogram_stats.py:258, is False
    # on NaN)
    nan = torch.full((), float("nan"), dtype=w.dtype, device=w.device)
    fwhm = torch.where(rfound, fwhm_r, nan)
    fwhm = torch.where(lfound & rfound & (fwhm_l > fwhm_r), fwhm_l, fwhm)

    bad = isnan_any(weights_in, 1)
    return (
        nanmask(bad, max_index.to(w.dtype)),
        nanmask(bad, max_out),
        nanmask(bad, fwhm),
    )


@kernel("(n),(m),(),(),()->(),()", ["fffii->ff", "dddii->dd"])
def histogram_peakstats(weights_in, edges_in, max_in, skip_zeroes, width_type):
    """Mode (bin centre) and FWHM/HWHM width variants of a histogram peak
    (reference ``histogram_stats.py:20``)."""
    nb = weights_in.shape[-1]
    if nb + 1 != edges_in.shape[-1]:
        raise DSPFatal(
            "length edges_in must be exactly 1 + length of weights_in"
        )
    wt = static_int(width_type, "histogram_peakstats", "width_type")
    if wt not in (0, 1, 2, 3, 4):
        raise DSPFatal("width type not found.")
    w = weights_in
    e = edges_in
    mx = per_row(max_in, w)
    skip = per_row(skip_zeroes, w).to(torch.bool)

    auto_idx = _first_max(w)
    # given a maximum: the bin that holds it, clamped at the ends
    pos = _pos(w)
    contains = (e[..., :nb] <= mx[..., None]) & (mx[..., None] < e[..., 1:])
    cidx, _ = _first_true(contains)
    user_idx = torch.where(
        mx > e[..., -1], nb - 1, torch.where(mx < e[..., 0], 0, cidx)
    )
    max_index = torch.where(torch.isnan(mx), auto_idx, user_idx)

    lo = _take(e, max_index)
    hi = _take(e, max_index + 1)
    mode = lo + 0.5 * (hi - lo)
    wmax = _take(w, max_index)
    half = 0.5 * wmax

    considered = torch.where(skip[..., None], w != 0, True)
    right_mask = (pos >= max_index[..., None]) & considered & (w <= half[..., None])
    ridx, rfound = _first_true(right_mask)
    hwhm_right = torch.where(
        rfound,
        torch.abs(mode - _take(e, ridx)),
        torch.abs(mode - e[..., -1]),
    )
    left_mask = (pos <= max_index[..., None]) & considered & (w <= half[..., None])
    # the first from the right within [0, max_index]
    lidx = torch.where(left_mask, pos, -1).amax(dim=-1)
    lfound = lidx >= 0
    lidx = torch.where(lfound, lidx, 0)
    hwhm_left = torch.where(
        lfound,
        torch.abs(mode - _take(e, lidx + 1)),
        torch.abs(mode - e[..., 0]),
    )

    if wt == 0:
        width = hwhm_left + hwhm_right
    elif wt == 1:
        width = torch.minimum(hwhm_left, hwhm_right)
    elif wt == 2:
        width = torch.maximum(hwhm_left, hwhm_right)
    elif wt == 3:
        width = hwhm_left
    else:
        width = hwhm_right

    bad = isnan_any(weights_in, 1)
    return nanmask(bad, mode), nanmask(bad, width)


def _peakstats_checker(weights_in, edges_in, max_in, skip_zeroes, width_type):
    """Checked-mode flag: the reference raises on NaN weights
    (``histogram_stats.py:87-88``; ``histogram_stats`` NaNs instead)."""
    bad = isnan_any(weights_in, 1)
    return bad.to(torch.int32).expand(weights_in.shape[:-1])


histogram_peakstats.checker = _peakstats_checker
histogram_peakstats.check_messages = {1: "nan in input weights"}
