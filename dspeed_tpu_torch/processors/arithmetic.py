"""Simple arithmetic reductions (reference
``dspeed/processors/arithmetic.py:17``; JAX package
``dspeed_tpu/processors/arithmetic.py:14``)."""

from __future__ import annotations

import torch

from ._helpers import any_bad, as_tensor, cdim, isnan_any, nanmask
from ._kernel import kernel
from ._numerics import k7_sum

__all__ = ["mean_below_threshold"]


@kernel("(n),()->()", ["ff->f", "dd->d"])
def mean_below_threshold(w_in, a_threshold):
    """Mean of the samples strictly below ``a_threshold``; NaN when no sample
    qualifies or inputs contain NaN."""
    thr = cdim(as_tensor(a_threshold, w_in, w_in.dtype))
    sel = w_in < thr
    cnt = sel.sum(dim=-1)
    tot = torch.where(sel, w_in, torch.zeros((), dtype=w_in.dtype,
                                             device=w_in.device)).sum(dim=-1)
    out = torch.where(cnt > 0, tot / cnt.clamp(min=1).to(w_in.dtype),
                      torch.full((), float("nan"), dtype=w_in.dtype,
                                 device=w_in.device))
    return nanmask(any_bad(isnan_any(w_in, 1), isnan_any(a_threshold)), out)


def mean_below_threshold_k7(w_in, a_threshold, f64=False):
    """:func:`mean_below_threshold` as K7's op computes it (the tape's plain
    walk): the selected samples summed in float64 in K7's block order
    (:func:`._numerics.k7_sum`), divided by their count in float64 and
    rounded once to the row's type. K7's float64 op (``f64``: a float64
    program's row) takes the same float64 sums and rounds nothing more."""
    thr = cdim(as_tensor(a_threshold, w_in, w_in.dtype))
    sel = w_in < thr
    cnt = sel.sum(dim=-1)
    tot = k7_sum(torch.where(sel, w_in, torch.zeros((), dtype=w_in.dtype,
                                                    device=w_in.device)))
    out = torch.where(cnt > 0, (tot / cnt.to(torch.float64)).to(w_in.dtype),
                      torch.full((), float("nan"), dtype=w_in.dtype,
                                 device=w_in.device))
    return nanmask(any_bad(isnan_any(w_in, 1), isnan_any(a_threshold)), out)


mean_below_threshold.tile_safe = True  # generic row-tile fusion: masked mean
# the tape's plain walk runs K7's order (_cuda.generic_rows_plain)
mean_below_threshold.k7_plain = mean_below_threshold_k7
