"""Linear baseline fits (reference ``dspeed/processors/linear_slope_fit.py``).

The reference runs Welford's method plus accumulated regression sums per
sample (:19 ``linear_slope_fit``, :101 ``linear_slope_diff``). Closed-form moments are mathematically
identical; the index sums are evaluated exactly on the host and the data sums
at accumulation precision (float64), as in the JAX package under x64.
"""

from __future__ import annotations

import torch

from .. import config
from ._helpers import any_bad, as_tensor, cdim, isnan_any, nanmask
from ._kernel import kernel
from ._numerics import k7_sum, true_div

__all__ = ["linear_slope_fit", "linear_slope_diff"]


@kernel(
    "(n)->(),(),(),()", ["f->ffff", "d->dddd"],
    badrow_arg=0, mask_preserving=True,
)
def linear_slope_fit(w_in, badrow=None):
    """Mean, sample stdev, regression slope and intercept over the window.

    Outputs ``(mean, stdev, slope, intercept)``; reference
    ``linear_slope_fit.py:19``.
    """
    n = w_in.shape[-1]
    acc = config.accum_dtype()
    wacc = w_in.to(acc)
    i = torch.arange(n, dtype=acc, device=w_in.device)
    sum_y = wacc.sum(dim=-1)
    sum_xy = (wacc * i).sum(dim=-1)
    mean = sum_y / n
    # sample variance (ddof=1), matching Welford's accumulation
    var = (
        ((wacc - mean[..., None]) ** 2).sum(dim=-1) / (n - 1)
        if n > 1
        else torch.zeros_like(mean)
    )
    stdev = torch.sqrt(var)
    sum_x = n * (n - 1) / 2.0
    sum_x2 = (n - 1) * n * (2 * n - 1) / 6.0
    slope = (n * sum_xy - sum_x * sum_y) / (n * sum_x2 - sum_x * sum_x)
    intercept = (sum_y - sum_x * slope) / n
    dtype = w_in.dtype
    bad = isnan_any(w_in, 1) if badrow is None else badrow
    return (
        nanmask(bad, mean.to(dtype)),
        nanmask(bad, stdev.to(dtype)),
        nanmask(bad, slope.to(dtype)),
        nanmask(bad, intercept.to(dtype)),
    )


def linear_slope_fit_k7(w_in, f64=False):
    """:func:`linear_slope_fit` as K7's op computes it (the tape's plain
    walk): the member's own body, which K7's float op equals; with ``f64``
    (a float64 program's row) its sums in K7's block order
    (:func:`._numerics.k7_sum`) and every quotient a true division in
    float64, as K7's float64 op takes them."""
    if not f64:
        return linear_slope_fit(w_in)
    n = w_in.shape[-1]
    x = w_in.to(torch.float64)
    i = torch.arange(n, dtype=torch.float64, device=w_in.device)
    sum_y = k7_sum(x)
    sum_xy = k7_sum(x * i)
    mean = true_div(sum_y, float(n))
    d = x - mean[..., None]
    var = true_div(k7_sum(d * d), float(n - 1)) if n > 1 else torch.zeros_like(mean)
    sum_x = n * (n - 1) / 2.0
    sum_x2 = (n - 1) * n * (2 * n - 1) / 6.0
    slope = true_div(n * sum_xy - sum_x * sum_y, n * sum_x2 - sum_x * sum_x)
    intercept = true_div(sum_y - sum_x * slope, float(n))
    bad = isnan_any(w_in, 1)
    return tuple(nanmask(bad, v.to(w_in.dtype))
                 for v in (mean, torch.sqrt(var), slope, intercept))


@kernel("(n),(),()->(),()", ["fff->ff", "ddd->dd"])
def linear_slope_diff(w_in, slope, intercept):
    """Mean and rms residual after removing a given line (reference
    ``linear_slope_fit.py:101``). The reference's "mean" accumulates
    ``resid[i] / (i + 1)``, a harmonic-weighted sum, and that weighting is
    kept, as in the JAX package."""
    return _slope_diff(w_in, slope, intercept, lambda v: v.sum(dim=-1))


def linear_slope_diff_k7(w_in, slope, intercept, f64=False):
    """:func:`linear_slope_diff` as K7's op computes it (the tape's plain
    walk): its two sums in K7's block order (:func:`._numerics.k7_sum`), in
    float64 on a float or (``f64``) a float64 program's row alike."""
    return _slope_diff(w_in, slope, intercept, k7_sum)


def _slope_diff(w_in, slope, intercept, total):
    """``linear_slope_diff`` with ``total`` summing over the last axis: the
    residual in the accumulation type, each product and sum rounded once."""
    n = w_in.shape[-1]
    acc = config.accum_dtype()
    i = torch.arange(n, dtype=acc, device=w_in.device)
    resid = w_in.to(acc) - (cdim(as_tensor(slope, w_in, acc)) * i
                            + cdim(as_tensor(intercept, w_in, acc)))
    mean = total(resid * (1.0 / (i + 1.0)))
    # a true division on the card too (see _numerics.true_div)
    rms = (torch.sqrt(true_div(total(resid * resid), float(n - 1))) if n > 1
           else torch.zeros_like(mean))
    dtype = w_in.dtype
    bad = any_bad(isnan_any(w_in, 1), isnan_any(slope), isnan_any(intercept))
    return nanmask(bad, mean.to(dtype)), nanmask(bad, rms.to(dtype))


# generic row-tile fusion (the JAX package's flags)
linear_slope_fit.tile_safe = True
linear_slope_diff.tile_safe = True
# the tape's plain walk runs K7's order (_cuda.generic_rows_plain)
linear_slope_diff.k7_plain = linear_slope_diff_k7
linear_slope_fit.k7_plain = linear_slope_fit_k7
