"""Linear baseline fits (reference ``dspeed/processors/linear_slope_fit.py``).

The reference runs Welford's method plus accumulated regression sums per
sample (:19 ``linear_slope_fit``). Closed-form moments are mathematically
identical; the index sums are evaluated exactly on the host and the data sums
at accumulation precision (float64), as in the JAX package under x64.
"""

from __future__ import annotations

import torch

from .. import config
from ._helpers import isnan_any, nanmask
from ._kernel import kernel

__all__ = ["linear_slope_fit"]


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


# generic row-tile fusion (the JAX package's flags)
linear_slope_fit.tile_safe = True
