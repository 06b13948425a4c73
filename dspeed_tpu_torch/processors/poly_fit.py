"""Polynomial fits (reference ``dspeed/processors/poly_fit.py``; JAX package
``dspeed_tpu/processors/poly_fit.py``).

``poly_fit`` is a factory: the inverse of the normal-equation matrix is
computed on the host once per configuration, in float64; at run time the fit
is one product of the rows with a Vandermonde matrix (``torch.matmul``, as
the JAX package leaves its einsum to XLA) and a small matrix-vector product.
Both products run in ``config.accum_dtype`` (float64, so no TF32 on the
card), and the coefficients are rounded to the row's type once. The JAX
package sums a float32 row's moments in float32, which the normal
equations' cancellation amplifies to ~1e-5 of the coefficients' scale; the
port's float32 fit is within a float32 rounding of the float64 fit.

``poly_diff`` and ``poly_exp_rms`` evaluate the polynomial on the row as the
JAX package's einsum does (``p0`` then a fused multiply-add of each higher
term ``i**k * p_k``, in the row's type; its exponential in float64, rounded
to the row's type) and reduce the residual: its "mean"
is the reference's ``sum(resid[i] / (i + 1))``, and both rms values divide
by ``n - 1``. The products are rounded to the row's type and summed in
``config.accum_dtype``, then rounded once, as K7's ``poly_residual`` op
does on the card.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import accum_dtype
from ._helpers import any_bad, isnan_any, nanmask
from ._kernel import Kernel, kernel
from ._numerics import k7_sum, true_div

__all__ = ["poly_fit", "poly_diff", "poly_exp_rms"]


def poly_fit(length, deg) -> Kernel:
    """Fit the first ``length`` samples to a degree-``deg`` polynomial;
    returns its ``deg + 1`` coefficients, lowest order first."""
    length = int(length)
    deg = int(deg)
    i = np.arange(length, dtype="float64")
    vals = np.array([np.sum(i**j) for j in range(2 * deg + 1)])
    mat = np.stack([vals[j : deg + 1 + j] for j in range(deg + 1)])
    inv = np.linalg.inv(mat)
    vander = np.stack([i**j for j in range(deg + 1)], axis=-1)  # (n, m)

    def fn(w_in):
        acc, dev = accum_dtype(), w_in.device
        mom = torch.matmul(w_in.to(acc), torch.as_tensor(vander, dtype=acc, device=dev))
        pars = torch.matmul(mom, torch.as_tensor(inv.T, dtype=acc, device=dev))
        return nanmask(isnan_any(w_in, 1), pars.to(w_in.dtype))

    return Kernel(fn, "(n)->(m)", ["f->f", "d->d"], name="poly_fitter")


def poly_eval(pars, n):
    """The polynomial of ``pars`` (``(..., m)``, lowest order first) at the
    samples ``0 .. n-1`` in ``pars``' type: ``p0``, then ``i**k * p_k +
    out`` for k = 1, 2, ... as one fused multiply-add (``i**k`` by repeated
    products in the row's type). A float32 row's FMA is taken in float64:
    the product is exact there, so only the sum rounds, twice (once to
    float64), which moves a result only off a float32 tie."""
    dt = pars.dtype
    wide = torch.float64
    i = torch.arange(n, dtype=dt, device=pars.device)
    out = pars[..., :1].expand(*pars.shape[:-1], n)
    ik = torch.ones_like(i)
    for k in range(1, pars.shape[-1]):
        ik = ik * i
        out = (ik.to(wide) * pars[..., k : k + 1].to(wide) + out.to(wide)).to(dt)
    return out


def residual_stats(w_in, poly_pars, exp: bool, f64: bool = False):
    """``(mean, rms)`` of ``w - p`` (``p`` the polynomial of ``poly_pars``,
    or its exponential): ``mean = sum(resid[i] / (i + 1))`` and ``rms =
    sqrt(sum(resid**2) / (n - 1))``, summed in ``accum_dtype`` and rounded
    to the row's type; NaN where the row or the parameters hold a NaN. The
    tape's plain walk takes it as K7's op (K7's float op equals it); with
    ``f64`` (a float64 program's row) the sums in K7's block order
    (:func:`._numerics.k7_sum`) and the quotient a true division, as K7's
    float64 op takes them."""
    n = w_in.shape[-1]
    pars = poly_pars.to(w_in.dtype) if isinstance(poly_pars, torch.Tensor) else (
        torch.as_tensor(np.asarray(poly_pars), dtype=w_in.dtype, device=w_in.device))
    p = poly_eval(pars, n)
    if exp:
        # in float64, rounded once: the card's and the CPU's float32 exp
        # round differently, and the residual cancels the curve
        p = torch.exp(p.to(torch.float64)).to(p.dtype)
    acc = accum_dtype()
    resid = w_in - p
    harm = 1.0 / torch.arange(1, n + 1, dtype=w_in.dtype, device=w_in.device)
    if f64:
        mean = k7_sum(resid * harm).to(w_in.dtype)
        rms = torch.sqrt(true_div(k7_sum(resid * resid), float(n - 1))).to(w_in.dtype)
    else:
        mean = (resid * harm).to(acc).sum(-1).to(w_in.dtype)
        rms = torch.sqrt((resid * resid).to(acc).sum(-1) / (n - 1)).to(w_in.dtype)
    bad = any_bad(isnan_any(w_in, 1), isnan_any(pars, 1))
    return nanmask(bad, mean), nanmask(bad, rms)


@kernel("(n),(m)->(),()", ["ff->ff", "dd->dd"])
def poly_diff(w_in, poly_pars):
    """Mean and rms of the residual against a polynomial (reference
    ``poly_fit.py:82``)."""
    return residual_stats(w_in, poly_pars, exp=False)


@kernel("(n),(m)->(),()", ["ff->ff", "dd->dd"])
def poly_exp_rms(w_in, poly_pars):
    """Mean and rms of the residual against the exponential of a polynomial
    (reference ``poly_fit.py:119``)."""
    return residual_stats(w_in, poly_pars, exp=True)


# generic row-tile fusion (the JAX package's flags)
poly_diff.tile_safe = True
poly_exp_rms.tile_safe = True
# the tape's plain walk runs K7's order (_cuda.generic_rows_plain)
poly_diff.k7_plain = functools.partial(residual_stats, exp=False)
poly_exp_rms.k7_plain = functools.partial(residual_stats, exp=True)
