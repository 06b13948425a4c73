"""Soft pile-up correction (reference ``dspeed/processors/soft_pileup_corr.py``;
JAX package ``dspeed_tpu/processors/soft_pileup_corr.py``).

The closed-form least-squares fit of ``A*exp(-i/tau) + B`` over the first
``n_in`` samples, subtracted from the whole waveform. The fit's sums are
masked reductions in ``config.accum_dtype`` (the JAX package sums them in
float64 under x64), and the correction is applied in that type and rounded
to the row's. K7's ``soft_pileup`` op computes the same on the card.
"""

from __future__ import annotations

import torch

from ..config import accum_dtype
from ..errors import DSPFatal
from ._helpers import any_bad, cdim, isnan_any, nanmask, static_int
from ._kernel import kernel
from ._numerics import k7_sum, true_div

__all__ = ["soft_pileup_corr", "soft_pileup_corr_bl"]


def exp_fit_sums(w_in, n_fit: int, tau):
    """``(e1, s1 .. s5)``: ``e1 = exp(-i/tau)`` over the row (``(n,)``, or
    ``(..., n)`` for a per-event tau) and the fit's sums over its first
    ``n_fit`` samples, ``s1 = n_fit``, ``s2 = sum e1``, ``s3 = sum e1**2``,
    ``s4 = sum e1 w``, ``s5 = sum w``, all in ``accum_dtype``."""
    acc = accum_dtype()
    n = w_in.shape[-1]
    i = torch.arange(n, dtype=acc, device=w_in.device)
    mask = (i < n_fit).to(acc)
    if isinstance(tau, torch.Tensor) and tau.ndim:
        e1 = torch.exp(-i / cdim(tau.to(acc), 1))
    else:
        e1 = torch.exp(-i / torch.as_tensor(tau, dtype=acc, device=w_in.device))
    w = w_in.to(acc)
    s1 = float(n_fit)
    s2 = (e1 * mask).sum(-1)
    s3 = (e1 * e1 * mask).sum(-1)
    s4 = (e1 * w * mask).sum(-1)
    s5 = (w * mask).sum(-1)
    return e1, s1, s2, s3, s4, s5


def fit_constants(n: int, n_fit: int, tau: float):
    """``(e1, s2, s3)`` of a constant ``tau``, made on the host as K7's
    ``soft_pileup`` op takes them: ``exp(-i/tau)`` over a row of ``n``
    samples (``(1, n)`` float64 on the CPU) and the fit's two sums over its
    first ``n_fit`` samples that depend on it alone, as floats."""
    e1, _, s2, s3, _, _ = exp_fit_sums(torch.zeros(1, n, dtype=torch.float64), n_fit, tau)
    return e1, float(s2), float(s3)


def soft_pileup_k7(w_in, n_in, tau_in, b_in=None, f64=False):
    """:func:`soft_pileup_corr` (or, with ``b_in``, :func:`soft_pileup_corr_bl`)
    as K7's two ops compute it (the tape's plain walk): ``(A, B, out)``, the
    fit's coefficients per row (the ``soft_pileup`` op's) and the row less
    the fit (``soft_pileup_out``'s). On a float row the member's own fit
    (:func:`soft_pileup_fit`) and body. With ``f64`` (a float64 program's
    row) as K7's float64 ops take them: ``exp(-i/tau)``, ``s2`` and ``s3``
    from :func:`fit_constants`, ``s4`` and ``s5`` in K7's block order
    (:func:`._numerics.k7_sum`) over the first ``n_in`` samples (NaN where a
    sample past them is not finite, as the member's masked sums give),
    every quotient a true division, the correction in float64."""
    if not f64:
        a, b = soft_pileup_fit(w_in, n_in, tau_in, b_in)
        if b_in is None:
            return a, b, soft_pileup_corr(w_in, n_in, tau_in)[0]
        return a, b, soft_pileup_corr_bl(w_in, n_in, tau_in, b_in)[0]
    nf = check_n(n_in, w_in.shape[-1], "soft_pileup_corr")
    e1, s2, s3 = fit_constants(w_in.shape[-1], nf, float(tau_in))
    e1 = e1.to(w_in.device)
    w = w_in[..., :nf].to(torch.float64)
    tail = (w_in[..., nf:] * 0.0).sum(-1).to(torch.float64)  # 0, or NaN
    s4 = k7_sum(e1[..., :nf] * w) + tail
    s5 = k7_sum(w) + tail
    s1 = float(nf)
    if b_in is None:
        b = true_div(s5 - true_div(s2 * (s4 * s1 - s2 * s5), s3 * s1 - s2 * s2), s1)
    elif isinstance(b_in, torch.Tensor):
        b = b_in.to(w.device, torch.float64).expand(s4.shape)
    else:
        b = torch.full_like(s4, float(b_in))
    a = true_div(s4 - b * s2, s3)
    out = w_in.to(torch.float64) - (a[..., None] * e1 + b[..., None])
    bad = any_bad(isnan_any(w_in, 1), torch.isnan(a), torch.isnan(b))
    return a, b, nanmask(bad, out.to(w_in.dtype))


def check_n(n_in, n, name) -> int:
    """The fit's sample count, static and inside ``[2, n]``; raises
    ``DSPFatal`` as the reference does."""
    nf = static_int(n_in, name, "n_in")
    if nf < 2:
        raise DSPFatal("The number of samples is not enough for a fit")
    if nf > n:
        raise DSPFatal("The number of samples is more than the waveform length")
    return nf


def _tau_bad(tau):
    return isnan_any(tau) if isinstance(tau, torch.Tensor) else isnan_any(float(tau))


def _fit(w_in, n_in, tau_in, b_in, name):
    """``(A, B, e1)``: the fit's coefficients per row in ``accum_dtype``
    (``B`` solved for, or ``b_in``) and ``exp(-i/tau)``."""
    nf = check_n(n_in, w_in.shape[-1], name)
    e1, s1, s2, s3, s4, s5 = exp_fit_sums(w_in, nf, tau_in)
    if b_in is None:
        b = (s5 - s2 * (s4 * s1 - s2 * s5) / (s3 * s1 - s2 * s2)) / s1
    elif isinstance(b_in, torch.Tensor):
        b = b_in.to(w_in.device, s4.dtype).expand(s4.shape)
    else:
        b = torch.full_like(s4, float(b_in))
    return (s4 - b * s2) / s3, b, e1


def soft_pileup_fit(w_in, n_in, tau_in, b_in=None):
    """``(A, B)`` of :func:`soft_pileup_corr` (or, with ``b_in``,
    :func:`soft_pileup_corr_bl`) per row, in ``accum_dtype``: what K7's
    ``soft_pileup`` op computes on the card before its ``soft_pileup_out``
    op subtracts the fit."""
    return _fit(w_in, n_in, tau_in, b_in, "soft_pileup_corr")[:2]


def _corrected(w_in, n_in, tau_in, b_in, name):
    """The row less the fit, in ``accum_dtype``, rounded to the row's type."""
    a, b, e1 = _fit(w_in, n_in, tau_in, b_in, name)
    return (w_in.to(e1.dtype) - (cdim(a) * e1 + cdim(b))).to(w_in.dtype)


@kernel("(n),(),()->(n)", ["fff->f", "ddd->d"])
def soft_pileup_corr(w_in, n_in, tau_in):
    """Fit ``A*exp(-i/tau) + B`` to the first ``n_in`` samples and subtract
    it from the waveform (reference ``soft_pileup_corr.py:20``)."""
    out = _corrected(w_in, n_in, tau_in, None, "soft_pileup_corr")
    return nanmask(any_bad(isnan_any(w_in, 1), _tau_bad(tau_in)), out)


@kernel("(n),(),(),()->(n)", ["ffff->f", "dddd->d"])
def soft_pileup_corr_bl(w_in, n_in, tau_in, b_in):
    """The same with a fixed baseline ``b_in`` (reference
    ``soft_pileup_corr.py:91``)."""
    out = _corrected(w_in, n_in, tau_in, b_in, "soft_pileup_corr_bl")
    bad = any_bad(isnan_any(w_in, 1), _tau_bad(tau_in), _tau_bad(b_in))
    return nanmask(bad, out)


# generic row-tile fusion (the JAX package's flags)
soft_pileup_corr.tile_safe = True
soft_pileup_corr_bl.tile_safe = True
# the tape's plain walk runs K7's two ops (_cuda.generic_rows_plain)
soft_pileup_corr.k7_plain = soft_pileup_corr_bl.k7_plain = soft_pileup_k7
