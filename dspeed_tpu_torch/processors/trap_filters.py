"""Trapezoidal filters.

Reference semantics: ``dspeed/processors/trap_filters.py`` — four-phase
running-sum recursions (:20 ``trap_filter``, :87 ``trap_norm``,
:160 ``asym_trap_filter``) and the trapezoid at one pick-off index
(:238 ``trap_pickoff``).

The recursions telescope exactly into differences of one inclusive prefix
sum ``S`` (with ``S[k<0] = 0``):

    ``trap[i] = S[i] - S[i-rise] - S[i-rise-flat] + S[i-2*rise-flat]``

evaluated at accumulation precision (float64), as in the JAX
package (``dspeed_tpu/processors/trap_filters.py``).
"""

from __future__ import annotations

import torch

from ..errors import DSPFatal
from ._helpers import any_bad, isnan_any, nanmask, static_int
from ._kernel import kernel
from ._numerics import hp_cumsum, k7_prefix, shift_right, true_div

__all__ = ["trap_filter", "trap_norm", "asym_trap_filter", "trap_pickoff"]


def _check(name: str, **sections) -> dict[str, int]:
    out = {}
    for key, val in sections.items():
        iv = static_int(val, name, key)
        if iv < 0:
            raise DSPFatal(
                f"The number of samples in the {key} section must be positive"
            )
        out[key] = iv
    return out


def _trap_sum(w_in, rise: int, flat: int, fall: int, prefix=hp_cumsum) -> torch.Tensor:
    """``S[i]-S[i-rise] - (S[i-rise-flat]-S[i-rise-flat-fall])``, ``S`` the
    inclusive prefix ``prefix(w_in)``."""
    ps = prefix(w_in)
    d1 = ps - shift_right(ps, rise) if rise else torch.zeros_like(ps)
    d2 = (
        shift_right(ps, rise + flat) - shift_right(ps, rise + flat + fall)
        if fall
        else torch.zeros_like(ps)
    )
    return d1 - d2


@kernel(
    "(n),(),()->(n)", ["fii->f", "dii->d"], badrow_arg=0, mask_preserving=True
)
def trap_filter(w_in, rise, flat, badrow=None):
    """Symmetric trapezoidal filter (reference ``trap_filters.py:20``)."""
    n = w_in.shape[-1]
    p = _check("trap_filter", rise=rise, flat=flat)
    if 2 * p["rise"] + p["flat"] > n:
        raise DSPFatal("The trapezoid width is wider than the waveform")
    out = _trap_sum(w_in, p["rise"], p["flat"], p["rise"]).to(w_in.dtype)
    return nanmask(isnan_any(w_in, 1) if badrow is None else badrow, out)


def trap_filter_k7(w_in, rise, flat, f64=False):
    """:func:`trap_filter` as K7's ``trap`` op computes it (the tape's plain
    walk): from the float64 prefix in K7's order (:func:`._numerics.k7_prefix`),
    on a float or (``f64``) a float64 program's row alike."""
    p = _check("trap_filter", rise=rise, flat=flat)
    out = _trap_sum(w_in, p["rise"], p["flat"], p["rise"], k7_prefix).to(w_in.dtype)
    return nanmask(isnan_any(w_in, 1), out)


@kernel(
    "(n),(),()->(n)", ["fii->f", "dii->d"], badrow_arg=0, mask_preserving=True
)
def trap_norm(w_in, rise, flat, badrow=None):
    """Symmetric trapezoid normalized by ``rise`` (reference ``trap_filters.py:87``)."""
    n = w_in.shape[-1]
    p = _check("trap_norm", rise=rise, flat=flat)
    if 2 * p["rise"] + p["flat"] > n:
        raise DSPFatal("The trapezoid width is wider than the waveform")
    acc = _trap_sum(w_in, p["rise"], p["flat"], p["rise"])
    out = (acc / p["rise"]).to(w_in.dtype)
    return nanmask(isnan_any(w_in, 1) if badrow is None else badrow, out)


def trap_norm_k7(w_in, rise, flat, f64=False):
    """:func:`trap_norm` as K7's ``trap`` op computes it (the tape's plain
    walk): the member's own body, which K7's float op equals; with ``f64``
    (a float64 program's row) every window a difference of the float64
    prefix in K7's order, divided by ``rise`` in float64, as K7's float64
    op takes it."""
    if not f64:
        return trap_norm(w_in, rise, flat)
    p = _check("trap_norm", rise=rise, flat=flat)
    acc = _trap_sum(w_in, p["rise"], p["flat"], p["rise"], k7_prefix)
    return nanmask(isnan_any(w_in, 1), true_div(acc, float(p["rise"])).to(w_in.dtype))


@kernel(
    "(n),(),(),()->(n)", ["fiii->f", "diii->d"], badrow_arg=0,
    mask_preserving=True,
)
def asym_trap_filter(w_in, rise, flat, fall, badrow=None):
    """Asymmetric trapezoid normalized per section (reference ``trap_filters.py:160``).

    ``out[i] = avg(rise window ending at i) - avg(fall window ending at
    i-rise-flat)`` with each window normalized by its own length.
    """
    n = w_in.shape[-1]
    p = _check("asym_trap_filter", rise=rise, flat=flat, fall=fall)
    if p["rise"] + p["flat"] + p["fall"] > n:
        raise DSPFatal("The trapezoid width is wider than the waveform")
    ps = hp_cumsum(w_in)
    d1 = ps - shift_right(ps, p["rise"])
    d2 = shift_right(ps, p["rise"] + p["flat"]) - shift_right(
        ps, p["rise"] + p["flat"] + p["fall"]
    )
    out = d1 / p["rise"] - d2 / p["fall"]
    return nanmask(
        isnan_any(w_in, 1) if badrow is None else badrow, out.to(w_in.dtype)
    )


def asym_trap_filter_k7(w_in, rise, flat, fall, f64=False):
    """:func:`asym_trap_filter` as K7's ``trap`` op computes it, as
    :func:`trap_norm_k7`: with ``f64`` each window a difference of the
    float64 prefix in K7's order, divided by its length in float64."""
    if not f64:
        return asym_trap_filter(w_in, rise, flat, fall)
    p = _check("asym_trap_filter", rise=rise, flat=flat, fall=fall)
    ps = k7_prefix(w_in)
    d1 = ps - shift_right(ps, p["rise"])
    d2 = shift_right(ps, p["rise"] + p["flat"]) - shift_right(
        ps, p["rise"] + p["flat"] + p["fall"])
    out = true_div(d1, float(p["rise"])) - true_div(d2, float(p["fall"]))
    return nanmask(isnan_any(w_in, 1), out.to(w_in.dtype))


@kernel("(n),(),(),()->()", ["fiif->f", "diid->d"])
def trap_pickoff(w_in, rise, flat, t_pickoff):
    """Trapezoid evaluated at one pick-off index (reference
    ``trap_filters.py:238``; JAX package ``trap_filters.py:108``):
    ``(sum w[t+1-rise : t+1] - sum w[t+1-2*rise-flat : t+1-rise-flat]) /
    rise`` with ``t = int(t_pickoff)``, from the float64 prefix; NaN where
    the window does not fit or ``t_pickoff`` is not an integer.
    """
    return _pickoff(w_in, rise, flat, t_pickoff, hp_cumsum)


def trap_pickoff_k7(w_in, rise, flat, t_pickoff, f64=False):
    """:func:`trap_pickoff` as K7's op computes it (the tape's plain walk):
    from the float64 prefix in K7's order (:func:`._numerics.k7_prefix`), on
    a float or (``f64``) a float64 program's row alike."""
    return _pickoff(w_in, rise, flat, t_pickoff, k7_prefix)


def _pickoff(w_in, rise, flat, t_pickoff, prefix):
    """``trap_pickoff`` from the inclusive prefix ``prefix(w_in)``."""
    n = w_in.shape[-1]
    p = _check("trap_pickoff", rise=rise, flat=flat)
    if 2 * p["rise"] + p["flat"] > n:
        raise DSPFatal("The trapezoid width is wider than the waveform")
    t = torch.as_tensor(t_pickoff, device=w_in.device)
    t = t.expand(w_in.shape[:-1]) if t.ndim == 0 else t
    start = torch.trunc(t).to(torch.int64) + 1
    ps = prefix(w_in)

    def s_at(k):
        # the inclusive prefix S[k], S[k < 0] = 0
        v = torch.gather(ps, -1, k.clamp(0, n - 1)[..., None])[..., 0]
        return torch.where(k < 0, torch.zeros_like(v), v)

    def win_sum(hi_idx, length):
        # the sum of w[hi_idx-length : hi_idx]
        return s_at(hi_idx - 1) - s_at(hi_idx - length - 1)

    i1 = win_sum(start, p["rise"])
    i2 = win_sum(start - p["rise"] - p["flat"], p["rise"])
    # a true division on the card too (a python scalar there divides as a
    # product with its rounded reciprocal)
    val = true_div(i1 - i2, float(p["rise"])).to(w_in.dtype)
    in_range = (start >= 2 * p["rise"] + p["flat"]) & (start <= n)
    non_integer = torch.floor(t) != t
    bad = any_bad(isnan_any(w_in, 1), isnan_any(t), ~in_range, non_integer)
    return nanmask(bad, val)


def _trap_pickoff_checker(w_in, rise, flat, t_pickoff):
    """Checked-mode flag: the reference raises on a non-integral pick-off
    index (``trap_filters.py:276-277``); NaN inputs give NaN."""
    t = torch.as_tensor(t_pickoff, device=w_in.device)
    lead = torch.broadcast_shapes(t.shape, w_in.shape[:-1])
    if not t.is_floating_point():
        return torch.zeros(lead, dtype=torch.int32, device=w_in.device)
    code = ~isnan_any(w_in, 1) & ~torch.isnan(t) & (torch.floor(t) != t)
    return code.to(torch.int32).expand(lead)


trap_pickoff.checker = _trap_pickoff_checker
trap_pickoff.check_messages = {1: "The pick-off index must be an integer"}

# generic row-tile fusion (the JAX package's flags)
trap_pickoff.tile_safe = True
# the tape's plain walk runs K7's order (_cuda.generic_rows_plain)
trap_pickoff.k7_plain = trap_pickoff_k7
trap_filter.k7_plain = trap_filter_k7
trap_norm.k7_plain = trap_norm_k7
asym_trap_filter.k7_plain = asym_trap_filter_k7
trap_filter.tile_safe = True
trap_norm.tile_safe = True
asym_trap_filter.tile_safe = True
