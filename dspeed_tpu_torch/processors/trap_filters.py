"""Trapezoidal filters.

Reference semantics: ``dspeed/processors/trap_filters.py`` — four-phase
running-sum recursions (:20 ``trap_filter``, :87 ``trap_norm``,
:160 ``asym_trap_filter``).

The recursions telescope exactly into differences of one inclusive prefix
sum ``S`` (with ``S[k<0] = 0``):

    ``trap[i] = S[i] - S[i-rise] - S[i-rise-flat] + S[i-2*rise-flat]``

evaluated at accumulation precision (float64), as in the JAX
package (``dspeed_tpu/processors/trap_filters.py``).
"""

from __future__ import annotations

import torch

from ..errors import DSPFatal
from ._helpers import isnan_any, nanmask, static_int
from ._kernel import kernel
from ._numerics import hp_cumsum, shift_right

__all__ = ["trap_filter", "trap_norm", "asym_trap_filter"]


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


def _trap_sum(w_in, rise: int, flat: int, fall: int) -> torch.Tensor:
    """``S[i]-S[i-rise] - (S[i-rise-flat]-S[i-rise-flat-fall])``."""
    ps = hp_cumsum(w_in)
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


# generic row-tile fusion (the JAX package's flags)
trap_filter.tile_safe = True
trap_norm.tile_safe = True
asym_trap_filter.tile_safe = True
