"""Baseline subtraction (reference: ``dspeed/processors/bl_subtract.py:16``)."""

from __future__ import annotations

from ._helpers import any_bad, cdim, isnan_any, nanmask
from ._kernel import kernel

__all__ = ["bl_subtract"]


@kernel(
    "(n),()->(n)", ["ff->f", "dd->d"], badrow_arg=0, mask_preserving=True
)
def bl_subtract(w_in, a_baseline, badrow=None):
    """Subtract a constant baseline from the entire waveform.

    NaN convention: any NaN in the waveform or baseline poisons the event.
    """
    out = w_in - cdim(a_baseline)
    row = isnan_any(w_in, 1) if badrow is None else badrow
    return nanmask(any_bad(row, isnan_any(a_baseline)), out)

# generic row-tile fusion (the JAX package's flags, so that both packages
# form the same groups)
bl_subtract.tile_safe = True
