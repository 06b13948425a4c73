"""Round/floor/ceil/trunc to a multiple
(reference ``dspeed/processors/round_to_nearest.py:18-162``)."""

from __future__ import annotations

import torch

from ._helpers import as_tensor
from ._kernel import kernel

__all__ = [
    "round_to_nearest",
    "floor_to_nearest",
    "ceil_to_nearest",
    "trunc_to_nearest",
]

_T = ["B", "H", "I", "L", "b", "h", "i", "l", "f", "d"]
_TYPES = [f"{t}{t}->{t}" for t in _T]


def _apply(val, to_nearest, fn):
    t = as_tensor(to_nearest, val, val.dtype)
    out = (t * fn(val / t)).to(val.dtype)
    if val.is_floating_point():
        out = torch.where(torch.isnan(val), float("nan"), out)
    return out


@kernel("(),()->()", _TYPES)
def round_to_nearest(val, to_nearest):
    """Nearest multiple of ``to_nearest`` (round half to even, like
    ``np.rint``)."""
    return _apply(val, to_nearest, torch.round)


@kernel("(),()->()", _TYPES)
def floor_to_nearest(val, to_nearest):
    """Largest multiple of ``to_nearest`` that is <= val."""
    return _apply(val, to_nearest, torch.floor)


@kernel("(),()->()", _TYPES)
def ceil_to_nearest(val, to_nearest):
    """Smallest multiple of ``to_nearest`` that is >= val."""
    return _apply(val, to_nearest, torch.ceil)


@kernel("(),()->()", _TYPES)
def trunc_to_nearest(val, to_nearest):
    """Multiple of ``to_nearest`` closest to val, towards zero."""
    return _apply(val, to_nearest, torch.trunc)


# generic row-tile fusion (the JAX package's flags)
round_to_nearest.tile_safe = True
floor_to_nearest.tile_safe = True
ceil_to_nearest.tile_safe = True
trunc_to_nearest.tile_safe = True
