"""Elementwise conditional select (reference ``dspeed/processors/where.py:21``)."""

from __future__ import annotations

import torch

from ._kernel import kernel

__all__ = ["where"]

_T = ["B", "H", "I", "L", "b", "h", "i", "l", "f", "d"]


@kernel("(),(),()->()", [f"?{t}{t}->{t}" for t in _T])
def where(condition, a, b):
    """Return ``a`` where ``condition`` else ``b``; backs the parser's
    ``where()`` builtin and ``a if b else c`` ternary."""
    return torch.where(condition, a, b)


# generic row-tile fusion (the JAX package's flags)
where.tile_safe = True
