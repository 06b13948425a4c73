"""Shared helpers for batched kernel implementations."""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "cdim",
    "isnan_any",
    "any_bad",
    "nanmask",
    "as_tensor",
    "per_row",
    "take_per_row",
    "static_float",
    "static_int",
]


def cdim(x, n: int = 1):
    """Append ``n`` trailing broadcast dims to a tensor; pass scalars through.

    Kernels receive scalar params shaped ``(*batch,)`` and array params shaped
    ``(*batch, core...)``; this aligns a scalar against an array operand.
    """
    if isinstance(x, torch.Tensor) and x.ndim > 0:
        return x[(...,) + (None,) * n]
    return x


def as_tensor(x, like: torch.Tensor, dtype=None) -> torch.Tensor:
    """``x`` (tensor, numpy value or python scalar) as a tensor on ``like``'s
    device, in ``dtype`` (default: ``x``'s own type, or ``like``'s for
    python scalars)."""
    if isinstance(x, torch.Tensor):
        t = x.to(like.device)
    elif isinstance(x, (np.ndarray, np.generic)):
        t = torch.from_numpy(np.array(x)).to(like.device)
    else:
        t = torch.tensor(x, dtype=like.dtype, device=like.device)
    return t if dtype is None else t.to(dtype)


def per_row(x, like: torch.Tensor) -> torch.Tensor:
    """A per-row parameter (a scalar, or a tensor of one value per row of
    ``like``) as a ``like.shape[:-1]`` tensor in ``like``'s type on its
    device. A scalar is filled in on the device, rounded there from float64
    as a host conversion rounds it: no host -> device copy, which would wait
    for the stream."""
    lead = like.shape[:-1]
    if isinstance(x, torch.Tensor):
        v = x.to(like.device, like.dtype)
        return v.expand(lead) if v.ndim == 0 else v
    return torch.full(lead, float(x), dtype=torch.float64,
                      device=like.device).to(like.dtype)


def isnan_any(x, core_ndim: int = 0):
    """NaN mask reduced over the trailing ``core_ndim`` axes.

    Python and numpy values give a python/numpy bool, so a constant argument
    short-circuits :func:`nanmask`.
    """
    if not isinstance(x, torch.Tensor):
        return np.isnan(x) if np.issubdtype(np.asarray(x).dtype, np.floating) else False
    if not x.is_floating_point():
        return torch.zeros(x.shape[: x.ndim - core_ndim], dtype=torch.bool,
                           device=x.device)
    m = torch.isnan(x)
    for _ in range(core_ndim):
        m = m.any(dim=-1)
    return m


def any_bad(*masks):
    """Elementwise OR of NaN masks that may be tensors or python/numpy
    bools (a constant ``False`` drops out, a constant ``True`` wins)."""
    out = False
    for m in masks:
        if isinstance(m, torch.Tensor):
            out = m if out is False else (
                torch.ones_like(m) if out is True else out | m
            )
        elif bool(m):
            out = True if not isinstance(out, torch.Tensor) else torch.ones_like(out)
    return out


def nanmask(bad, out: torch.Tensor) -> torch.Tensor:
    """Poison ``out`` with NaN where ``bad``; rank-matches from the left.

    ``bad`` may be a python/numpy bool (static short-circuit) or a
    batch-shaped tensor.
    """
    if isinstance(bad, (bool, np.bool_)):
        return torch.full_like(out, float("nan")) if bad else out
    m = bad
    while m.ndim < out.ndim:
        m = m[..., None]
    while m.ndim > out.ndim:
        m = m[..., 0]
    return torch.where(m, torch.full((), float("nan"), dtype=out.dtype,
                                     device=out.device), out)


def take_per_row(w: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-row pickoff ``w[..., idx[..., k]]`` along the last axis, with
    ``idx`` clipped into range (callers mask invalid entries themselves)."""
    n = w.shape[-1]
    idxc = idx.clamp(0, n - 1).long()
    lead = torch.broadcast_shapes(w.shape[:-1], idxc.shape[:-1])
    return torch.gather(
        w.expand(*lead, n), -1, idxc.expand(*lead, idxc.shape[-1])
    )


def static_float(x, name: str, what: str) -> float:
    from ._kernel import require_static

    require_static(x, name, what)
    return float(x)


def static_int(x, name: str, what: str) -> int:
    from ._kernel import require_static

    require_static(x, name, what)
    return int(x)
