"""Indexed gather processors (reference ``dspeed/processors/get.py:31,72``;
JAX package ``dspeed_tpu/processors/get.py``)."""

from __future__ import annotations

import torch

from ._kernel import kernel

__all__ = ["get", "get_default"]

_T = ["b", "h", "i", "l", "B", "H", "I", "L", "f", "d", "F", "D"]


def _pick(a_in, i):
    """``(a_in[..., i] with i < 0 from the end, in range)`` per row: the
    value (clipped index) and whether ``i`` was in range."""
    n = a_in.shape[-1]
    idx = torch.as_tensor(i, device=a_in.device).to(torch.int32)
    idx = idx.expand(a_in.shape[:-1]) if idx.ndim == 0 else idx
    wrapped = torch.where(idx < 0, idx + n, idx)
    ok = (idx >= -n) & (idx < n)
    lead = torch.broadcast_shapes(a_in.shape[:-1], wrapped.shape)
    val = torch.gather(a_in.expand(*lead, n), -1,
                       wrapped.clamp(0, n - 1).long().expand(lead)[..., None])[..., 0]
    return val, ok


def _fill(a_in):
    """NaN, or the integer type's largest value."""
    if a_in.is_floating_point() or a_in.is_complex():
        return float("nan")
    return torch.iinfo(a_in.dtype).max


@kernel("(n),()->()", [f"{t}l->{t}" for t in _T])
def get(a_in, i):
    """Value at position ``i`` (negative = from the end). Out of range
    gives NaN / the integer type's maximum (the reference raises
    ``DSPFatal``; the checked mode flags it)."""
    val, ok = _pick(a_in, i)
    return torch.where(ok, val, torch.full((), _fill(a_in), dtype=a_in.dtype,
                                           device=a_in.device))


def _get_checker(a_in, i):
    """Checked-mode flag: the reference raises ``DSPFatal("i is out of
    range")`` per event (``get.py:45-48``); a NaN index is left to the NaN
    convention."""
    n = a_in.shape[-1]
    idx = torch.as_tensor(i, device=a_in.device)
    bad = (idx < -n) | (idx >= n)
    if idx.is_floating_point():
        bad = bad & ~torch.isnan(idx)
    code = bad.to(torch.int32)
    return code.expand(torch.broadcast_shapes(code.shape, a_in.shape[:-1]))


get.checker = _get_checker
get.check_messages = {1: "i is out of range"}


@kernel("(n),(),()->()", [f"{t}l{t}->{t}" for t in _T])
def get_default(a_in, i, default):
    """Value at position ``i``; ``default`` where ``i`` is out of range or
    the value is NaN (reference ``get.py:72``). Backs the parser's
    ``wf[var]`` subscripts."""
    val, ok = _pick(a_in, i)
    if a_in.is_floating_point():
        ok = ok & ~torch.isnan(val)
    d = torch.as_tensor(default, device=a_in.device).to(a_in.dtype)
    return torch.where(ok, val, d)


# generic row-tile fusion (the JAX package's flags)
get.tile_safe = True
get_default.tile_safe = True
