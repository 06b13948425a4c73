"""Coordinate-grid / unit conversions
(reference ``dspeed/processors/unit_conversion.py:20-78``).

All convert ``(x + offset_in) * period_ratio - offset_out`` with float64
offset/ratio arithmetic, in float, int (exactness-checked), or rounded
variants. The chain's ``ConvertStep`` emits these.
"""

from __future__ import annotations

import torch

from ._kernel import kernel

__all__ = [
    "convert",
    "convert_int",
    "convert_round",
    "convert_floor",
    "convert_ceil",
    "convert_trunc",
]

_FT = ["f", "d"]
_IT = ["B", "H", "I", "L", "b", "h", "i", "l"]


def _affine_simple(buf, offset_in, offset_out, ratio):
    """(buf + offset_in) * ratio - offset_out in float64."""
    x = buf.to(torch.float64)

    def align(v):
        if isinstance(v, torch.Tensor):
            v = v.to(torch.float64)
            while v.ndim and v.ndim < x.ndim:
                v = v[..., None]
            return v
        return float(v)

    return (x + align(offset_in)) * align(ratio) - align(offset_out)


@kernel("(),(),(),()->()", [f"{t}ddd->{t}" for t in _FT])
def convert(buf_in, offset_in, offset_out, period_ratio):
    out = _affine_simple(buf_in, offset_in, offset_out, period_ratio)
    return out.to(buf_in.dtype)


@kernel("(),(),(),()->()", [f"{t}ddd->{t}" for t in _IT])
def convert_int(buf_in, offset_in, offset_out, period_ratio):
    """Integer conversion; non-exact results are poisoned to the max value of
    the dtype (the reference raises ``DSPFatal`` per element)."""
    dtype = buf_in.dtype
    tmp = _affine_simple(buf_in, offset_in, offset_out, period_ratio)
    ret = torch.round(tmp)
    exact = (tmp - ret).abs() < 1.0e-5
    return torch.where(exact, ret.to(dtype), torch.iinfo(dtype).max)


def _conv_round(fn, name):
    def impl(buf_in, offset_in, offset_out, period_ratio):
        out = fn(_affine_simple(buf_in, offset_in, offset_out, period_ratio))
        return out.to(buf_in.dtype)

    return kernel(
        "(),(),(),()->()", [f"{t}ddd->{t}" for t in _IT + _FT], name=name
    )(impl)


convert_round = _conv_round(torch.round, "convert_round")
convert_floor = _conv_round(torch.floor, "convert_floor")
convert_ceil = _conv_round(torch.ceil, "convert_ceil")
convert_trunc = _conv_round(torch.trunc, "convert_trunc")
