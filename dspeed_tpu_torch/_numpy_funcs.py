"""The numpy functions a ``module: numpy`` processor may name, on tensors,
with numpy's positional signature and numpy's results.

The JAX package swaps a numpy function for its ``jax.numpy`` namesake, which
keeps numpy's signature (``dspeed_tpu/processing_chain.py:490-508``). Torch's
namesakes do not all do so: ``torch.median`` takes the lower of the two
middle values of an even count and returns indices too, ``torch.sort``
returns indices, ``torch.round`` and ``torch.flip`` take their second
argument by keyword or as a tuple, and ``torch.cumsum`` has no positional
``dtype``. So every function here is written against numpy's signature, and
a numpy function with no entry in :data:`NUMPY_FUNCS` raises when the chain
is built; no torch namesake is taken on trust.

:data:`REDUCTIONS` are the names whose ``axis`` counts from the chain's
``(block, core...)`` buffer layout and is remapped to a core-relative axis,
as in the JAX package (``dspeed_tpu/processing_chain.py:392-395``); the
chain hands them an int ``axis``. The others take ``axis`` as given.
"""

from __future__ import annotations

import numpy as np
import torch

from .errors import ProcessingChainError

__all__ = ["K7_SUMS", "NUMPY_FUNCS", "REDUCTIONS", "k7_reduce"]

REDUCTIONS = frozenset(
    "amax amin max min sum mean std var prod median argmax argmin "
    "nanmax nanmin nansum nanmean nanstd nanargmax nanargmin "
    "cumsum cumprod nancumsum nancumprod".split()
)


def _no_out(out, name: str) -> None:
    if out is not None:
        raise ProcessingChainError(f"numpy.{name}: out= is not supported")


def _cast(a: torch.Tensor, dtype) -> torch.Tensor:
    if dtype is None:
        return a
    from .processing_chain import _device_dtype

    return a.to(_device_dtype(dtype))


def _nan_fill(a: torch.Tensor, fill: float) -> torch.Tensor:
    return a.masked_fill(torch.isnan(a), fill) if a.is_floating_point() else a


def _extremum(tfn, nan_fill: float | None = None, all_nan=float("nan")):
    """(arg)max / (arg)min; with ``nan_fill`` the NaN-skipping variant, which
    gives ``all_nan`` on an all-NaN row (NaN from nanmax / nanmin, -1 from
    nanargmax / nanargmin as in jax.numpy)."""

    def f(a, axis, out=None, keepdims=False):
        _no_out(out, tfn.__name__)
        if nan_fill is None or not a.is_floating_point():
            return tfn(a, axis, bool(keepdims))
        nan = torch.isnan(a)
        y = tfn(a.masked_fill(nan, nan_fill), axis, bool(keepdims))
        return y.masked_fill(nan.all(axis, bool(keepdims)), all_nan)

    return f


def _summed(tfn, nan_fill: float | None = None):
    def f(a, axis, dtype=None, out=None, keepdims=False):
        _no_out(out, tfn.__name__)
        a = _cast(a, dtype)
        if tfn in (torch.mean, torch.nanmean) and not a.is_floating_point():
            a = a.to(torch.float64)
        if nan_fill is not None:
            a = _nan_fill(a, nan_fill)
        return tfn(a, axis, keepdim=bool(keepdims))

    return f


def _scanned(tfn, nan_fill: float | None = None):
    def f(a, axis, dtype=None, out=None):
        _no_out(out, tfn.__name__)
        a = _cast(a, dtype)
        if nan_fill is not None:
            a = _nan_fill(a, nan_fill)
        return tfn(a, axis)

    return f


def _spread(nan_skipping: bool, root: bool):
    """std / var / nanstd / nanvar: numpy's two-pass moments with ``ddof``."""

    def f(a, axis, dtype=None, out=None, ddof=0, keepdims=False):
        _no_out(out, "std")
        a = _cast(a, dtype)
        if not a.is_floating_point():
            a = a.to(torch.float64)
        if nan_skipping:
            ok = ~torch.isnan(a)
            cnt = ok.sum(axis, keepdim=True).to(a.dtype)
            mean = torch.where(ok, a, 0).sum(axis, keepdim=True) / cnt
            d = torch.where(ok, a - mean, 0)
        else:
            cnt = torch.tensor(float(a.shape[axis]), dtype=a.dtype)
            d = a - a.mean(axis, keepdim=True)
        v = (d * d).sum(axis, keepdim=True) / (cnt - ddof)
        v = v.sqrt() if root else v
        return v if keepdims else v.squeeze(axis)

    return f


def median(a, axis, out=None, overwrite_input=False, keepdims=False):
    """numpy's median: the mean of the two middle values of an even count,
    NaN where the reduced row holds a NaN."""
    _no_out(out, "median")
    n = a.shape[axis]
    s = torch.sort(a, axis).values
    m = (s.narrow(axis, (n - 1) // 2, 1) + s.narrow(axis, n // 2, 1)) / 2
    if m.is_floating_point():
        m = m.masked_fill(torch.isnan(a).any(axis, keepdim=True), float("nan"))
    return m if keepdims else m.squeeze(axis)


def sort(a, axis=-1, kind=None, order=None):
    if order is not None:
        raise ProcessingChainError("numpy.sort: order= is not supported")
    if axis is None:
        return torch.sort(a.reshape(-1)).values
    return torch.sort(a, dim=int(axis), stable=kind == "stable").values


def percentile(a, q, axis=None, out=None, overwrite_input=False,
               method="linear", keepdims=False):
    """numpy's percentile with its default linear interpolation (numpy's
    ``_lerp``), in float64 for float inputs; the dims of ``q`` come first."""
    _no_out(out, "percentile")
    if method != "linear":
        raise ProcessingChainError(
            f"numpy.percentile: method {method!r} is not supported"
        )
    dt = a.dtype if a.is_floating_point() else torch.float64
    if axis is None:
        shape = (1,) * a.ndim
        a, axis = a.reshape(-1), 0
    else:
        axis = int(axis) % a.ndim
        shape = a.shape[:axis] + (1,) + a.shape[axis + 1:]
    n = a.shape[axis]
    s = torch.sort(a.to(torch.float64), axis).values
    # a NaN sorts last: a row with one gives NaN, as in numpy
    row_nan = torch.isnan(s.select(axis, n - 1))
    qv = torch.as_tensor(np.asarray(q, dtype=np.float64), device=a.device) / 100
    pos = qv * (n - 1)
    lo = pos.floor()
    gamma = pos - lo
    lo = lo.long().clamp(0, n - 1)
    hi = (lo + 1).clamp(max=n - 1)
    res = []
    for k in range(qv.numel()):
        x0 = s.select(axis, int(lo.reshape(-1)[k]))
        x1 = s.select(axis, int(hi.reshape(-1)[k]))
        g = float(gamma.reshape(-1)[k])
        d = x1 - x0
        r = x1 - d * (1 - g) if g >= 0.5 else x0 + d * g
        r = torch.where(x0 == x1, x0, r).masked_fill(row_nan, float("nan"))
        res.append(r.reshape(shape) if keepdims else r)
    r = torch.stack(res).reshape(qv.shape + res[0].shape)
    return r.to(dt)


def ptp(a, axis=None, out=None, keepdims=False):
    _no_out(out, "ptp")
    dims = () if axis is None else int(axis)
    return torch.amax(a, dims, bool(keepdims)) - torch.amin(a, dims, bool(keepdims))


def average(a, axis=None, weights=None, returned=False, keepdims=False):
    """numpy's average; 1-D ``weights`` lie along ``axis``."""
    if not a.is_floating_point():
        a = a.to(torch.float64)
    dims = tuple(range(a.ndim)) if axis is None else int(axis) % a.ndim
    if weights is None:
        avg = a.mean(dims, keepdim=bool(keepdims))
        scl = torch.full_like(avg, a.numel() / avg.numel())
    else:
        w = torch.as_tensor(np.asarray(weights) if not isinstance(
            weights, torch.Tensor) else weights, device=a.device).to(a.dtype)
        if w.shape != a.shape:
            if axis is None or w.ndim != 1:
                raise ProcessingChainError(
                    "numpy.average: weights differ in shape from a and are not "
                    "1-D along axis"
                )
            w = w.reshape([-1 if d == dims else 1 for d in range(a.ndim)])
        scl = torch.broadcast_to(w, a.shape).sum(dims, keepdim=bool(keepdims))
        avg = (a * w).sum(dims, keepdim=bool(keepdims)) / scl
    return (avg, scl) if returned else avg


def round_(a, decimals=0, out=None):
    _no_out(out, "round")
    if not a.is_floating_point() and int(decimals) >= 0:
        return a.clone()
    return torch.round(a, decimals=int(decimals))


def flip(m, axis=None):
    if axis is None:
        return torch.flip(m, tuple(range(m.ndim)))
    axes = (axis,) if np.ndim(axis) == 0 else tuple(axis)
    return torch.flip(m, tuple(int(x) for x in axes))


def _operand(v, like: torch.Tensor):
    """A chain argument as torch takes it: a tensor, or a Python scalar for a
    numpy scalar or 0-d array (torch refuses numpy scalars as numbers)."""
    if v is None or isinstance(v, torch.Tensor):
        return v
    a = np.asarray(v)
    return a.item() if a.ndim == 0 else torch.as_tensor(a, device=like.device)


def diff(a, n=1, axis=-1):
    return torch.diff(a, int(n), int(axis))


def clip(a, a_min=None, a_max=None, out=None):
    _no_out(out, "clip")
    return torch.clamp(a, _operand(a_min, a), _operand(a_max, a))


def where(condition, x, y):
    if condition.dtype != torch.bool:
        condition = condition != 0
    return torch.where(condition, _operand(x, condition), _operand(y, condition))


_INF = float("inf")

NUMPY_FUNCS = {
    "amax": _extremum(torch.amax),
    "max": _extremum(torch.amax),
    "amin": _extremum(torch.amin),
    "min": _extremum(torch.amin),
    "nanmax": _extremum(torch.amax, -_INF),
    "nanmin": _extremum(torch.amin, _INF),
    "argmax": _extremum(torch.argmax),
    "argmin": _extremum(torch.argmin),
    "nanargmax": _extremum(torch.argmax, -_INF, -1),
    "nanargmin": _extremum(torch.argmin, _INF, -1),
    "sum": _summed(torch.sum),
    "prod": _summed(torch.prod),
    "mean": _summed(torch.mean),
    "nansum": _summed(torch.sum, 0.0),
    "nanmean": _summed(torch.nanmean),
    "std": _spread(False, True),
    "var": _spread(False, False),
    "nanstd": _spread(True, True),
    "nanvar": _spread(True, False),
    "median": median,
    "cumsum": _scanned(torch.cumsum),
    "cumprod": _scanned(torch.cumprod),
    "nancumsum": _scanned(torch.cumsum, 0.0),
    "nancumprod": _scanned(torch.cumprod, 1.0),
    "sort": sort,
    "percentile": percentile,
    "ptp": ptp,
    "average": average,
    "round": round_,
    "flip": flip,
    "diff": diff,
    "clip": clip,
    "where": where,
}


# the sums of K7's reduce op (processors/_tile_program.REDUCTIONS), which
# the tape's plain walk takes in K7's order
K7_SUMS = frozenset(("sum", "mean", "nansum", "nanmean"))


def k7_reduce(name: str, a: torch.Tensor, f64: bool = False) -> torch.Tensor:
    """``numpy.<name>(a, axis=-1)`` for ``name`` in :data:`K7_SUMS` as K7's
    reduce op computes it (the tape's plain walk): the row's values in
    float64 (a NaN as 0 for ``nansum`` and ``nanmean``) summed in K7's block
    order (:func:`.processors._numerics.k7_sum`), a mean divided by its count
    in float64; in the member's type (the row's for float rows; for bool
    rows int64, a mean float64). Differs from the member's
    float32 sum by rounding only. K7's float64 op (``f64``: a float64
    program's row, or a bool row in one) takes the same sums."""
    from .processors._numerics import k7_sum

    x = a.to(torch.float64)
    if name.startswith("nan"):
        ok = ~torch.isnan(x)
        x = torch.where(ok, x, 0.0)
        cnt = ok.sum(-1).to(torch.float64)
    else:
        cnt = torch.full(x.shape[:-1], float(x.shape[-1]), dtype=torch.float64,
                         device=x.device)
    s = k7_sum(x.reshape(-1, x.shape[-1])).reshape(x.shape[:-1])
    if name.endswith("mean"):
        s = s / cnt
    if a.is_floating_point():
        return s.to(a.dtype)
    return s if name.endswith("mean") else s.to(torch.int64)
