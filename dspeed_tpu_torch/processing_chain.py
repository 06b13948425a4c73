"""The dspeed_tpu_torch processing-chain engine: a DSP-graph compiler that
runs its steps eagerly on a ``torch.device``.

The reference implementation (``dspeed/processing_chain.py``) interprets a
list of pre-bound numba gufunc calls over persistent, 16-event numpy block
buffers. The JAX package (``dspeed_tpu/processing_chain.py``) keeps the same
*front-end semantics* — named variables with shape/dtype/unit/coordinate-grid
metadata, an expression sub-language, gufunc-signature driven broadcasting
and type resolution, automatic unit conversions — and compiles the DAG into a
list of functional *steps*. This port keeps that step list and runs it
eagerly, one chunk of events at a time:

- :class:`ProcChainVar` holds metadata only (no buffers); every variable is a
  key into an environment ``dict[str, torch.Tensor]`` of batched values
  ``(block, *shape)``. Constants are host numpy values, bound when the chain
  is built so kernels can specialize on them (reference: buffers +
  is_const, ``processing_chain.py:147-377``).
- :class:`KernelStep` is the analog of the reference's ``ProcessorManager``
  (``processing_chain.py:1485-1803``): built once at chain-construction time,
  it performs the same dims/type/unit resolution against the kernel's gufunc
  signature, then at run time pulls its inputs from the environment,
  reshapes/casts, calls the batched PyTorch kernel, and binds outputs.
- Unit conversions between representations (e.g. ``tp_0`` computed in clock
  ticks, written out in ns) are :class:`ConvertStep`\\ s, the analog of
  ``UnitConversionManager`` (``processing_chain.py:1806-1908``); each variable
  tracks its materialized representations in ``ProcChainVar.reps``.
- I/O managers (``processing_chain.py:1911-2360``) translate LGDO buffers to
  environment inputs / from environment outputs on the host, once per chunk:
  inputs are copied to the device once, through pinned host memory, and
  outputs are copied back once, at the end of the chunk. No step moves a
  tensor to the host.

``build_processing_chain`` (reference ``processing_chain.py:2363-2873``)
keeps the exact config schema: JSON/YAML, multi-output keys, ``db.*``
substitution with defaults, dependency resolution with cycle detection,
``init_args`` factories, and build-time const folding.
"""

from __future__ import annotations

import ast
import functools
import importlib
import itertools as it
import json
import os
import re
import time
from copy import deepcopy
from numbers import Real
from typing import Any, Collection, Mapping, MutableMapping, NamedTuple

import numpy as np
import torch

from . import config
from . import lh5 as lgdo
from .errors import DSPFatal, ProcessingChainError
from .units import Quantity, Unit, ureg

import logging

log = logging.getLogger("dspeed_tpu_torch.processing_chain")

__all__ = [
    "auto",
    "CoordinateGrid",
    "ProcChainVar",
    "ProcessingChain",
    "build_processing_chain",
]


class _Auto:
    """Sentinel for deduce-me-later metadata (the reference's ``auto``)."""

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self) -> str:
        return "auto"

    def __bool__(self) -> bool:
        return False


auto = _Auto()


def is_in_ureg(unit) -> bool:
    """True if ``unit`` is a known physical unit (pint lookup in the ref)."""
    return isinstance(unit, (Unit, Quantity)) or (
        isinstance(unit, str) and bool(unit) and unit in ureg
    )


class CoordinateGrid:
    """A (period, offset) pair describing a variable's sample axis.

    ``period`` is a unitted :class:`Quantity`; ``offset`` is a
    :class:`Quantity` in compatible units or a :class:`ProcChainVar` holding a
    per-event offset (reference ``processing_chain.py:67-144``).
    """

    def __init__(self, period, offset=0) -> None:
        if isinstance(period, CoordinateGrid):
            offset = period.offset
            period = period.period
        elif isinstance(period, ProcChainVar):
            if period.grid in (None, auto):
                raise ProcessingChainError(
                    f"{period} does not have an assigned coordinate grid"
                )
            offset = period.grid.offset
            period = period.grid.period
        elif isinstance(period, (tuple, list)):
            period, offset = period

        if isinstance(period, str):
            period = Quantity(1.0, period)
        elif isinstance(period, Unit):
            period = Quantity(1, period)

        if isinstance(offset, Real) and not isinstance(offset, bool):
            offset = offset * period
        if not isinstance(period, Quantity) or not isinstance(
            offset, (Quantity, ProcChainVar)
        ):
            raise ProcessingChainError(
                f"cannot construct CoordinateGrid from ({period}, {offset})"
            )
        self.period = period
        self.offset = offset

    def __eq__(self, other) -> bool:
        if not isinstance(other, CoordinateGrid):
            return NotImplemented
        if isinstance(self.offset, ProcChainVar) or isinstance(
            other.offset, ProcChainVar
        ):
            off_eq = self.offset is other.offset
        else:
            off_eq = self.offset == other.offset
        return self.period == other.period and off_eq

    def __hash__(self):
        off = self.offset
        off_id = id(off) if isinstance(off, ProcChainVar) else off
        return hash((self.period, off_id))

    def unit_str(self) -> str:
        return format(self.period.u, "~") or str(self.period.u)

    def get_period(self, unit) -> float:
        if isinstance(unit, str):
            unit = ureg.Quantity(unit)
        return float(self.period / unit)

    def get_offset(self, unit=None):
        """Offset converted to ``unit`` (default: periods). If the offset is a
        per-event variable, returns the *env key* of its converted values."""
        if unit is None:
            unit = self.period
        elif isinstance(unit, str):
            unit = ureg.Quantity(unit)
        if isinstance(self.offset, ProcChainVar):
            return self.offset.value_in(CoordinateGrid(unit))
        return float(self.offset / unit)

    def __str__(self) -> str:
        off = (
            self.offset.name
            if isinstance(self.offset, ProcChainVar)
            else str(self.offset)
        )
        return f"({self.period},{off})"

    __repr__ = __str__


def _rep_id(rep) -> Any:
    """Hashable identity of a representation (unit / grid / opaque string)."""
    if rep is None or rep is auto:
        return None
    if isinstance(rep, CoordinateGrid):
        off = rep.offset
        off_key = id(off) if isinstance(off, ProcChainVar) else str(off)
        return ("grid", str(rep.period), off_key)
    if isinstance(rep, Quantity):
        return ("unit", rep.u.dims, rep.u.scale, rep.m)
    if isinstance(rep, Unit):
        return ("unit", rep.dims, rep.scale, 1)
    if isinstance(rep, str):
        if rep in ureg:
            q = ureg.Quantity(rep)
            return ("unit", q.u.dims, q.u.scale, q.m)
        return ("str", rep)
    return ("other", str(rep))


class ProcChainVar:
    """Named chain variable: metadata + an environment key (no host buffer).

    Mirrors the reference's ``ProcChainVar`` (``processing_chain.py:147-377``)
    minus the numpy block buffers: values live in the step environment under
    ``self.key``, in the variable's *native* representation; other unit/grid
    representations are added as :class:`ConvertStep`\\ s on demand
    (reference: multi-representation buffer list, ``:271-313``).
    """

    _counter = it.count()

    def __init__(
        self,
        proc_chain: "ProcessingChain",
        name: str,
        shape=auto,
        dtype=auto,
        grid=auto,
        unit=auto,
        is_coord=auto,
        vector_len=None,
        is_const: bool = False,
    ) -> None:
        self.proc_chain = proc_chain
        self.name = name
        self.key = f"{name}#{next(self._counter)}"
        self.shape = shape
        self.dtype = dtype
        self.grid = grid
        self.unit = unit
        self.is_coord = is_coord
        self.vector_len = vector_len
        self.is_const = is_const
        self.const_value: np.ndarray | None = None
        # rep_id -> env key holding this var converted to that representation
        self.reps: dict[Any, str] = {}
        self.defined = False  # set once some step/input binds self.key
        log.debug("added variable: %s", self.description())

    def __setattr__(self, name: str, value: Any) -> None:
        if value is auto:
            pass
        elif name == "shape":
            value = tuple(value) if hasattr(value, "__iter__") else (int(value),)
            if not all(isinstance(d, (int, np.integer)) for d in value):
                raise ProcessingChainError(f"bad shape {value} for {self}")
            value = tuple(int(d) for d in value)
        elif name == "dtype" and value is not None and not isinstance(value, np.dtype):
            value = np.dtype(value)
        elif (
            name == "grid"
            and value is not None
            and not isinstance(value, CoordinateGrid)
        ):
            value = (
                CoordinateGrid(*value)
                if isinstance(value, (tuple, list))
                else CoordinateGrid(value, 0)
            )
        elif name == "is_coord" and value is not auto:
            value = bool(value)
        elif name == "vector_len" and value is not None:
            if not isinstance(value, ProcChainVar):
                value = self.proc_chain.get_variable(value)
            value.update_auto(shape=(), grid=None, unit=None, is_coord=False)
        super().__setattr__(name, value)

    @property
    def period(self):
        return self.grid.period if isinstance(self.grid, CoordinateGrid) else None

    @property
    def offset(self):
        return self.grid.offset if isinstance(self.grid, CoordinateGrid) else None

    @property
    def buffer(self):  # API parity; not a numpy buffer here
        return self.key

    def native_rep(self):
        """The representation env[self.key] is stored in: the coordinate grid
        for coords, else the unit (reference ``get_buffer``, ``:271-313``)."""
        if self.is_coord is True and isinstance(self.grid, CoordinateGrid):
            return self.grid
        return None if self.unit in (auto, None) else self.unit

    def value_in(self, rep) -> str:
        """Env key of this variable converted into representation ``rep``,
        inserting a :class:`ConvertStep` on first use (the analog of
        ``get_buffer(unit)`` + ``UnitConversionManager``)."""
        if rep is None or rep is auto:
            return self.key
        native = self.native_rep()
        if self.is_coord is True and not isinstance(self.grid, CoordinateGrid):
            # un-gridded coordinate adopts the requested grid as native
            if isinstance(rep, CoordinateGrid):
                self.grid = rep
            else:
                self.grid = CoordinateGrid(rep)
            return self.key
        if _rep_id(rep) == _rep_id(native):
            return self.key
        if not isinstance(rep, CoordinateGrid) and not is_in_ureg(rep):
            return self.key  # opaque target: no conversion possible
        if not isinstance(native, CoordinateGrid) and not is_in_ureg(native):
            return self.key  # opaque source: no conversion possible
        key = self.reps.get(_rep_id(rep))
        if key is None:
            step = ConvertStep(self, rep)
            self.proc_chain._steps.append(step)
            self.reps[_rep_id(rep)] = step.out_key
            log.debug("added conversion: %s", step)
            key = step.out_key
        return key

    def update_auto(
        self,
        shape=auto,
        dtype=auto,
        grid=auto,
        unit=auto,
        is_coord=auto,
        period=None,
        offset=0,
        vector_len=None,
    ) -> None:
        """Fill in any metadata still set to ``auto``; leave the rest alone
        (reference ``processing_chain.py:332-371``)."""
        if grid is auto and period is not None:
            if isinstance(offset, str):
                offset = self.proc_chain.get_variable(offset, expr_only=True)
            grid = CoordinateGrid(period, offset)
        # a deduced value only lands on attributes still set to `auto`:
        # anything the user (or an earlier deduction) pinned stays pinned
        updated = False
        for attr, new in (
            ("shape", shape), ("dtype", dtype), ("grid", grid),
            ("unit", unit), ("is_coord", is_coord),
        ):
            if new is not auto and getattr(self, attr) is auto:
                setattr(self, attr, new)
                updated = True
        if vector_len is not None and self.vector_len is None:
            self.vector_len = vector_len
        if updated:
            log.debug("updated variable: %s", self.description())

    def description(self) -> str:
        return (
            f"{self.name}(shape: {self.shape}, dtype: {self.dtype}, "
            f"grid: {self.grid}, unit: {self.unit}, is_coord: {self.is_coord})"
        )

    def __str__(self) -> str:
        return self.name

    def __repr__(self) -> str:
        return f"ProcChainVar({self.description()})"

# ---------------------------------------------------------------------------
# Steps: the functional program the chain compiles to
# ---------------------------------------------------------------------------


class Step:
    """One operation: reads env keys, writes env keys."""

    name: str = "step"
    time_total: float = 0.0

    def run(self, env: dict) -> None:
        raise NotImplementedError

    def __str__(self) -> str:
        return self.name


# numpy ufuncs of the expression sub-language whose torch counterparts are
# spelled differently (the rest share their numpy name)
_UFUNC_RENAMES = {
    "true_divide": "div", "divide": "div", "power": "pow",
    "absolute": "abs", "negative": "neg", "less": "lt", "less_equal": "le",
    "greater": "gt", "greater_equal": "ge", "equal": "eq",
    "not_equal": "ne", "arctan2": "atan2", "fabs": "abs", "rint": "round",
}


def _sign(x):
    """numpy's sign: NaN where ``x`` is NaN (``torch.sign`` gives 0 there)."""
    s = torch.sign(x)
    return torch.where(torch.isnan(x), x, s) if x.is_floating_point() else s


# float32 transcendental ufuncs taken in float64 and rounded once: the
# card's and the CPU's float32 versions round differently in the last bit,
# which a fit downstream (the flagship extras' log of a tail) amplifies
_WIDENED_UFUNCS = frozenset(("exp", "expm1", "log", "log10", "log1p", "log2"))


def _np_to_torch_ufunc(func):
    """Map a numpy ufunc (used by the expression parser) to a function on
    tensors. Operands that are all host values (build-time const folding)
    go through the numpy ufunc itself."""
    name = func.__name__
    tfn = _sign if name == "sign" else getattr(torch, _UFUNC_RENAMES.get(name, name), None)
    if tfn is None:
        raise ProcessingChainError(f"no PyTorch equivalent for ufunc {name}")

    widen = name in _WIDENED_UFUNCS

    def fn(*args):
        ref = next((a for a in args if isinstance(a, torch.Tensor)), None)
        if ref is None:
            return func(*args)
        if widen and ref.dtype == torch.float32 and len(args) == 1:
            return tfn(ref.double()).float()
        return tfn(*(
            a if isinstance(a, torch.Tensor) else _device_operand(a, ref.device)
            for a in args
        ))

    fn.__name__ = name
    # a fresh closure per step: give _cse_steps the identity the JAX
    # package's jnp function has, so that identical expressions merge
    fn._cse_token = ("ufunc", name)
    return fn


def _numpy_processor(fname: str, signature: str):
    """The tensor function for ``numpy.<fname>`` with numpy's positional
    signature (:mod:`._numpy_funcs`); raises for a name with no entry."""
    from ._numpy_funcs import NUMPY_FUNCS, REDUCTIONS
    from .processors import parse_signature

    fn = NUMPY_FUNCS.get(fname)
    if fn is None:
        raise ProcessingChainError(
            f"numpy.{fname} has no counterpart with numpy's signature in "
            f"dspeed_tpu_torch"
        )
    if fname in REDUCTIONS:
        # the reference's axis arg counts from its (block, core...) buffer
        # layout; remap to a negative, core-relative axis so the kernel is
        # rank-polymorphic over extra batch dims
        ncore0 = len(parse_signature(signature)[0][0])

        def func(x, axis, *rest, _fn=fn, _nc=ncore0):
            return _fn(_as_tensor(x), int(axis) - 1 - _nc, *rest)

        token = ("npred", fname, ncore0)
    else:
        def func(x, *rest, _fn=fn):
            return _fn(_as_tensor(x), *rest)

        token = ("npfn", fname)
    # the wrapper closure is fresh per step; give _cse_steps a stable
    # identity so identical calls can merge
    func._cse_token = token
    return func


def _device_operand(a, device) -> torch.Tensor:
    """A host operand of a tensor op as a tensor on ``device``, of numpy's
    dtype for it. A scalar is filled in on the device: a copy of a host
    scalar to the card would make the host wait for the stream."""
    t = torch.as_tensor(np.asarray(a))
    if t.ndim == 0 and device.type == "cuda":
        return torch.full((), t.item(), dtype=t.dtype, device=device)
    return t.to(device)


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def _to_numpy(v):
    """Host numpy value of a kernel output (tensor, numpy or python)."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


_NP_FROM_TORCH = {
    torch.bool: np.bool_, torch.uint8: np.uint8, torch.int8: np.int8,
    torch.int16: np.int16, torch.int32: np.int32, torch.int64: np.int64,
    torch.float32: np.float32, torch.float64: np.float64,
    torch.complex64: np.complex64, torch.complex128: np.complex128,
}
_TORCH_FROM_NP = {np.dtype(v): k for k, v in _NP_FROM_TORCH.items()}
# unsigned types torch does little arithmetic in: widened on the device,
# restored by the output managers
_TORCH_FROM_NP.update({
    np.dtype("uint16"): torch.int32, np.dtype("uint32"): torch.int64,
    np.dtype("uint64"): torch.int64, np.dtype("float16"): torch.float32,
})


def _device_dtype(dtype) -> torch.dtype:
    """The torch dtype a declared numpy dtype is held in on the device."""
    try:
        return _TORCH_FROM_NP[np.dtype(dtype)]
    except KeyError:
        raise ProcessingChainError(f"dtype {dtype} has no device counterpart")


_SAFE_TYPECHARS = set("?bBhHiIlLqQefdFD")

def _ufunc_types(func) -> list[str]:
    """A numpy ufunc's type signatures, filtered to numeric/bool chars."""
    return [
        t
        for t in func.types
        if all(c in _SAFE_TYPECHARS for c in t.replace("->", ""))
    ]


def _align_shape(target, shape) -> list:
    """``shape`` with its core dims aligned against ``target`` from the
    right, singleton axes inserted at mismatches (reference :1726-1732)."""
    arshape = list(shape)
    for idim in range(-1, -1 - len(target), -1):
        if len(arshape) < -idim or (
            target[idim] != -1 and arshape[idim] != target[idim]
        ):
            arshape.insert(len(arshape) + idim + 1, 1)
    return arshape


class _ArgSpec:
    """How one kernel argument is fetched at run time."""

    __slots__ = ("kind", "key", "value", "reshape", "dtype")

    def __init__(self, kind, key=None, value=None, reshape=None, dtype=None):
        self.kind = kind  # "env" | "const"
        self.key = key
        self.value = value
        self.reshape = reshape  # target ndim (with batch); None = as-is
        self.dtype = dtype


class _OutSpec:
    __slots__ = ("var", "key", "dtype", "shape")

    def __init__(self, var, key, dtype, shape):
        self.var = var
        self.key = key
        self.dtype = dtype
        self.shape = shape


class _DimInfo:
    __slots__ = ("length", "grid")

    def __init__(self, length, grid):
        self.length = length
        self.grid = grid


class KernelStep(Step):
    """A processor bound to chain variables: the ``ProcessorManager`` analog.

    All shape/dtype/unit resolution happens here at construction time,
    mirroring the reference pass (``processing_chain.py:1485-1803``):
    gufunc-signature dims are broadcast against variable shapes (with an
    implicit outer block dimension), the first castable type signature is
    selected, ``auto`` variable metadata is deduced and filled in, and unitted
    scalars are converted to grid sample counts via the pi-theorem exponent
    search. At run time :meth:`run` fetches/reshapes/casts inputs, invokes
    the batched PyTorch kernel, and binds the outputs into the environment.
    """

    # checked mode: env key of this step's per-event flag column (set by
    # ProcessingChain._run_plan while the chain is checked)
    check_key: str | None = None
    # while the chain runs this step on a block of its first argument's
    # samples (ProcessingChain._run_sharded_step): the number of blocks
    sample_blocks: int = 1

    def __init__(
        self,
        proc_chain: "ProcessingChain",
        func,
        params: list,
        kw_params: dict | None = None,
        signature: str | None = None,
        types: list[str] | None = None,
        grid: CoordinateGrid | None = None,
    ) -> None:
        from .processors import Kernel

        kw_params = kw_params or {}
        self.proc_chain = proc_chain
        self.params = list(params)
        self.kw_params = dict(kw_params)
        self.time_total = 0.0
        # set by ProcessingChain._thread_nan_masks: env key of a precomputed
        # per-event bad-row mask handed to badrow-aware kernels
        self.badrow_key: str | None = None

        # normalize the callable into a Kernel with metadata
        if isinstance(func, Kernel):
            kern = func
        elif isinstance(func, np.ufunc):
            sig = signature or (
                ",".join(["()"] * func.nin) + "->" + ",".join(["()"] * func.nout)
            )
            kern = Kernel(
                _np_to_torch_ufunc(func),
                sig,
                types or _ufunc_types(func),
                name=func.__name__,
            )
        elif callable(func):
            if signature is None or types is None:
                raise ProcessingChainError(
                    f"must provide signature and types for {func}"
                )
            fname = getattr(func, "__name__", "fn")
            if getattr(func, "__module__", "").split(".")[0] == "numpy":
                func = _numpy_processor(fname, signature)

            kern = Kernel(func, signature, types, name=fname)
        else:
            raise ProcessingChainError(f"cannot use {func!r} as a processor")
        if signature is not None and signature != kern.signature:
            kern = Kernel(
                kern.fn, signature, types or kern.types, name=kern.__name__,
                nout=kern.nout, static=kern.static, uses_dims=kern.uses_dims,
                badrow_arg=kern.badrow_arg,
                mask_preserving=kern.mask_preserving,
            )
        self.kernel = kern
        self.name = str(self)

        # list-valued params (e.g. db-supplied noise matrices) are const arrays
        self.params = [
            np.asarray(p) if isinstance(p, (list, tuple)) else p
            for p in self.params
        ]
        self.kw_params = {
            k: np.asarray(v) if isinstance(v, (list, tuple)) else v
            for k, v in self.kw_params.items()
        }
        all_params = list(it.chain(self.params, self.kw_params.values()))
        dims_list = kern.dims_list
        if len(dims_list) != len(all_params):
            raise ProcessingChainError(
                f"expected {len(dims_list)} arguments from signature "
                f"{kern.signature}; found {len(all_params)}: "
                f"({', '.join(str(p) for p in all_params)})"
            )

        found_types = [t.replace("->", "") for t in (types or kern.types)]

        # --- pass 1: dims broadcasting + type filtering ------------------
        dims_dict: dict[str, _DimInfo] = {}
        outerdims: list[_DimInfo] = []
        for ipar, (dims, param) in enumerate(zip(dims_list, all_params)):
            if not isinstance(param, (ProcChainVar, np.ndarray)):
                continue
            if getattr(param, "dtype", auto) is not auto:
                ch = param.dtype.char
                found_types = [
                    ts for ts in found_types if np.can_cast(ch, ts[ipar])
                ]
            if getattr(param, "shape", auto) is auto:
                continue
            fun_dims: list = list(outerdims) + list(dims)
            arr_dims = list(param.shape)
            if (
                isinstance(param, ProcChainVar)
                and isinstance(param.grid, CoordinateGrid)
                and param.is_coord is not True
            ):
                arr_grid = param.grid
            else:
                arr_grid = None
            if not grid:
                grid = arr_grid

            for i in range(max(len(fun_dims), len(arr_dims))):
                fd = fun_dims[-i - 1] if i < len(fun_dims) else None
                if i < len(arr_dims):
                    ad = arr_dims[-i - 1]
                elif i == len(arr_dims):
                    ad = -1  # the implicit outer block dimension
                else:
                    ad = None

                if isinstance(fd, str):
                    if fd in dims_dict:
                        this_dim = dims_dict[fd]
                        if not ad or this_dim.length != ad:
                            raise ProcessingChainError(
                                f"failed to broadcast array dimensions for "
                                f"{kern.__name__}: inconsistent dim {fd}"
                            )
                        if not this_dim.grid:
                            this_dim.grid = arr_grid
                    else:
                        dims_dict[fd] = _DimInfo(ad, arr_grid)
                elif fd is None:
                    outerdims.insert(0, _DimInfo(ad, arr_grid))
                elif ad is None:
                    continue
                elif fd.length != ad:
                    if len(fun_dims) > len(arr_dims):
                        arr_dims.insert(len(arr_dims) - i, 1)
                    elif len(fun_dims) < len(arr_dims):
                        outerdims.insert(len(fun_dims) - i, _DimInfo(ad, arr_grid))
                        fun_dims.insert(len(fun_dims) - i, ad)
                    else:
                        raise ProcessingChainError(
                            f"failed to broadcast array dimensions for "
                            f"{kern.__name__}: require "
                            f"{tuple(d.length for d in outerdims)}+core, found "
                            f"{tuple(arr_dims)} for {param}"
                        )
                elif not fd.grid:
                    fd.grid = arr_grid
                arr_grid = None  # only the innermost dim carries the grid

        if not found_types:
            raise ProcessingChainError(
                f"could not find a type signature matching the types of the "
                f"variables given for {self} (types: {types or kern.types})"
            )
        self.types = [np.dtype(c) for c in found_types[0]]

        # fall back to a coordinate param's grid, then the chain's default
        if not grid:
            for param in all_params:
                if isinstance(param, ProcChainVar) and param.is_coord is True:
                    if isinstance(param.grid, CoordinateGrid):
                        grid = param.grid
                        break
        if not grid:
            grid = proc_chain._default_grid
        self.grid = grid

        # --- pass 2: bind each argument ----------------------------------
        self.arg_specs: list[_ArgSpec] = []
        self.kwarg_specs: dict[str, _ArgSpec] = {}
        self.out_specs: list[_OutSpec] = []
        self.dims = {d: info.length for d, info in dims_dict.items()}

        names_iter = it.chain(
            zip(it.repeat(None), self.params), self.kw_params.items()
        )
        out_set = set(kern.out_indices)
        for ipar, ((arg_name, param), dims, dtype) in enumerate(
            zip(names_iter, dims_list, self.types)
        ):
            dim_list = list(outerdims)
            for d in dims:
                if d not in dims_dict:
                    if isinstance(param, np.ndarray):
                        dims_dict[d] = _DimInfo(param.shape[-1], None)
                        self.dims[d] = param.shape[-1]
                    else:
                        raise ProcessingChainError(
                            f"could not deduce dimension {d} for {param}"
                        )
                dim_list.append(dims_dict[d])
            shape = tuple(d.length for d in dim_list)
            this_grid = dim_list[-1].grid if dim_list else None
            is_output = ipar in out_set

            spec = self._bind_param(
                param, shape, this_grid, np.dtype(dtype), is_output,
                ncore=len(dims),
            )
            if is_output:
                continue
            if arg_name is None:
                self.arg_specs.append(spec)
            else:
                self.kwarg_specs[arg_name] = spec

    # -- binding helpers ---------------------------------------------------

    def _bind_param(self, param, shape, this_grid, dtype, is_output, ncore=0):
        grid = self.grid
        if isinstance(param, ProcChainVar):
            # deduce auto metadata exactly as the reference does
            # (processing_chain.py:1702-1723)
            unit = auto
            is_coord = False
            if param.is_coord is True and grid is not None:
                unit = str(grid.period.u)
                this_grid = grid
            elif (
                is_in_ureg(param.unit)
                and grid is not None
                and ureg.is_compatible_with(grid.period, param.unit)
            ):
                is_coord = True
                this_grid = grid
            param.update_auto(
                shape=shape[1:] if shape and shape[0] == -1 else shape,
                dtype=dtype,
                grid=this_grid if this_grid is not None else auto,
                unit=unit,
                is_coord=is_coord,
            )
            if is_output:
                key = (
                    param.value_in(grid)
                    if param.is_coord is True and grid is not None
                    else param.key
                )
                self.out_specs.append(_OutSpec(param, key, param.dtype, param.shape))
                param.defined = True
                return None
            key = param.value_in(grid if param.is_coord is True else None)
            if param.is_const:
                return _ArgSpec(
                    "const", value=self._const_payload(param, dtype, ncore)
                )
            # target core shape (outer + core dims); batch dim prepended at run
            return _ArgSpec("env", key=key, reshape=shape, dtype=dtype)

        if is_output:
            raise ProcessingChainError(
                f"output argument of {self.kernel.__name__} must be a "
                f"chain variable, got {param!r}"
            )
        if isinstance(param, np.ndarray):
            v = param.astype(dtype) if param.dtype != dtype else param
            if v.ndim > ncore:
                v = v[None, ...]
            return _ArgSpec("const", value=v)
        if isinstance(param, str):
            if np.issubdtype(dtype, np.integer):
                try:
                    v = np.frombuffer(param.encode("ascii"), dtype).reshape(
                        shape[1:] if shape and shape[0] == -1 else shape
                    )
                except ValueError:
                    raise ProcessingChainError(
                        f"could not convert string '{param}' into byte-array "
                        f"of type {dtype}"
                    )
                return _ArgSpec("const", value=v if v.shape else v[()])
            return _ArgSpec("const", value=param)  # static mode string
        if param is None:
            return _ArgSpec("const", value=None)
        # scalar, possibly unitted (reference :1747-1770)
        if isinstance(param, (Quantity, Unit)):
            q = Quantity(1, param) if isinstance(param, Unit) else param
            if q.dimensionless:
                param = float(q)
            elif not isinstance(grid, CoordinateGrid):
                raise ProcessingChainError(
                    f"could not find valid conversion for {param}; "
                    f"no coordinate grid available"
                )
            else:
                k = ureg.pi_exponent(grid.period, q)
                if k is None:
                    raise ProcessingChainError(
                        f"could not find valid conversion for {param}; "
                        f"CoordinateGrid is {grid}"
                    )
                param = float(q * grid.period**k)
        if np.issubdtype(dtype, np.integer):
            return _ArgSpec("const", value=dtype.type(np.round(param)))
        return _ArgSpec("const", value=dtype.type(param))

    @staticmethod
    def _const_payload(var: ProcChainVar, dtype, ncore: int = 0):
        val = var.const_value
        if val is None:
            raise ProcessingChainError(f"constant {var} has no value yet")
        val = np.asarray(val)
        if val.dtype != dtype:
            val = val.astype(dtype)
        if val.ndim == 0:
            return val[()]  # python-level scalar: static for the kernel
        if val.ndim > ncore:
            # dims beyond the kernel's core are outer dims: give the const
            # the reference's (1, ...) block layout so batched broadcasting
            # lines up (reference ProcChainVar._make_buffer, :259-269)
            return val[None, ...]
        return val  # shared (un-batched) core array (e.g. conv taps)

    # -- run-time execution -----------------------------------------------

    def _fetch(self, spec: _ArgSpec, env: dict):
        if spec.kind == "const":
            return spec.value
        v = env[spec.key]
        if spec.reshape is not None and hasattr(v, "ndim"):
            shape = tuple(v.shape)
            if self.sample_blocks > 1 and spec is self.arg_specs[0]:
                # this rank's block of the row's samples: aligned as the
                # whole row
                shape = (*shape[:-1], shape[-1] * self.sample_blocks)
            arshape = _align_shape(spec.reshape, shape)
            if tuple(arshape) != shape:
                if self.sample_blocks > 1:
                    raise ProcessingChainError(
                        f"{self.kernel.__name__}: a block of samples needs no "
                        "broadcast")
                v = v.reshape(arshape)
        if spec.dtype is not None and isinstance(v, torch.Tensor):
            want = _device_dtype(spec.dtype)
            if v.dtype != want:
                v = v.to(want)
        return v

    def run(self, env: dict) -> None:
        args = [self._fetch(s, env) for s in self.arg_specs]
        kwargs = {k: self._fetch(s, env) for k, s in self.kwarg_specs.items()}
        ck = self.check_key
        if ck is not None and not self.kernel.checker_reads_outputs:
            # checked mode: the per-event DSPFatal-condition flag from the
            # same bound inputs, fetched with the outputs
            env[ck] = self.kernel.checker(*args)
        if self.kernel.uses_dims:
            kwargs["dims"] = self.dims
        if self.badrow_key is not None:
            kwargs["badrow"] = env[self.badrow_key]
        if kwargs:
            outs = self.kernel.fn(*args, **kwargs)
            if not isinstance(outs, tuple):
                outs = (outs,)
        else:
            outs = self.kernel(*args)
        if len(outs) != len(self.out_specs):
            raise ProcessingChainError(
                f"{self.kernel.__name__} returned {len(outs)} outputs; "
                f"expected {len(self.out_specs)}"
            )
        if ck is not None and self.kernel.checker_reads_outputs:
            env[ck] = self.kernel.checker(*args, out=outs[0])
        for spec, val in zip(self.out_specs, outs):
            if isinstance(val, torch.Tensor):
                want = _device_dtype(spec.dtype)
                if val.dtype != want:
                    val = val.to(want)
            else:  # host value: a numpy generator or build-time folding
                val = np.asarray(val).astype(spec.dtype, copy=False)
            env[spec.key] = val
            if spec.var.is_const:
                spec.var.const_value = _to_numpy(val).astype(
                    spec.dtype, copy=False
                )

    def __str__(self) -> str:
        return (
            self.kernel.__name__
            + "("
            + ", ".join(
                [str(p) for p in self.params]
                + [f"{k}={v}" for k, v in self.kw_params.items()]
            )
            + ")"
        )

class ConvertStep(Step):
    """Convert a variable between unit systems / coordinate grids.

    The ``UnitConversionManager`` analog (``processing_chain.py:1806-1908``):
    computes ``(x + from_offset) * ratio - to_offset`` where offsets may be
    per-event values read from the environment (waveform ``t0``).
    """

    def __init__(self, var: ProcChainVar, rep, mode: str | None = None,
                 out_var: ProcChainVar | None = None) -> None:
        from .processors import unit_conversion as uc

        self.var = var
        self.rep = rep
        if mode is None:
            self.kernel = (
                uc.convert
                if var.dtype is not auto and np.issubdtype(var.dtype, np.floating)
                else uc.convert_int
            )
        else:
            try:
                self.kernel = getattr(uc, f"convert_{mode}")
            except AttributeError:
                raise ProcessingChainError(
                    "Mode must be round, floor, ceil or trunc"
                )

        to_offset: Any = 0.0
        unit = rep
        if isinstance(rep, CoordinateGrid):
            to_offset = rep.get_offset()  # float or env key
            unit = rep.period

        native = var.native_rep()
        if isinstance(native, str) and native in ureg:
            native = ureg.Quantity(native)
        if isinstance(native, CoordinateGrid):
            ratio = native.get_period(unit)
            from_offset = native.get_offset()
        elif isinstance(native, (Unit, Quantity)):
            if isinstance(unit, str):
                unit = ureg.Quantity(unit)
            ratio = float(Quantity(1, native) / unit) if isinstance(
                native, Unit
            ) else float(native / unit)
            from_offset = 0.0
        else:
            raise ProcessingChainError(
                f"cannot convert {var} from opaque representation {native!r}"
            )

        self.ratio = ratio
        self.from_offset = from_offset  # float or env key (str)
        self.to_offset = to_offset  # float or env key (str)
        self.in_key = var.key
        self.out_key = out_var.key if out_var is not None else f"{var.key}@{rep}"
        self.out_var = out_var
        self.name = str(self)

    def _offset_val(self, off, env):
        if isinstance(off, str):
            v = env[off]
            return v
        return off

    def run(self, env: dict) -> None:
        x = env[self.in_key]
        f_off = self._offset_val(self.from_offset, env)
        t_off = self._offset_val(self.to_offset, env)

        def align(v):
            if hasattr(v, "ndim") and v.ndim and hasattr(x, "ndim"):
                while v.ndim < x.ndim:
                    v = v[..., None]
            return v

        (out,) = self.kernel(x, align(f_off), align(t_off), self.ratio)
        if self.out_var is not None and self.out_var.dtype is not auto:
            want = _device_dtype(self.out_var.dtype)
            if out.dtype != want:
                out = out.to(want)
        env[self.out_key] = out
        if self.out_var is not None:
            self.out_var.defined = True

    def __str__(self) -> str:
        return f"{self.kernel.__name__}({self.var}, from={self.var.native_rep()}, to={self.rep})"


class AliasStep(Step):
    """Bind one env key to another (expression-node output sharing)."""

    def __init__(self, src_key: str, dst_key: str, name: str = "") -> None:
        self.src_key = src_key
        self.dst_key = dst_key
        self.name = name or f"{dst_key} = {src_key}"

    def run(self, env: dict) -> None:
        env[self.dst_key] = env[self.src_key]


class SliceStep(Step):
    """A subscript view ``var[slice]`` (reference: numpy buffer views)."""

    def __init__(self, src: ProcChainVar, out: ProcChainVar, sl) -> None:
        self.src = src  # kept for fusion matchers that absorb the slice
        self.src_key = src.key
        self.out_key = out.key
        self.sl = sl
        self.name = out.name

    def run(self, env: dict) -> None:
        env[self.out_key] = env[self.src_key][(Ellipsis, self.sl)]


class FuncStep(Step):
    """A step applying an arbitrary function to env values.

    Used for builtins (astype, isnan, comparisons on already-bound values)
    where the full ``KernelStep`` machinery is unnecessary.
    """

    def __init__(self, fn, in_keys: list, out_key: str, name: str,
                 out_dtype=None) -> None:
        self.fn = fn
        self.in_keys = in_keys
        self.out_key = out_key
        self.name = name
        self.out_dtype = out_dtype

    def run(self, env: dict) -> None:
        args = [env[k] if isinstance(k, str) else k for k in self.in_keys]
        out = self.fn(*args)
        if self.out_dtype is not None and isinstance(out, torch.Tensor):
            want = _device_dtype(np.dtype(self.out_dtype))
            if out.dtype != want:
                out = out.to(want)
        env[self.out_key] = out


def _step_writes(s):
    """Env keys a step writes; ``None`` for unknown step kinds."""
    if isinstance(s, KernelStep):
        return {sp.key for sp in s.out_specs}
    if isinstance(s, (ConvertStep, FuncStep, SliceStep)):
        return {s.out_key}
    if isinstance(s, AliasStep):
        return {s.dst_key}
    if isinstance(s, GroupStep):
        return set(s.escapes)
    return None


class GroupStep(Step):
    """A contiguous run of tile-safe steps run as ONE launch of the row-tape
    kernel K7 (``processors/_cuda.py`` :func:`generic_rows`; the generic,
    pattern-free fusion pass, JAX package ``processing_chain.py:1015``).

    The members are lowered into a tape (:mod:`.processors._tile_program`):
    on the card, one block per row reads the group's external planes once,
    keeps every internal plane in shared memory and writes only the
    escaping outputs; a group over float64 planes runs K7's float64 kernel.
    On the CPU the same tape runs as :func:`generic_rows_plain`, each op
    calling its member kernel's own body, or where K7 sums in an order of
    its own the variant the kernel names in ``k7_plain``, so a generic
    chain equals the unfused chain bit for bit but for those sums' rounding.

    A member list the tape cannot take (a member with no K7 op, a plane of
    a type the kernel does not take, a float64 plane in an op with no
    float64 form, a plan over the shared memory of one block) raises
    :class:`LoweringError` at lowering, before any launch.
    The run then bisects as the JAX package's ``_exec`` does (:1050-1112):
    halves of 4 or more members retry, shorter runs run their members
    unfused. Every split is logged and counted in
    ``_tile_program.SPLITS``. A failed build or launch raises.
    """

    def __init__(self, proc_chain, members, ext_in, escapes,
                 name: str = "") -> None:
        self.proc_chain = proc_chain
        self.members = list(members)
        self.ext_in = list(ext_in)
        self.escapes = list(escapes)
        self._programs: dict = {}
        self.name = name or (
            "fusion_group["
            + ",".join(str(getattr(m, "name", m)).split("(")[0]
                       for m in self.members)
            + "]"
        )

    @staticmethod
    def _run_members(members, vals: dict, escapes) -> dict:
        local = dict(vals)
        for m in members:
            m.run(local)
        return {k: local[k] for k in escapes}

    def _program(self, members, vals: dict, escapes):
        """The lowered tape of ``members`` for inputs like ``vals``, built
        once per member list, escapes and input signature."""
        from .processors._tile_program import lower

        key = (
            tuple(id(m) for m in members), tuple(escapes),
            tuple((k, v.dtype, tuple(v.shape[1:])) if isinstance(v, torch.Tensor)
                  else (k, type(v)) for k, v in sorted(vals.items())),
        )
        prog = self._programs.get(key)
        if prog is None:
            prog = self._programs[key] = lower(members, vals, escapes)
        return prog

    def _exec(self, members, env: dict, needed: set) -> dict:
        """Run ``members`` producing ``needed & writes``: one K7 launch
        when the run lowers; else bisect, down to plain runs of fewer than
        4 members."""
        from .processors import _cuda
        from .processors._tile_program import LoweringError, count_split

        reads_fn = self.proc_chain._step_env_reads
        ext: set = set()
        written: set = set()
        for m in members:
            ext |= reads_fn(m) - written
            written |= _step_writes(m)
        escapes = sorted(needed & written)
        vals = {k: env[k] for k in ext if k in env}
        if len(vals) == len(ext):
            try:
                prog = self._program(members, vals, escapes)
            except LoweringError as e:
                count_split(self, members, e)
                prog = None
            if prog is not None:
                return _cuda.generic_rows(prog, vals)
            if len(members) >= 4:
                mid = len(members) // 2
                first, second = members[:mid], members[mid:]
                needed1 = set(needed)
                for m in second:
                    needed1 |= reads_fn(m)
                out1 = self._exec(first, env, needed1)
                out2 = self._exec(second, {**env, **out1}, needed)
                return {**out1, **out2}
        return self._run_members(members, vals, escapes)

    def run(self, env: dict) -> None:
        if any(k not in env for k in self.ext_in):
            env.update(self._run_members(
                self.members, {k: env[k] for k in self.ext_in if k in env},
                self.escapes,
            ))
            return
        outs = self._exec(self.members, env, set(self.escapes))
        env.update({k: outs[k] for k in self.escapes if k in outs})

    def __str__(self) -> str:
        return self.name


# ---------------------------------------------------------------------------
# ProcessingChain
# ---------------------------------------------------------------------------

# AST operators of the expression sub-language (reference :46-59)
ast_ops_dict = {
    ast.Add: (np.add, "{}+{}"),
    ast.Sub: (np.subtract, "{}-{}"),
    ast.Mult: (np.multiply, "{}*{}"),
    ast.Div: (np.divide, "{}/{}"),
    ast.FloorDiv: (np.floor_divide, "{}//{}"),
    ast.USub: (np.negative, "-{}"),
    ast.Lt: (np.less, "{}<{}"),
    ast.LtE: (np.less_equal, "{}<={}"),
    ast.Gt: (np.greater, "{}>{}"),
    ast.GtE: (np.greater_equal, "{}>={}"),
    ast.Eq: (np.equal, "{}=={}"),
    ast.NotEq: (np.not_equal, "{}!={}"),
}


class _Cut(NamedTuple):
    """How a chunk was cut for a mesh or flattened from stacked batch dims
    (:meth:`ProcessingChain._cut_chunk`): the chunk's batch dims (padded),
    this rank's block of them, the chunk's events along the last, and the
    inputs cut to this rank's block of samples."""

    lead: tuple
    local_lead: tuple
    n: int
    split: frozenset


class EndExecute(Exception):
    """Raised by input managers when the input buffer is exhausted."""


class ProcessingChain:
    """A compiled sequence of DSP transforms over batched waveform tables.

    Front-end API matches the reference (``processing_chain.py:380-716``):
    ``add_variable`` / ``set_constant`` / ``link_input_buffer`` /
    ``add_processor`` / ``link_output_buffer`` / ``execute`` / ``__call__``.
    Back-end: the step list runs eagerly on ``device`` over whole chunks of
    events, instead of an interpreted 16-event block loop.

    ``device`` defaults to CUDA (:mod:`.config`); asking for CUDA without a
    card raises.
    """

    def __init__(self, block_width: int = 8, buffer_len: int = None,
                 device=None) -> None:
        self._vars_dict: dict[str, ProcChainVar] = {}
        self._steps: list[Step] = []
        self._input_managers: dict[str, Any] = {}
        self._output_managers: dict[str, Any] = {}
        self._block_width = block_width  # kept for API parity; chunks batch
        self._buffer_len = buffer_len
        self.device = config.resolve_device(device)
        # grid of the first linked waveform input: last-resort fallback for
        # unitted-scalar conversion when a processor has no gridded array arg
        # (e.g. const kernel generators like cusp_filter taking tau/period)
        self._default_grid: CoordinateGrid | None = None
        # constant variables on the device, rebuilt when the steps change
        self._consts: dict | None = None
        self.time_total = 0.0
        # the steps as they run (:meth:`_run_plan`), keyed by the step list
        self._plan: list | None = None
        self._plan_key = None
        # opt-in checked mode (the JAX package's :1184-1191): kernels with
        # data-dependent DSPFatal conditions in the reference emit per-event
        # int32 flag columns, scanned on the host after every chunk
        # (set_checked / build_dsp checked=True / DSPEED_TPU_CHECKED=1)
        self._checked = os.getenv("DSPEED_TPU_CHECKED", "0") not in (
            "0", "", "false"
        )
        self._check_steps: list[tuple[str, Step]] = []
        # set_sharding: a DeviceMesh, the axes the batch dims lie over and
        # the axis the samples are split over
        self._mesh = None
        self._batch_axes: tuple[str, ...] = ("data",)
        self._sample_axis: str | None = None

    def set_checked(self, checked: bool = True) -> None:
        """Enable/disable checked mode (data-dependent ``DSPFatal`` parity;
        the JAX package's ``set_checked``, :1193).

        The reference raises in-kernel on bad per-event *data* (``get``
        index out of range, non-integral or out-of-range search starts,
        non-integral pick-off indices) and production halts with the
        waveform range. By default those events become NaN here (the
        chain-wide convention). With checked mode on, every kernel that
        declares a ``checker`` emits an int32 flag column, copied to the
        host with the outputs and scanned by :meth:`raise_data_errors`,
        which raises ``DSPFatal`` with the reference's message, the
        processor string and the exact ``wf_range``. Generic fusion groups
        run member by member while checked (no K7 launch), so every
        member's checker runs; the groups and their K7 tapes stay, and
        ``set_checked(False)`` runs them again."""
        self._checked = bool(checked)
        self._plan_key = None

    def raise_data_errors(self, results: dict, offset: int = 0) -> None:
        """Scan fetched check-flag columns; raise ``DSPFatal`` for the first
        flagged event of the earliest flagged step (the reference's rule:
        the first failing processor aborts the block)."""
        for key, step in self._check_steps:
            flag = results.get(key)
            if flag is None:
                continue
            flag = np.asarray(flag).reshape(-1)
            nz = np.nonzero(flag)[0]
            if nz.size == 0:
                continue
            idx = int(nz[0])
            code = int(flag[idx])
            msg = step.kernel.check_messages.get(
                code, f"data-dependent error (code {code})"
            )
            err = DSPFatal(msg)
            err.processor = str(step)
            err.wf_range = (offset + idx, offset + idx)
            raise err

    def set_sharding(self, mesh, batch_axes=("data",), sample_axis=None) -> None:
        """Shard execution over a
        :class:`~torch.distributed.device_mesh.DeviceMesh` (the JAX package's
        ``set_sharding``, :1234; ``None`` undoes it).

        Each rank runs the chain on its contiguous block of each chunk's
        rows, taken along the mesh axes of ``batch_axes`` (events over
        ``"data"``; a stacked ``(C, B, ...)`` chunk of
        :func:`~dspeed_tpu_torch.parallel.build_dsp_stacked` over
        ``("channel", "data")``, flattened to rows). The last batch dim is
        padded to a multiple of its axis's size. The outputs (and checked
        mode's flags) are gathered back, one collective per output dtype
        plane and batch axis, so every rank's output managers see the whole
        chunk, equal to the unsharded chain's. Fusion groups (K7) run on
        each rank's rows.

        ``sample_axis`` also splits the samples of the waveform-length
        inputs over that axis (the rule of the JAX package's
        ``_shard_inputs``, :2662). The 'same' convolutions take the
        halo-exchange route on the blocks
        (:func:`~dspeed_tpu_torch.parallel.sp_convolve_same_traced`); any
        other step that reads a split plane gets it gathered along the
        samples first, and a fusion group that reads one runs member by
        member (as the JAX package runs a group's body under a mesh).
        """
        if mesh is not None:
            names = tuple(mesh.mesh_dim_names or ())
            for ax in (*batch_axes, *(() if sample_axis is None else (sample_axis,))):
                if ax not in names:
                    raise ProcessingChainError(
                        f"set_sharding: the mesh has no axis {ax!r} ({names})")
            if torch.device(mesh.device_type).type != self.device.type:
                raise ProcessingChainError(
                    f"set_sharding: a {mesh.device_type} mesh for a chain on "
                    f"{self.device}")
        self._mesh = mesh
        self._batch_axes = tuple(batch_axes)
        self._sample_axis = sample_axis if mesh is not None else None

    def _run_plan(self) -> list:
        """The steps as they run: the step list, with each fusion group
        expanded into its members while checked (the JAX package's
        ``_build_fn``, :2859-2882), and each step whose kernel declares a
        checker given its flag key (``_check_steps``)."""
        key = (self._checked, tuple(map(id, self._steps)))
        if self._plan_key == key:
            return self._plan
        for s in self._steps:  # groups' members too: unchecked, they run in K7
            for m in (s, *getattr(s, "members", ())):
                if isinstance(m, KernelStep):
                    m.check_key = None
        steps = list(self._steps)
        self._check_steps = []
        if self._checked:
            steps = [m for s in steps
                     for m in (s.members if isinstance(s, GroupStep) else [s])]
            for i, step in enumerate(steps):
                if isinstance(step, KernelStep) and step.kernel.checker is not None:
                    step.check_key = f"__check__{i}"
                    self._check_steps.append((step.check_key, step))
        self._plan, self._plan_key = steps, key
        return steps

    # -- fusion pass -------------------------------------------------------

    def optimize_fusions(self, generic_only: bool = False) -> list[str]:
        """Substitute fused kernels for their canonical step patterns.

        Patterns are matched on the *built* step list so any config spelling
        that produces them fuses — including the reference's unmodified icpc
        JSON. The passes run in the JAX package's order
        (``dspeed_tpu/processing_chain.py:1258``), the pattern-free
        :meth:`_fuse_generic` last; ``generic_only`` runs only the CSE and
        the generic pass (the JAX package's ``DSPEED_TPU_FUSE=generic``).
        A matcher's exception propagates: a dead matcher must not pass for
        an unfusable chain.

        - step-level CSE first, so duplicated computations (the reference's
          own icpc config runs the 10us/3.008us trapezoid twice) collapse
          before any pattern matches them;
        - energy front: ``pole_zero(bl_subtract(w, b), tau)`` -> trapezoids
          -> ``amax`` (plus the raw ``min_max`` and static-slice
          ``linear_slope_fit`` steps) becomes one
          :func:`~dspeed_tpu_torch.processors.fused_energy_front` step
          (kernel K1 on the card; the plain version composes the original
          kernel bodies, so CPU results match the unfused chain);
        - threshold cascade: >=3 chained ``time_point_thresh`` steps sharing
          a waveform and a scaled threshold base become one
          :func:`~dspeed_tpu_torch.processors.chained_time_point_thresh`
          step (kernel K2; bit-identical links);
        - current front: ``upsampler -> moving_window_multi -> min_max``
          becomes one :func:`~dspeed_tpu_torch.processors.fused_current_front`
          step (kernel K5, or K6 where the polyphase plan does not hold; the
          upsampled current is never written out);
        - t0 front: ``convolve_wf('same') -> min_max ->
          time_point_thresh(..., 0)`` becomes one
          :func:`~dspeed_tpu_torch.processors.fused_t0_front` step (kernel
          K3; the filtered waveform is never written out), absorbing the A/E
          current ``windower(w, tp_0) -> avg_current`` where it can;
        - conv bank: parallel constant-kernel convolutions of one array (the
          CUSP + ZAC pair) share one window read
          (:func:`~dspeed_tpu_torch.processors.fused_conv_bank`, kernel K4);
        - generic: maximal runs of tile-safe steps the patterns left become
          :class:`GroupStep`\\ s (kernel K7).

        Returns the list of substitutions applied (for logging/tests).
        """
        applied = []
        # each helper substitutes one pattern instance per call: iterate to
        # a fixpoint so chains with several energy fronts fuse them all
        # (bounded by the step count)
        fuses = (
            self._cse_steps,
            self._fuse_energy_front,
            self._fuse_tp_cascade,
            # before the t0 front: its absorption of the current counts
            # the current's readers, which this pass reduces to one
            self._fuse_current_front,
            self._fuse_t0_front,
            self._fuse_conv_bank,
            self._fuse_generic,
        )
        if generic_only:
            fuses = (self._cse_steps, self._fuse_generic)
        for fuse in fuses:
            for _ in range(len(self._steps)):
                got = fuse()
                if not got:
                    break
                applied += got
        if applied:
            self._prune_dead_steps()
            applied += self._thread_nan_masks()
            log.debug("fusion pass applied: %s", applied)
        return applied

    def _hand_kernel_plane(self, spec) -> bool:
        """Whether a hand pattern (K1 to K6) may fuse over the plane of the
        argument ``spec``. On the card the hand kernels take float32 planes
        only, so a chain over float64 waveforms runs its unfused processors
        in float64 there; the CPU fuses any dtype, with the plain versions."""
        return self.device.type != "cuda" or np.dtype(spec.dtype) == np.float32

    @staticmethod
    def _kname(step):
        return getattr(getattr(step, "kernel", None), "__name__", None)

    @staticmethod
    def _env_key(spec):
        return spec.key if spec.kind == "env" else None

    @staticmethod
    def _const_scalar(spec):
        if spec.kind != "const" or spec.value is None:
            return None
        v = np.asarray(spec.value)
        return v[()] if v.ndim == 0 else None

    def _trap_spec_of(self, step, pz_key):
        """(spec tuple, out var) when ``step`` is a const-parameter trapezoid
        reading ``pz_key``; None otherwise."""
        name = self._kname(step)
        if name == "trap_norm" and self._env_key(step.arg_specs[0]) == pz_key:
            rise = self._const_scalar(step.arg_specs[1])
            flat = self._const_scalar(step.arg_specs[2])
            if rise is not None and flat is not None:
                return ("norm", int(rise), int(flat))
        if (
            name == "asym_trap_filter"
            and self._env_key(step.arg_specs[0]) == pz_key
        ):
            vals = [self._const_scalar(s) for s in step.arg_specs[1:4]]
            if all(v is not None for v in vals):
                return ("asym", int(vals[0]), int(vals[1]), int(vals[2]))
        return None

    def _fuse_energy_front(self) -> list[str]:
        from .processors import fused_energy_front

        steps = self._steps
        # blsub sources: a bl_subtract step, or a previously fused energy
        # front that emits wf_blsub (its bl_subtract is already consumed) —
        # a second pole-zero branch chains off either
        for i, bls in enumerate(steps):
            name = self._kname(bls)
            if name == "bl_subtract" and len(bls.out_specs) == 1:
                x_key = bls.out_specs[0].key
                is_bls = True
            elif name == "fused_energy_front" and getattr(
                bls.kernel, "emits_blsub", False
            ):
                x_key = bls.out_specs[-1].key
                is_bls = False
            else:
                continue
            for j in range(i + 1, len(steps)):
                pz = steps[j]
                if (
                    self._kname(pz) != "pole_zero"
                    or len(pz.arg_specs) != 2
                    or self._env_key(pz.arg_specs[0]) != x_key
                    or not self._hand_kernel_plane(pz.arg_specs[0])
                ):
                    continue
                tau = self._const_scalar(pz.arg_specs[1])
                if tau is None:
                    continue
                pz_key = pz.out_specs[0].key

                # every const-parameter trapezoid hanging off this pole-zero
                traps = []  # (idx, step, spec)
                for k in range(j + 1, len(steps)):
                    spec = self._trap_spec_of(steps[k], pz_key)
                    if spec is not None:
                        traps.append((k, steps[k], spec))
                if not traps:
                    continue
                # spec-identical traps share ONE kernel output (the fused
                # kernel would write the same full-length array twice);
                # duplicates become env aliases of the kept output
                uniq = []  # (idx, step, spec) — first occurrence per spec
                upos: dict = {}  # spec -> position in uniq
                aliases = []  # (dup step, kept step)
                for rec in traps:
                    if rec[2] in upos:
                        aliases.append((rec[1], uniq[upos[rec[2]]][1]))
                    else:
                        upos[rec[2]] = len(uniq)
                        uniq.append(rec)
                # EVERY amax over any of these traps becomes an in-kernel
                # reduction output of the fused kernel (each unfused amax
                # re-reads a full waveform-sized array from device memory)
                am_steps = []  # (step idx, amax step, unique trap pos)
                trap_key_pos = {
                    t[1].out_specs[0].key: upos[t[2]] for t in traps
                }
                for a, am in enumerate(steps):
                    if (
                        self._kname(am) == "amax"
                        and len(am.out_specs) == 1
                        and self._env_key(am.arg_specs[0]) in trap_key_pos
                    ):
                        am_steps.append(
                            (a, am, trap_key_pos[self._env_key(am.arg_specs[0])])
                        )
                if not am_steps:
                    continue
                specs = [t[2] for t in uniq]
                emax_for = [rec[2] for rec in am_steps]
                # conservative slot for the reader-position guards below:
                # the fused step lands at i (emit) or j (no emit); requiring
                # readers after j is safe for both
                fused_pos = j
                # a min_max of the RAW waveform (the same array this front
                # reads) is four more in-kernel reductions: absorb it when
                # every reader of its outputs sits after the fused slot
                mm_step = None
                w_par = bls.params[0]
                if isinstance(w_par, ProcChainVar):
                    for a2, st2 in enumerate(steps):
                        if (
                            self._kname(st2) == "min_max"
                            and len(st2.out_specs) == 4
                            and len(st2.arg_specs) == 1
                            and self._env_key(st2.arg_specs[0]) == w_par.key
                        ):
                            mm_keys = {s.key for s in st2.out_specs}
                            early = any(
                                p2 != a2
                                and p2 < fused_pos
                                and mm_keys
                                & set(self._step_env_reads(s2) or ())
                                for p2, s2 in enumerate(steps)
                            )
                            if not early:
                                mm_step = st2
                            break
                # linear_slope_fit steps over static slices of blsub/pz
                # (baseline and tail fits) are 4 more in-kernel reductions
                # each; absorb when the slice feeds only the fit and every
                # reader of the fit outputs sits after the fused slot
                n_src = (
                    bls.out_specs[0] if is_bls else bls.out_specs[-1]
                ).shape[-1]
                src_of = {x_key: 0, pz_key: 1}
                slope_recs = []  # (slice step, fit step, (src, a0, b0))
                reads = self._env_read_counts()
                for sst in steps:
                    if (
                        not isinstance(sst, SliceStep)
                        or sst.src_key not in src_of
                        or not isinstance(sst.sl, slice)
                        or sst.sl.step not in (None, 1)
                    ):
                        continue
                    a0, b0, _ = sst.sl.indices(n_src)
                    if b0 <= a0 or reads.get(sst.out_key, 0) != 1:
                        continue
                    fit = next(
                        (
                            s2
                            for s2 in steps
                            if self._kname(s2) == "linear_slope_fit"
                            and len(s2.out_specs) == 4
                            and len(s2.arg_specs) == 1
                            and self._env_key(s2.arg_specs[0]) == sst.out_key
                        ),
                        None,
                    )
                    if fit is None:
                        continue
                    fit_keys = {s.key for s in fit.out_specs}
                    early = any(
                        s2 is not fit
                        and p2 < fused_pos
                        and fit_keys & set(self._step_env_reads(s2) or ())
                        for p2, s2 in enumerate(steps)
                    )
                    if not early:
                        slope_recs.append(
                            (sst, fit, (src_of[sst.src_key], a0, b0))
                        )
                # a trapezoid with NO amax whose ONLY reader is a
                # time_point_thresh against one of the absorbed slope
                # outputs (the flagship's tp_0_atrap vs bl_std) emits a
                # uint8 crossing BITMASK instead of its full f32 plane;
                # the search finishes on the bitmask (tp_from_cross_mask,
                # bit-identical) — a 4x smaller write and no full-array
                # search downstream
                slope_out_pos = {}
                for si2, (_, fit2, _) in enumerate(slope_recs):
                    for oi2, sp2 in enumerate(fit2.out_specs):
                        slope_out_pos[sp2.key] = (si2, oi2)
                alias_n: dict = {}
                for rec in traps:
                    alias_n[rec[2]] = alias_n.get(rec[2], 0) + 1
                mask_recs = []  # (uniq pos, tpt step, walk, (si, oi))
                emax_pos = {rec[2] for rec in am_steps}
                for ui, (t_idx, t_step, t_spec) in enumerate(uniq):
                    if (
                        not slope_out_pos
                        or ui in emax_pos
                        or alias_n.get(t_spec, 0) != 1
                    ):
                        continue
                    t_key = t_step.out_specs[0].key
                    if reads.get(t_key, 0) != 1:
                        continue
                    tpt = next(
                        (
                            s2
                            for s2 in steps
                            if self._kname(s2) == "time_point_thresh"
                            and len(s2.arg_specs) == 4
                            and len(s2.out_specs) == 1
                            and self._env_key(s2.arg_specs[0]) == t_key
                            and self._env_key(s2.arg_specs[1])
                            in slope_out_pos
                        ),
                        None,
                    )
                    if tpt is None:
                        continue
                    walk = self._const_scalar(tpt.arg_specs[3])
                    if walk is None or int(walk) not in (0, 1):
                        continue
                    mask_recs.append(
                        (
                            ui, tpt, int(walk),
                            slope_out_pos[self._env_key(tpt.arg_specs[1])],
                        )
                    )
                mask_claimed = {rec[0] for rec in mask_recs}
                remap = {}
                for ui in range(len(uniq)):
                    if ui not in mask_claimed:
                        remap[ui] = len(remap)
                plane_uniq = [
                    u for ui, u in enumerate(uniq) if ui not in mask_claimed
                ]
                mask_specs = [
                    (uniq[ui][2], si2, oi2, walk == 1, walk == 0)
                    for ui, _tpt, walk, (si2, oi2) in mask_recs
                ]

                # wf_blsub read by anything besides this pole_zero and the
                # absorbed slope-fit slices (CUSP/ZAC slices, output
                # managers): emit it from the fused kernel — the row is
                # already resident — and delete the separate bl_subtract
                # step's full waveform re-read. (Chaining off an earlier
                # front: blsub is already emitted there, so this front
                # recomputes it, emitting nothing.)
                absorbed_x = sum(
                    1 for sst, _, _ in slope_recs if sst.src_key == x_key
                )
                emit = (
                    is_bls
                    and reads.get(x_key, 0) - 1 - absorbed_x > 0
                )
                kern = fused_energy_front(
                    float(tau), [u[2] for u in plane_uniq],
                    [remap[rec[2]] for rec in am_steps], emit_blsub=emit,
                    emit_minmax=mm_step is not None,
                    slope_specs=[r[2] for r in slope_recs],
                    mask_specs=mask_specs,
                )
                mask_vars = []
                for ui, _tpt, _walk, _so in mask_recs:
                    base = uniq[ui][1].out_specs[0].var
                    mask_vars.append(
                        self.add_variable(
                            f"__crossmask_{len(self._vars_dict)}",
                            dtype=np.dtype("uint8"),
                            shape=tuple(base.shape),
                        )
                    )
                params = (
                    [bls.params[0], bls.params[1], pz.out_specs[0].var]
                    + [u[1].out_specs[0].var for u in plane_uniq]
                    + [rec[1].out_specs[0].var for rec in am_steps]
                )
                for _, fit, _spec in slope_recs:
                    params += [s.var for s in fit.out_specs]
                if mm_step is not None:
                    params += [s.var for s in mm_step.out_specs]
                if emit:
                    params.append(bls.out_specs[0].var)
                params += mask_vars
                fused = KernelStep(self, kern, params, {})
                dead = sorted(
                    {
                        *(rec[0] for rec in am_steps),
                        *(t[0] for t in traps),
                    },
                    reverse=True,
                )
                for idx in dead:
                    del steps[idx]
                if emit:
                    # the fused step takes bl_subtract's slot so readers of
                    # wf_blsub between it and the pole_zero stay downstream
                    del steps[j]
                    steps[i] = fused
                    at = i
                else:
                    steps[j] = fused
                    at = j
                for dup, kept in aliases:
                    steps.insert(
                        at + 1,
                        AliasStep(
                            kept.out_specs[0].key, dup.out_specs[0].key
                        ),
                    )
                if mm_step is not None:
                    steps.remove(mm_step)
                for sst, fit, _spec in slope_recs:
                    steps.remove(sst)
                    steps.remove(fit)
                if mask_recs:
                    from .processors.time_point_thresh import (
                        tp_from_cross_mask,
                    )

                    for (ui, tpt, walk, _so), mv in zip(
                        mask_recs, mask_vars
                    ):
                        pos_t = steps.index(tpt)
                        steps[pos_t] = KernelStep(
                            self,
                            tp_from_cross_mask(walk),
                            [mv, tpt.params[2], tpt.out_specs[0].var],
                            {},
                        )
                return [
                    f"fused_energy_front[{len(plane_uniq)}"
                    + (f"+{len(mask_recs)}m]" if mask_recs else "]")
                ]
        return []

    def _env_read_counts(self):
        """env key -> number of reading sites (steps + output managers)."""
        counts: dict = {}
        for step in self._steps:
            for k in self._step_env_reads(step) or ():
                counts[k] = counts.get(k, 0) + 1
        for man in self._output_managers.values():
            for k in man.out_keys():
                counts[k] = counts.get(k, 0) + 1
        return counts

    def _fuse_conv_bank(self) -> list[str]:
        """Parallel constant-kernel convolutions of one array (same kernel
        length, same mode window) become one
        :func:`~dspeed_tpu_torch.processors.fused_conv_bank` step, so the
        input window — the dominant read for long-tap short-output filters
        like the CUSP + ZAC energy pair — is fetched once for the whole
        bank."""
        from .processors import fused_conv_bank
        from .processors.convolutions import _MATMUL_MAC_LIMIT, _mode_window

        # the bank replaces the banded route only: convs the router would
        # run direct (short taps) or via FFT stay unfused
        steps = self._steps
        # duplicate SliceSteps of the same source produce distinct env keys
        # for identical arrays; canonicalize conv inputs through them
        slice_src = {
            s.out_key: (s.src_key, str(s.sl))
            for s in steps
            if isinstance(s, SliceStep)
        }
        slice_step = {s.out_key: s for s in steps if isinstance(s, SliceStep)}
        groups: dict = {}
        for i, st in enumerate(steps):
            if self._kname(st) not in ("convolve_wf", "fft_convolve_wf"):
                continue
            if len(st.arg_specs) != 3 or len(st.out_specs) != 1:
                continue
            if not self._hand_kernel_plane(st.arg_specs[0]):
                continue
            k_spec = st.arg_specs[1]
            if (
                k_spec.kind != "const"
                or not isinstance(k_spec.value, np.ndarray)
                or k_spec.value.ndim != 1
            ):
                continue
            in_key = self._env_key(st.arg_specs[0])
            mode = self._const_scalar(st.arg_specs[2])
            if in_key is None or mode is None:
                continue
            d = st.dims
            if d["p"] * d["m"] > _MATMUL_MAC_LIMIT:
                continue  # the router would pick the FFT path anyway
            if d["m"] <= 32:
                continue  # the router would run these direct
            src = slice_src.get(in_key, (in_key, None))
            key = (src, chr(int(mode)), d["n"], d["m"], d["p"])
            groups.setdefault(key, []).append((i, st))
        for (src, ch, n, m, p), recs in groups.items():
            if len(recs) < 2:
                continue
            lo, _ = _mode_window(ch, n, m)
            i0, st0 = recs[0]
            in_param = st0.params[0]
            n_in = None
            # absorb a leading [0:n] view: pass the unsliced source with an
            # effective length instead — the kernel then reads only the
            # first n columns and the engine's slice goes dead
            sstep = slice_step.get(self._env_key(st0.arg_specs[0]))
            if sstep is not None:
                sl = sstep.sl
                if (
                    isinstance(sl, slice)
                    and sl.start in (None, 0)
                    and sl.step in (None, 1)
                    and isinstance(sl.stop, int)
                    and sl.stop == n
                ):
                    in_param = sstep.src
                    n_in = n
            kern = fused_conv_bank(
                [st.arg_specs[1].value for _, st in recs], lo, p, n_in=n_in
            )
            fused = KernelStep(
                self,
                kern,
                [in_param] + [st.out_specs[0].var for _, st in recs],
                {},
            )
            for idx, _ in sorted(recs[1:], reverse=True):
                del steps[idx]
            steps[i0] = fused
            return [f"fused_conv_bank[{len(recs)}]"]
        return []

    def _fuse_current_front(self) -> list[str]:
        """``upsampler(int ratio) -> moving_window_multi(const) -> min_max``,
        with the intermediates unread elsewhere, becomes one
        :func:`~dspeed_tpu_torch.processors.fused_current_front` step (kernel
        K5 or K6 on the card; the upsampled current is never written out)."""
        from .processors import fused_current_front

        steps = self._steps
        reads = None
        for i, ups in enumerate(steps):
            if (
                self._kname(ups) != "upsampler"
                or len(ups.out_specs) != 1
                or len(ups.arg_specs) != 2
                or not self._hand_kernel_plane(ups.arg_specs[0])
            ):
                continue
            ratio = self._const_scalar(ups.arg_specs[1])
            if ratio is None or float(ratio) != int(ratio) or int(ratio) <= 0:
                continue
            ratio = int(ratio)
            up_key = ups.out_specs[0].key
            c_var = ups.params[0]
            if not isinstance(c_var, ProcChainVar) or not c_var.shape:
                continue
            n_curr = int(c_var.shape[-1])
            n_up = int(ups.out_specs[0].shape[-1])
            # the fused kernels require every output slot written (no NaN
            # padding from the replication map)
            if ratio // 2 + n_up > n_curr * ratio:
                continue
            for j in range(i + 1, len(steps)):
                mwm = steps[j]
                if (
                    self._kname(mwm) != "moving_window_multi"
                    or len(mwm.arg_specs) != 4
                    or self._env_key(mwm.arg_specs[0]) != up_key
                ):
                    continue
                length = self._const_scalar(mwm.arg_specs[1])
                num = self._const_scalar(mwm.arg_specs[2])
                mtype = self._const_scalar(mwm.arg_specs[3])
                if None in (length, num, mtype):
                    continue
                if (
                    float(length) != int(length)
                    or not (0 <= int(length) <= min(128, n_up - 1))
                    or float(num) != int(num)
                    or int(num) < 0
                    or int(mtype) not in (0, 1, 2)
                ):
                    continue
                av_key = mwm.out_specs[0].key
                for k in range(j + 1, len(steps)):
                    mm = steps[k]
                    if (
                        self._kname(mm) != "min_max"
                        or self._env_key(mm.arg_specs[0]) != av_key
                        or len(mm.out_specs) != 4
                    ):
                        continue
                    if reads is None:
                        reads = self._env_read_counts()
                    # intermediates must feed only this pipeline
                    if reads.get(up_key, 0) != 1 or reads.get(av_key, 0) != 1:
                        continue
                    # dead-output elision: min_max outputs with no readers
                    # (not chain outputs, read by no step) skip their
                    # reductions in the kernels
                    need = tuple(
                        reads.get(s.key, 0) > 0 for s in mm.out_specs
                    )
                    kern = fused_current_front(
                        n_up, ratio, int(length), int(num), int(mtype),
                        need=need,
                    )
                    fused = KernelStep(
                        self,
                        kern,
                        [c_var] + [s.var for s in mm.out_specs],
                        {},
                    )
                    for idx in sorted((i, j, k), reverse=True):
                        del steps[idx]
                    steps.insert(i, fused)
                    return ["fused_current_front"]
        return []

    def _producer_index(self, key):
        """Index of the step writing ``key`` (None for chain inputs)."""
        for i, st in enumerate(self._steps):
            for spec in getattr(st, "out_specs", ()):
                if spec.key == key:
                    return i
            if getattr(st, "out_key", None) == key:
                return i
            if getattr(st, "dst_key", None) == key:
                return i
        return None

    def _fuse_t0_front(self) -> list[str]:
        """``convolve_wf(w, const_kern, 's')`` -> ``min_max`` ->
        ``time_point_thresh(conv, thr, tp_start, 0)`` with the filtered
        waveform unread elsewhere becomes one
        :func:`~dspeed_tpu_torch.processors.fused_t0_front` step (kernel K3
        on the card): three full-array passes producing five scalars
        collapse into one read of ``w``."""
        from .processors import fused_t0_front

        steps = self._steps
        reads = None
        for i, cv in enumerate(steps):
            if self._kname(cv) not in ("convolve_wf", "fft_convolve_wf"):
                continue
            if len(cv.arg_specs) != 3 or len(cv.out_specs) != 1:
                continue
            if not self._hand_kernel_plane(cv.arg_specs[0]):
                continue
            k_spec = cv.arg_specs[1]
            if (
                k_spec.kind != "const"
                or not isinstance(k_spec.value, np.ndarray)
                or k_spec.value.ndim != 1
                or np.isnan(k_spec.value).any()
            ):
                continue
            mode = self._const_scalar(cv.arg_specs[2])
            if mode is None or chr(int(mode)) != "s":
                continue
            d = cv.dims
            if d["p"] != d["n"] or d["m"] > d["n"]:
                continue
            c_key = cv.out_specs[0].key
            for j in range(i + 1, len(steps)):
                mm = steps[j]
                if (
                    self._kname(mm) != "min_max"
                    or self._env_key(mm.arg_specs[0]) != c_key
                    or len(mm.out_specs) != 4
                ):
                    continue
                tpstart_key = mm.out_specs[1].key
                for k in range(j + 1, len(steps)):
                    tp = steps[k]
                    if (
                        self._kname(tp) != "time_point_thresh"
                        or len(tp.arg_specs) != 4
                        or len(tp.out_specs) != 1
                        or self._env_key(tp.arg_specs[0]) != c_key
                        or self._env_key(tp.arg_specs[2]) != tpstart_key
                    ):
                        continue
                    walk = self._const_scalar(tp.arg_specs[3])
                    if walk is None or int(walk) != 0:
                        continue
                    thr_key = self._env_key(tp.arg_specs[1])
                    if thr_key is None:
                        continue
                    # the threshold must already be computed when the fused
                    # step takes the conv's slot
                    thr_pos = self._producer_index(thr_key)
                    if thr_pos is not None and thr_pos >= i:
                        continue
                    if reads is None:
                        reads = self._env_read_counts()
                    # the filtered waveform must feed only this pipeline
                    if reads.get(c_key, 0) != 2:
                        continue
                    thr_var = next(
                        (
                            p
                            for p in tp.params
                            if isinstance(p, ProcChainVar)
                            and p.key == thr_key
                        ),
                        None,
                    )
                    if thr_var is None:
                        continue
                    # optional A/E current absorption: windower(w, tp_0) ->
                    # avg_current, with the window unread elsewhere — the
                    # fused kernel already holds w and tp_0
                    curr_spec = w_step = a_step = None
                    tp_key = tp.out_specs[0].key
                    in_key = self._env_key(cv.arg_specs[0])
                    for ws in steps:
                        if (
                            self._kname(ws) != "windower"
                            or len(ws.arg_specs) != 2
                            or len(ws.out_specs) != 1
                            or self._env_key(ws.arg_specs[0]) != in_key
                            or self._env_key(ws.arg_specs[1]) != tp_key
                        ):
                            continue
                        wle_key = ws.out_specs[0].key
                        for asx in steps:
                            if (
                                self._kname(asx) != "avg_current"
                                or len(asx.out_specs) != 1
                                or self._env_key(asx.arg_specs[0]) != wle_key
                            ):
                                continue
                            ln = self._const_scalar(asx.arg_specs[1])
                            if (
                                ln is None
                                or float(ln) != int(ln)
                                or int(ln) <= 0
                                or reads.get(wle_key, 0) != 1
                            ):
                                continue
                            curr_spec = (
                                int(ws.out_specs[0].shape[-1]),
                                int(ln),
                                int(asx.out_specs[0].shape[-1]),
                            )
                            w_step, a_step = ws, asx
                            break
                        break
                    # optional pileup-trap absorption: a const-parameter
                    # trapezoid of the SAME waveform whose only reader is a
                    # backward time_point_thresh against the SAME threshold
                    # and start — both the trap plane and the search's full
                    # re-read disappear (on the flagship the energy front
                    # claims this trap first, as a crossing mask)
                    atrap_spec = at_step = at_tp = None
                    for st2 in steps:
                        spec2 = self._trap_spec_of(st2, in_key)
                        if spec2 is None or len(st2.out_specs) != 1:
                            continue
                        t_key = st2.out_specs[0].key
                        if reads.get(t_key, 0) != 1:
                            continue
                        tp2 = next(
                            (
                                s2
                                for s2 in steps
                                if self._kname(s2) == "time_point_thresh"
                                and len(s2.arg_specs) == 4
                                and len(s2.out_specs) == 1
                                and self._env_key(s2.arg_specs[0]) == t_key
                                and self._env_key(s2.arg_specs[1]) == thr_key
                                and self._env_key(s2.arg_specs[2])
                                == tpstart_key
                            ),
                            None,
                        )
                        if tp2 is None:
                            continue
                        walk2 = self._const_scalar(tp2.arg_specs[3])
                        if walk2 is None or int(walk2) != 0:
                            continue
                        atrap_spec, at_step, at_tp = spec2, st2, tp2
                        break
                    # dead-output elision: min_max outputs with no other
                    # readers skip their reductions in the kernel (t_max
                    # and a_max are computed regardless — the absorbed
                    # search needs them; read counts still include the
                    # absorbed steps, which only makes `need` conservative)
                    need = tuple(
                        reads.get(s.key, 0) > 0 for s in mm.out_specs
                    )
                    kern = fused_t0_front(
                        k_spec.value, curr_spec=curr_spec,
                        atrap_spec=atrap_spec, need=need,
                    )
                    fused = KernelStep(
                        self,
                        kern,
                        [cv.params[0], thr_var]
                        + [s.var for s in mm.out_specs]
                        + [tp.out_specs[0].var]
                        + ([a_step.out_specs[0].var] if curr_spec else [])
                        + ([at_tp.out_specs[0].var] if atrap_spec else []),
                        {},
                    )
                    for idx in sorted((i, j, k), reverse=True):
                        del steps[idx]
                    steps.insert(i, fused)
                    if curr_spec is not None:
                        steps.remove(w_step)
                        steps.remove(a_step)
                    if atrap_spec is not None:
                        steps.remove(at_step)
                        steps.remove(at_tp)
                    return ["fused_t0_front"]
        return []

    def _threshold_of(self, a_key):
        """Resolve a threshold env key to ``(factor, base_key, base_var,
        step)``: unwraps one ``const * base`` multiply expression."""
        for step in self._steps:
            if (
                self._kname(step) == "multiply"
                and len(step.out_specs) == 1
                and step.out_specs[0].key == a_key
                and len(step.arg_specs) == 2
            ):
                specs = step.arg_specs
                for c_spec, e_spec in ((specs[0], specs[1]), (specs[1], specs[0])):
                    f = self._const_scalar(c_spec)
                    b = self._env_key(e_spec)
                    if f is not None and b is not None:
                        base_var = next(
                            (
                                p
                                for p in step.params
                                if isinstance(p, ProcChainVar)
                                and p.key == b
                            ),
                            None,
                        )
                        return float(f), b, base_var, step
        return 1.0, a_key, None, None

    def _fuse_tp_cascade(self) -> list[str]:
        """Three or more ``time_point_thresh`` steps over one waveform whose
        thresholds scale one base (``0.99*trapTmax``, ``trapTmax*0.5``,
        ...) and whose starts chain from one ``t_start`` through earlier
        links become one
        :func:`~dspeed_tpu_torch.processors.chained_time_point_thresh`
        step (kernel K2 on the card; bit-identical links)."""
        from .processors import chained_time_point_thresh

        steps = self._steps
        links = []  # (idx, step, w_key, factor, base_key, base_var, dir, s_key)
        for idx, s in enumerate(steps):
            if (
                self._kname(s) != "time_point_thresh"
                or len(s.arg_specs) != 4
                or not self._hand_kernel_plane(s.arg_specs[0])
            ):
                continue
            w_key = self._env_key(s.arg_specs[0])
            a_key = self._env_key(s.arg_specs[1])
            s_key = self._env_key(s.arg_specs[2])
            d = self._const_scalar(s.arg_specs[3])
            if None in (w_key, a_key, s_key) or d is None:
                continue
            factor, base_key, base_var, _mul = self._threshold_of(a_key)
            links.append(
                (idx, s, w_key, factor, base_key, base_var, int(d), s_key)
            )

        # group by (waveform, threshold base)
        groups: dict = {}
        for rec in links:
            groups.setdefault((rec[2], rec[4]), []).append(rec)

        for (w_key, base_key), grp in groups.items():
            if len(grp) < 3:
                continue
            grp.sort(key=lambda r: r[0])
            t_start_key = grp[0][7]
            out_keys = [r[1].out_specs[0].key for r in grp]
            starts = []
            ok = True
            for r in grp:
                if r[7] == t_start_key:
                    starts.append(-1)
                elif r[7] in out_keys and out_keys.index(r[7]) < len(starts):
                    starts.append(out_keys.index(r[7]))
                else:
                    ok = False
                    break
            if not ok:
                continue
            factors = [r[3] for r in grp]
            dirs = [r[6] for r in grp]
            first = grp[0][1]
            w_var = first.params[0]
            base_var = next((r[5] for r in grp if r[5] is not None), None)
            if base_var is None:
                # thresholds reference the base directly (factor 1 links)
                base_var = next(
                    (
                        p
                        for r in grp
                        for p in r[1].params
                        if isinstance(p, ProcChainVar) and p.key == base_key
                    ),
                    None,
                )
            start_var = next(
                (
                    p
                    for p in first.params
                    if isinstance(p, ProcChainVar) and p.key == t_start_key
                ),
                None,
            )
            if base_var is None or start_var is None or not isinstance(
                w_var, ProcChainVar
            ):
                continue
            kern = chained_time_point_thresh(factors, dirs, starts)
            fused = KernelStep(
                self,
                kern,
                [w_var, base_var, start_var]
                + [r[1].out_specs[0].var for r in grp],
                {},
            )
            pos = grp[0][0]
            for idx in sorted((r[0] for r in grp), reverse=True):
                del steps[idx]
            steps.insert(pos, fused)
            return [f"chained_time_point_thresh[{len(grp)}]"]
        return []

    def _cse_steps(self) -> list[str]:
        """Step-level common-subexpression elimination: a ``KernelStep``
        whose kernel, env-key inputs, constant payloads and dims match an
        earlier step recomputes the same arrays — its outputs become
        ``AliasStep``\\ s onto the first occurrence's keys. Env keys are
        single-assignment by construction (every variable/expression gets a
        unique key), so first-match dominance is positional order.

        The reference's own flagship config hits this for real:
        ``tests/configs/icpc-dsp-config.json`` computes the 10us/3.008us
        trapezoid of ``wf_pz`` twice (``wf_trap`` for trapTmax, ``wf_etrap``
        for trapEmax); the reference interpreter runs both
        (reference ``dspeed/processing_chain.py:1144-1163``) — numerically
        the alias is the identical computation, so results are
        bit-identical. Kernels that declare a checked-mode ``checker`` are
        skipped, as in the JAX package (:2316), so each raise site keeps its
        own flag column and step name."""

        def freeze(v):
            if isinstance(v, np.ndarray):
                return ("nd", v.dtype.str, v.shape, v.tobytes())
            if isinstance(v, (list, tuple)):
                return tuple(freeze(x) for x in v)
            if (
                v is None
                or isinstance(v, (int, float, str, bool, bytes, np.generic))
            ):
                return v
            return ("id", id(v))  # unknown payload: identity-only match

        applied: list[str] = []
        seen: dict = {}
        ren: dict = {}  # duplicate out key -> canonical key
        new_steps: list = []

        def canon(k):
            while isinstance(k, str) and k in ren:
                k = ren[k]
            return k

        def rewrite_reads(step):
            # downstream consumers read the canonical key directly — an
            # AliasStep alone would keep e.g. a fused front from claiming
            # the shared plane's amax in-kernel (measured -5.7% fused)
            if isinstance(step, KernelStep):
                for s in it.chain(step.arg_specs, step.kwarg_specs.values()):
                    if s.kind == "env":
                        s.key = canon(s.key)
                if step.badrow_key is not None:
                    step.badrow_key = canon(step.badrow_key)
            elif isinstance(step, ConvertStep):
                step.in_key = canon(step.in_key)
                if isinstance(step.from_offset, str):
                    step.from_offset = canon(step.from_offset)
                if isinstance(step.to_offset, str):
                    step.to_offset = canon(step.to_offset)
            elif isinstance(step, (AliasStep, SliceStep)):
                step.src_key = canon(step.src_key)
            elif isinstance(step, FuncStep):
                step.in_keys = [
                    canon(k) if isinstance(k, str) else k
                    for k in step.in_keys
                ]

        def freeze_sl(sl):
            if isinstance(sl, slice):
                return ("sl", sl.start, sl.stop, sl.step)
            return freeze(sl)

        for step in self._steps:
            rewrite_reads(step)
            if isinstance(step, SliceStep):
                # identical views of one plane (the flagship slices
                # wf_blsub[:1996] once each for CUSP and ZAC)
                key = ("slice", step.src_key, freeze_sl(step.sl))
                prev = seen.get(key)
                if prev is not None:
                    new_steps.append(AliasStep(prev.out_key, step.out_key))
                    ren[step.out_key] = prev.out_key
                    applied.append(f"cse[{step.name}]")
                else:
                    seen[key] = step
                    new_steps.append(step)
                continue
            if (
                not isinstance(step, KernelStep)
                or step.kernel.checker is not None
                or any(sp.var.is_const for sp in step.out_specs)
            ):
                new_steps.append(step)
                continue
            fn = step.kernel.fn
            ident = getattr(fn, "_cse_token", None) or id(fn)
            try:
                key = (
                    ident,
                    step.kernel.signature,
                    tuple(
                        (s.kind, s.key, s.reshape, str(s.dtype),
                         freeze(s.value))
                        for s in step.arg_specs
                    ),
                    tuple(sorted(
                        (k, s.kind, s.key, s.reshape, str(s.dtype),
                         freeze(s.value))
                        for k, s in step.kwarg_specs.items()
                    )),
                    tuple(sorted(step.dims.items())),
                    step.badrow_key,
                    # outputs bind through the vars' dtype/shape casts — a
                    # twin with different output metadata must not merge
                    tuple(
                        (str(sp.dtype), sp.shape) for sp in step.out_specs
                    ),
                )
            except Exception:
                new_steps.append(step)
                continue
            prev = seen.get(key)
            if prev is not None and len(prev.out_specs) == len(step.out_specs):
                for sp_new, sp_old in zip(step.out_specs, prev.out_specs):
                    # keep the key visible (chain outputs, manual readers)
                    new_steps.append(AliasStep(sp_old.key, sp_new.key))
                    ren[sp_new.key] = sp_old.key
                applied.append(f"cse[{step.kernel.__name__}]")
            else:
                seen[key] = step
                new_steps.append(step)
        if applied:
            self._steps[:] = new_steps
        return applied

    # names of expression-parser ufunc kernels that may join a generic
    # group (the JAX package's list, :2169)
    _GENERIC_UFUNC_SAFE = frozenset(
        "add subtract multiply divide true_divide floor_divide negative "
        "less less_equal greater greater_equal equal not_equal logical_and "
        "logical_or logical_not maximum minimum where abs absolute fabs "
        "sqrt exp expm1 log log1p log10 square sign isnan isfinite rint "
        "floor ceil trunc amax amin max min sum mean nanmax nanmin "
        "nansum nanmean power mod remainder".split()
    )

    def _groupable_step(self, step) -> bool:
        """True when a step may join a generic group: views, conversions,
        torch ops and kernels flagged ``tile_safe`` (a bool or a predicate
        of the step), as the JAX package decides (:2178)."""
        if isinstance(step, (AliasStep, SliceStep, ConvertStep)):
            return True
        if isinstance(step, FuncStep):
            mod = getattr(step.fn, "__module__", "") or ""
            return mod == "torch" or mod.startswith("torch.")
        if isinstance(step, KernelStep):
            k = step.kernel
            safe = getattr(k, "tile_safe", False)
            if callable(safe):
                return bool(safe(step))
            if safe:
                return True
            return k.__name__ in self._GENERIC_UFUNC_SAFE
        return False

    def _key_core_ndims(self) -> dict:
        """env key -> core rank (0 scalar, 1 plane, ...); None = chain
        constant; absent = unknown (the JAX package's :2200)."""
        m: dict = {}
        for var in self._vars_dict.values():
            if not isinstance(var, ProcChainVar):
                continue
            if var.is_const and var.const_value is not None:
                m[var.key] = None
            elif var.shape is not auto:
                m[var.key] = len(var.shape)
        for step in self._steps:
            if isinstance(step, KernelStep):
                for sp in step.out_specs:
                    if isinstance(sp.shape, tuple):
                        m[sp.key] = len(sp.shape)
            elif isinstance(step, ConvertStep):
                if step.out_key not in m and step.in_key in m:
                    m[step.out_key] = m[step.in_key]
            elif isinstance(step, AliasStep):
                if step.dst_key not in m and step.src_key in m:
                    m[step.dst_key] = m[step.src_key]
            elif isinstance(step, SliceStep):
                if (
                    step.out_key not in m
                    and step.src_key in m
                    and isinstance(step.sl, slice)
                ):
                    m[step.out_key] = m[step.src_key]
        return m

    def _fuse_generic(self) -> list[str]:
        """Pattern-free fusion (the JAX package's :2364-2452): maximal
        contiguous runs of groupable steps become :class:`GroupStep`\\ s,
        one K7 launch each. Runs after the hand patterns, so it only claims
        their leftovers. A run forms a group only when it elides a live
        internal plane (one that a later member reads and nothing after the
        run needs) and has a known plane input."""
        if not self._output_managers:
            # liveness is seeded from the output managers (as in
            # _prune_dead_steps): without them nothing can be elided
            return []
        steps = self._steps
        core_of = self._key_core_ndims()
        needed = set()
        for man in self._output_managers.values():
            needed.update(man.out_keys())
        reads_fn = self._step_env_reads

        def make_group(members, later_steps):
            written: set = set()
            ext: set = set()
            consumed: set = set()  # keys read by a member after their writer
            for mstep in members:
                r = reads_fn(mstep)
                w = _step_writes(mstep)
                if r is None or w is None:
                    return None
                ext |= r - written
                consumed |= r & written
                written |= w
            later = set(needed)
            unknown_later = False
            for ls in later_steps:
                lr = reads_fn(ls)
                if lr is None:
                    unknown_later = True
                    break
                later |= lr
            escapes = sorted(written) if unknown_later else sorted(
                written & later
            )
            elided = [
                k
                for k in written
                if k not in escapes
                and k in consumed
                and (core_of.get(k) or 0) >= 1
            ]
            if not elided:
                return None
            if not any(core_of.get(k) == 1 for k in ext):
                return None  # no known plane input
            return GroupStep(self, members, sorted(ext), escapes)

        applied: list[str] = []
        # maximal runs of groupable steps, spliced back to front so the
        # indices of earlier runs stay valid
        runs = []
        start = None
        for i, step in enumerate(steps):
            if self._groupable_step(step) and not isinstance(step, GroupStep):
                if start is None:
                    start = i
            else:
                if start is not None and i - start >= 2:
                    runs.append((start, i))
                start = None
        if start is not None and len(steps) - start >= 2:
            runs.append((start, len(steps)))
        for a, b in reversed(runs):
            grp = make_group(steps[a:b], steps[b:])
            if grp is None:
                continue
            steps[a:b] = [grp]
            applied.append(f"fusion_group[{len(grp.members)}]")
        return applied

    def _prune_dead_steps(self) -> None:
        """Remove steps whose outputs nothing reads (e.g. the ``0.99*base``
        multiplies absorbed into a fused cascade). Conservative: a step of
        unknown shape is kept, and pruning only removes known-pure steps."""
        if not self._output_managers:
            # liveness is seeded from the output managers; without them
            # (manual-API chain before link_output_buffer) every step would
            # look dead — skip pruning entirely
            return
        # materialize the lazy output ConvertSteps so their reads count
        for man in self._output_managers.values():
            man.out_keys()
        needed = set()
        for man in self._output_managers.values():
            needed.update(man.out_keys())

        reads = self._step_env_reads  # None = unknown: reads everything

        keep = []
        for step in reversed(self._steps):
            w = _step_writes(step)
            r = reads(step)
            if w is None or r is None or (w & needed) or not isinstance(
                step, (KernelStep, FuncStep, AliasStep, SliceStep)
            ):
                keep.append(step)
                if r is None:
                    needed.update(w or ())
                    # unknown reads: every earlier key may be needed
                    needed.add("*")
                else:
                    needed.update(r)
                continue
            if "*" in needed:
                keep.append(step)
                needed.update(r)
                continue
            log.debug("pruned dead step %s", step)
        self._steps = list(reversed(keep))

    @staticmethod
    def _step_env_reads(step):
        """Env keys a step reads, or None when unknown."""
        if isinstance(step, KernelStep):
            specs = list(step.arg_specs) + list(step.kwarg_specs.values())
            keys = {s.key for s in specs if s.kind == "env"}
            if step.badrow_key is not None:
                keys.add(step.badrow_key)
            return keys
        if isinstance(step, ConvertStep):
            keys = {step.in_key}
            for off in (step.from_offset, step.to_offset):
                if isinstance(off, str):
                    keys.add(off)
            return keys
        if isinstance(step, (AliasStep, SliceStep)):
            return {step.src_key}
        if isinstance(step, FuncStep):
            return {k for k in step.in_keys if isinstance(k, str)}
        if isinstance(step, GroupStep):
            return set(step.ext_in)
        return None

    def _thread_nan_masks(self) -> list[str]:
        """Replace downstream whole-array NaN row reductions with one
        per-event mask read off the fused energy front (VERDICT r2 item 3).

        Every fused-front output is NaN-poisoned exactly on the rows whose
        raw inputs contain a NaN, so ``isnan(<first emax scalar>)`` *is*
        the row-bad mask — computed from a per-event scalar instead of six
        separate ``(B, n)`` HBM reductions. The mask is handed to
        badrow-aware kernels (``Kernel.badrow_arg``) whose masked input it
        exactly describes; ``mask_preserving`` kernels flow it onward.
        Numerics are identical for every row — this removes redundant
        reductions, it does not change any mask.
        """
        steps = self._steps
        fes_i = next(
            (
                i
                for i, s in enumerate(steps)
                if self._kname(s) == "fused_energy_front"
            ),
            None,
        )
        if fes_i is None:
            return []
        fes = steps[fes_i]
        scalar_out = next((sp for sp in fes.out_specs if not sp.shape), None)
        if scalar_out is None:
            return []
        bad_key = f"__badrow__({scalar_out.key})"
        steps.insert(
            fes_i + 1,
            FuncStep(
                torch.isnan, [scalar_out.key], bad_key, f"isnan({scalar_out.key})"
            ),
        )
        masked = {sp.key for sp in fes.out_specs}
        n_mask = getattr(fes.kernel, "n_mask_outputs", 0)
        if n_mask:
            # trailing crossing-bitmask outputs are uint8 (never NaN)
            masked -= {sp.key for sp in fes.out_specs[-n_mask:]}
        if getattr(fes.kernel, "emits_minmax", False):
            # the absorbed raw-waveform min_max quadruple carries a
            # waveform-only NaN mask (a NaN baseline does not poison it),
            # so it must not assert the full bad-row invariant
            nmm = (
                5 if getattr(fes.kernel, "emits_blsub", False) else 4
            ) + n_mask
            lo_mm = len(fes.out_specs) - nmm
            masked -= {sp.key for sp in fes.out_specs[lo_mm : lo_mm + 4]}
        fes_in = {sp.key for sp in fes.arg_specs if sp.kind == "env"}
        applied = []

        # a bl_subtract over the same raw inputs carries the same mask
        # (badrow = isnan-row(waveform) | isnan(baseline)) wherever it sits
        # in the step list, so its output seeds `masked` either way; if
        # nothing reads it before the mask exists, additionally move it
        # after the mask step so it consumes the mask too
        for j in range(fes_i):
            s = steps[j]
            if self._kname(s) != "bl_subtract" or len(s.out_specs) != 1:
                continue
            if {sp.key for sp in s.arg_specs if sp.kind == "env"} <= fes_in:
                out_k = s.out_specs[0].key
                masked.add(out_k)
                read_between = any(
                    out_k in (self._step_env_reads(b) or {out_k})
                    for b in steps[j + 1 : fes_i + 2]
                )
                if not read_between:
                    bls = steps.pop(j)  # badrow FuncStep now at fes_i
                    steps.insert(fes_i + 1, bls)
                    bls.badrow_key = bad_key
                    applied.append("badrow:bl_subtract")
                break

        def const_args_nan_free(step) -> bool:
            for sp in step.arg_specs:
                if sp.kind != "const" or sp.value is None:
                    continue
                v = sp.value
                if isinstance(v, np.ndarray):
                    if np.issubdtype(v.dtype, np.floating) and np.isnan(v).any():
                        return False
                elif isinstance(v, (float, np.floating)) and np.isnan(v):
                    return False
            return True

        start = next(
            i for i, s in enumerate(steps)
            if isinstance(s, FuncStep) and s.out_key == bad_key
        )
        for s in steps[start + 1 :]:
            if isinstance(s, AliasStep):
                if s.src_key in masked:
                    masked.add(s.dst_key)
            elif isinstance(s, SliceStep):
                # poisoned rows are fully NaN, clean rows NaN-free, so any
                # core-dim slice carries the identical row mask
                if s.src_key in masked:
                    masked.add(s.out_key)
            elif isinstance(s, KernelStep) and s.badrow_key is None:
                kern = s.kernel
                ba = getattr(kern, "badrow_arg", None)
                if ba is None or ba >= len(s.arg_specs):
                    continue
                spec = s.arg_specs[ba]
                if spec.kind != "env" or spec.key not in masked:
                    continue
                s.badrow_key = bad_key
                applied.append(f"badrow:{kern.__name__}")
                env_keys = {
                    sp.key
                    for sp in list(s.arg_specs) + list(s.kwarg_specs.values())
                    if sp.kind == "env"
                }
                if (
                    kern.mask_preserving
                    and env_keys <= masked | fes_in
                    and const_args_nan_free(s)
                ):
                    masked.update(sp.key for sp in s.out_specs)
        if applied:
            log.debug("nan-mask threading: %s", applied)
        return applied

    # -- variables ---------------------------------------------------------

    def add_variable(
        self,
        name: str,
        dtype=auto,
        shape=auto,
        grid=auto,
        unit=auto,
        is_coord=auto,
        period=None,
        offset=0,
        vector_len=None,
    ) -> ProcChainVar:
        self._validate_name(name, raise_exception=True)
        if name in self._vars_dict:
            raise ProcessingChainError(name + " is already in variable list")
        if grid is auto and period is not None:
            if isinstance(offset, str):
                offset = self.get_variable(offset, expr_only=True)
            grid = CoordinateGrid(period, offset)
        var = ProcChainVar(
            self, name, shape=shape, dtype=dtype, grid=grid, unit=unit,
            is_coord=is_coord, vector_len=vector_len,
        )
        self._vars_dict[name] = var
        return var

    def set_constant(self, varname: str, val, dtype=None, unit=None) -> ProcChainVar:
        param = self.get_variable(varname)
        if not param.is_const and param.defined:
            raise ProcessingChainError(
                f"{param} is already defined, cannot set_constant"
            )
        param.is_const = True
        if isinstance(val, Quantity):
            unit = val.u
            val = val.m
        val = np.array(val, dtype=dtype)
        param.update_auto(shape=val.shape, dtype=val.dtype, unit=unit, is_coord=False)
        param.const_value = val.astype(param.dtype) if val.dtype != param.dtype else val
        param.defined = True
        self._invalidate()
        log.debug("set constant: %s = %s", param.description(), val)
        return param

    # -- processors --------------------------------------------------------

    def add_processor(
        self, func, *args, signature=None, types=None, coord_grid=None
    ) -> None:
        params = []
        kw_params = {}
        for param in args:
            if isinstance(param, str):
                param = self.get_variable(param)
            if isinstance(param, MutableMapping):
                kw_params.update(param)
            else:
                params.append(param)
        if coord_grid is not None:
            coord_grid = CoordinateGrid(coord_grid)
        step = KernelStep(self, func, params, kw_params, signature, types, coord_grid)
        self._steps.append(step)
        self._invalidate()
        log.debug("added processor: %s", step)

    def _add_step(self, step: Step) -> None:
        self._steps.append(step)
        self._invalidate()
        log.debug("added step: %s", step)

    def _invalidate(self) -> None:
        self._consts = None
        self._plan_key = None

    # -- I/O buffers -------------------------------------------------------

    def link_io_buffer(self, varname: str, buff=None, output: bool = False):
        self._validate_name(varname, raise_exception=True)
        var = self.get_variable(varname, expr_only=True)
        if var is None:
            var = self.add_variable(varname)
        if not isinstance(var, ProcChainVar):
            raise ProcessingChainError(
                "Must link an io buffer to a processing chain variable"
            )
        io_managers = self._output_managers if output else self._input_managers

        if buff is None:
            dtype = var.dtype
            if isinstance(var.grid, CoordinateGrid) and not var.is_coord:
                if var.vector_len is None:
                    buff = lgdo.WaveformTable(
                        size=self._buffer_len, wf_len=var.shape[0], dtype=dtype
                    )
                else:
                    buff = lgdo.WaveformTable(
                        values=lgdo.VectorOfVectors(
                            shape_guess=(self._buffer_len, 0), dtype=dtype
                        )
                    )
            elif var.shape is not auto and len(var.shape) == 0:
                buff = lgdo.Array(shape=(self._buffer_len,), dtype=dtype)
            elif var.vector_len is not None:
                buff = lgdo.VectorOfVectors(
                    shape_guess=(self._buffer_len, 0), dtype=dtype
                )
            elif var.shape is not auto:
                buff = lgdo.ArrayOfEqualSizedArrays(
                    shape=(self._buffer_len, *var.shape), dtype=dtype
                )
            else:
                raise ProcessingChainError(
                    f"{varname} does not exist and no buffer was provided"
                )

        if varname in io_managers:
            io_managers[varname].set_buffer(buff)
            return buff

        if isinstance(buff, np.ndarray):
            man = NumpyIOManager(buff, var, output)
        elif isinstance(buff, lgdo.ArrayOfEqualSizedArrays):
            man = LGDOArrayOfEqualSizedArraysIOManager(buff, var, output)
        elif isinstance(buff, lgdo.VectorOfVectors):
            man = LGDOVectorOfVectorsIOManager(buff, var, output)
        elif isinstance(buff, lgdo.Array):
            man = LGDOArrayIOManager(buff, var, output)
        elif isinstance(buff, lgdo.WaveformTable):
            man = LGDOWaveformIOManager(buff, var, output)
        else:
            raise ProcessingChainError(
                f"Could not link io buffer of unknown type {buff!r}"
            )
        io_managers[varname] = man
        self._invalidate()
        log.debug("added %s buffer: %s", "output" if output else "input", man)
        return buff

    def link_input_buffer(self, varname: str, buff=None):
        return self.link_io_buffer(varname, buff, output=False)

    def link_output_buffer(self, varname: str, buff=None):
        return self.link_io_buffer(varname, buff, output=True)

    # -- execution ---------------------------------------------------------

    def _out_keys(self) -> list[str]:
        return sorted(
            {k for man in self._output_managers.values() for k in man.out_keys()}
        )

    def _const_env(self) -> dict:
        """Constant variables as tensors on the chain's device (built once
        per step list)."""
        if self._consts is None:
            env = {}
            for var in self._vars_dict.values():
                if not var.is_const or var.const_value is None:
                    continue
                v = np.asarray(var.const_value)
                if v.dtype.kind in "biufc":
                    v = v.astype(_NP_FROM_TORCH[_device_dtype(v.dtype)])
                    env[var.key] = torch.from_numpy(
                        np.ascontiguousarray(v)
                    ).to(self.device)
                else:
                    env[var.key] = v
            self._consts = env
        return self._consts

    def _stage(self, inputs: dict):
        """Start one chunk's host -> device copy: each input is copied into
        pinned host memory, then to the card on the device's copy stream
        without blocking. Returns ``(tensors, event)``; the event marks the
        copies' end (None on the CPU).

        The pinned buffers come from PyTorch's caching host allocator,
        which records the event of each copy that reads one and hands the
        buffer out again only once that copy has ended: a chunk staged
        ahead never overwrites one still in flight, and the buffers are
        shared by every chain of the process instead of held by each."""
        host = {k: _host_tensor(v) for k, v in inputs.items()}
        if self.device.type != "cuda":
            return host, None
        with torch.cuda.device(self.device):
            stream = _copy_stream(torch.cuda.current_device())
            pinned = {}
            for k, t in host.items():
                if t.is_pinned():  # a stacked chunk (stage_stacked)
                    pinned[k] = t
                    continue
                pinned[k] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                pinned[k].copy_(t)
            with torch.cuda.stream(stream):
                dev = {k: v.to(self.device, non_blocking=True)
                       for k, v in pinned.items()}
                event = torch.cuda.Event()
                event.record(stream)
        return dev, event

    def _to_device(self, inputs: dict) -> dict:
        """One chunk's inputs on the device, their copy ended."""
        tensors, event = self._stage(inputs)
        if event is not None:
            event.synchronize()
        return tensors

    def _run_steps(self, env: dict, profile: bool = False, split=None) -> dict:
        """Run the steps (:meth:`_run_plan`) over ``env``; with ``profile``,
        each step's wall time (the device synchronized after it) is summed
        into its ``time_total``. ``split``: the env keys that hold this
        rank's block of samples (a chain with a sample axis), kept up to
        date as the steps run (:meth:`_run_sharded_step`)."""
        # an output manager may add its unit conversion on first use
        # (LGDOVectorOfVectorsIOManager): before the steps run, not after
        self._out_keys()
        env.update(self._const_env())
        with torch.no_grad():
            for step in self._run_plan():
                t0 = time.time()
                try:
                    if split:
                        self._run_sharded_step(step, env, split)
                    else:
                        step.run(env)
                except DSPFatal as e:
                    e.processor = str(step)
                    raise
                if profile:
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
                    step.time_total += time.time() - t0
        return env

    def _run_sharded_step(self, step, env: dict, split: set) -> None:
        """Run ``step`` while the planes of ``split`` hold this rank's block
        of samples: a 'same' convolution of such a plane takes the halo
        route (its kernel's ``sample_parallel`` says whether it can) and its
        output stays split; an alias stays split; a fusion group runs
        member by member; any other step gets the split planes it reads
        gathered along the samples first (the counterpart of the
        collectives GSPMD inserts in the JAX package)."""
        from .parallel.mesh import axis_size, gather_samples

        reads = self._step_env_reads(step)
        hit = set(split) if reads is None else reads & split
        if not hit:
            step.run(env)
            return
        if isinstance(step, AliasStep):
            step.run(env)
            split.add(step.dst_key)
            return
        if isinstance(step, GroupStep):
            for m in step.members:
                self._run_sharded_step(m, env, split)
            return
        mesh, axis = self._mesh, self._sample_axis
        sp = getattr(getattr(step, "kernel", None), "sample_parallel", None)
        if (
            sp is not None
            and isinstance(step, KernelStep)
            and step.arg_specs[0].kind == "env"
            and hit == {step.arg_specs[0].key}
        ):
            nsh = axis_size(mesh, axis)
            if sp(step, env, env[step.arg_specs[0].key].shape[-1] * nsh, nsh):
                config.set_sample_sharding((mesh, axis, self._batch_axes))
                step.sample_blocks = nsh
                try:
                    step.run(env)
                finally:
                    config.set_sample_sharding(None)
                    step.sample_blocks = 1
                split.update(_step_writes(step))
                return
        for k in hit:
            env[k] = gather_samples(env[k], mesh, axis)
            split.discard(k)
        step.run(env)

    def _start_fetch(self, env: dict, n: int, cut=None, split=None):
        """Enqueue the chunk's outputs' copy to the host: on the card one
        transfer per dtype, the columns packed side by side with one
        ``torch.cat``, into pinned memory without blocking, then an event.
        Checked mode's flag columns ride in the same planes. A chunk cut for
        a mesh or stacked (``cut``, :meth:`_cut_chunk`; ``n`` is then this
        rank's rows) is packed on the CPU too, and each plane is gathered
        over the batch axes (:func:`~dspeed_tpu_torch.parallel.mesh.gather_rows`)
        after ``split``'s planes are gathered along the samples. Returns the
        in-flight handle that :meth:`fetch` completes."""
        from .parallel.mesh import gather_rows, gather_samples

        keys = self._out_keys() + [k for k, _ in self._check_steps if k in env]
        if split:
            for k in keys:
                if k in split:
                    env[k] = gather_samples(env[k], self._mesh, self._sample_axis)
        ready: dict = {}
        groups: dict = {}
        on_host = self.device.type == "cpu" and cut is None
        for k in keys:
            v = env[k]
            if not isinstance(v, torch.Tensor) or on_host:
                ready[k] = v
            elif v.ndim == 0 or v.shape[0] != n:
                ready[k] = _to_pinned(v) if self.device.type == "cuda" else v
            else:
                groups.setdefault(v.dtype, []).append((k, v))
        packed = []
        for items in groups.values():
            plane = torch.cat([v.reshape(n, -1) for _, v in items], dim=1)
            if cut is not None and self._mesh is not None:
                plane = gather_rows(plane, self._mesh, self._batch_axes,
                                    cut.local_lead)
            if self.device.type == "cuda":
                plane = _to_pinned(plane)
            packed.append((plane, [(k, tuple(v.shape[1:])) for k, v in items]))
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        lead = (n,) if cut is None else cut.lead
        return ready, packed, event, lead, (n if cut is None else cut.n)

    def _gather_inputs(self, start: int, stop: int):
        inputs: dict[str, np.ndarray] = {}
        n = stop - start
        for man in self._input_managers.values():
            arrs, n_avail = man.read(start, stop)
            n = min(n, n_avail)
            inputs.update(arrs)
        if self._input_managers and n < stop - start:
            # clip all arrays to the shortest input
            inputs = {k: v[:n] for k, v in inputs.items()}
        return inputs, n

    def _link_inputs(self, tb_in) -> None:
        # only grow the nominal buffer length: the output buffers are sized
        # for the longest chunk seen
        if self._buffer_len is None or self._buffer_len < len(tb_in):
            self._buffer_len = len(tb_in)
        for varname in list(self._input_managers):
            if varname not in tb_in:
                raise ProcessingChainError(f"Require column {varname} in tb_in")
            self.link_input_buffer(varname, tb_in[varname])

    def _cut_chunk(self, inputs: dict, n: int, nb: int):
        """This rank's part of a chunk whose arrays have ``nb`` leading batch
        dims (the last holding ``n`` events), the batch dims flattened into
        rows. Under a mesh the last batch dim is padded to a multiple of its
        axis's size and each batch dim cut to this rank's block
        (:func:`~dspeed_tpu_torch.parallel.mesh.batch_block`); with a sample
        axis, the waveform-length inputs are cut to this rank's block of
        samples by the JAX package's rule (``_shard_inputs``, :2662-2707:
        the length of a gridded input; a longer auxiliary input stays
        whole). Returns ``(inputs, cut)``."""
        from .parallel.mesh import axis_rank, axis_size, batch_block

        mesh = self._mesh
        lead = next(iter(inputs.values())).shape[:nb]
        local_lead = lead
        if mesh is not None:
            if len(self._batch_axes) != nb:
                raise ProcessingChainError(
                    f"a chain sharded over {self._batch_axes} takes chunks of "
                    f"{len(self._batch_axes)} batch dims, not {nb}"
                )
            p = axis_size(mesh, self._batch_axes[-1])
            pad = -(-lead[-1] // p) * p - lead[-1]
            if pad:
                inputs = {
                    k: np.pad(v, [(0, 0)] * (nb - 1) + [(0, pad)]
                              + [(0, 0)] * (v.ndim - nb))
                    for k, v in inputs.items()
                }
                lead = (*lead[:-1], lead[-1] + pad)
            block = batch_block(mesh, self._batch_axes, lead)
            inputs = {k: v[block] for k, v in inputs.items()}
            local_lead = tuple(sl.stop - sl.start for sl in block)
        rows = int(np.prod(local_lead, dtype=np.int64))
        inputs = {k: v.reshape(rows, *v.shape[nb:]) for k, v in inputs.items()}
        split = set()
        if mesh is not None and self._sample_axis is not None:
            nsh = axis_size(mesh, self._sample_axis)
            s = axis_rank(mesh, self._sample_axis)
            wf_lens = {
                var.shape[-1]
                for var in self._vars_dict.values()
                if isinstance(getattr(var, "grid", None), CoordinateGrid)
                and var.key in inputs
                and inputs[var.key].ndim > 1
                and isinstance(var.shape, tuple) and len(var.shape) > 0
            }
            if not wf_lens:  # no gridded input: the widest array
                wf_lens = {max((v.shape[-1] for v in inputs.values()
                                if v.ndim > 1), default=0)}
            for k, v in list(inputs.items()):
                length = v.shape[-1]
                if (v.ndim > 1 and length in wf_lens and length % nsh == 0
                        and length >= nsh):
                    loc = length // nsh
                    inputs[k] = v[..., s * loc:(s + 1) * loc]
                    split.add(k)
        return inputs, _Cut(tuple(lead), tuple(local_lead), n, frozenset(split))

    def _stage_chunk(self, inputs: dict, n: int, nb: int = 1):
        """:meth:`_stage` of a gathered chunk, cut for the mesh or flattened
        from ``nb`` batch dims first (:meth:`_cut_chunk`); the handle
        :meth:`dispatch` takes."""
        if self._mesh is None and nb == 1:
            return (*self._stage(inputs), n, None)
        inputs, cut = self._cut_chunk(inputs, n, nb)
        return (*self._stage(inputs), n, cut)

    def stage_inputs(self, tb_in):
        """Link ``tb_in``, gather it and start its host -> device copy on
        the copy stream (:meth:`_stage`).

        Returns an opaque ``(tensors, event, n, cut)`` handle for
        :meth:`dispatch`, ``execute(staged=...)`` or ``__call__(...,
        staged=...)``, or ``None`` at the end of input. On a worker thread
        this overlaps chunk ``i+1``'s upload with chunk ``i``'s steps. A
        short chunk runs at its own length: no padding (under a mesh, to a
        multiple of the data axis's size).
        """
        self._link_inputs(tb_in)
        try:
            inputs, n = self._gather_inputs(0, self._buffer_len)
        except EndExecute:
            return None
        if n <= 0:
            return None
        return self._stage_chunk(inputs, n)

    def stage_stacked(self, channels: list, n: int):
        """Stage a stacked chunk: ``channels`` holds one gathered chunk
        (:meth:`_gather_inputs`) of each of ``C`` channel tables, whose
        first ``n`` events are stacked into ``(C, n, ...)`` arrays
        (``build_dsp_stacked``). The chain runs them as ``C * n`` rows
        (under a mesh, its block of them); :meth:`fetch` returns
        ``(C, n, ...)`` arrays. On the card without a mesh the stack is
        written straight into pinned memory, so the chunk is copied on the
        host once, as a flat chunk's staging copies it."""
        if self.device.type == "cuda" and self._mesh is None:
            stacked = {}
            for k in channels[0]:
                parts = [_host_tensor(chunk[k][:n]) for chunk in channels]
                stacked[k] = torch.empty((len(parts), *parts[0].shape),
                                         dtype=parts[0].dtype, pin_memory=True)
                for c, part in enumerate(parts):
                    stacked[k][c].copy_(part)
        else:
            stacked = {k: np.stack([chunk[k][:n] for chunk in channels])
                       for k in channels[0]}
        return self._stage_chunk(stacked, n, nb=2)

    def dispatch(self, staged):
        """Enqueue one staged chunk and return an in-flight handle: the
        compute stream waits on the staging copy's event (each staged
        tensor is recorded on it, so that the allocator does not hand its
        memory back to the copy stream early), then the steps, then the
        outputs' copy to the host (:meth:`_start_fetch`). :meth:`fetch`
        blocks on that copy, so a driver can overlap chunk ``i``'s fetch
        and write with chunk ``i+1``'s steps (the production pipeline in
        :func:`~dspeed_tpu_torch.build_dsp.build_dsp`)."""
        tensors, event, n, cut = staged
        if event is not None:
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(event)
            for t in tensors.values():
                t.record_stream(compute)
        rows = n if cut is None else int(np.prod(cut.local_lead, dtype=np.int64))
        split = set(cut.split) if cut is not None else None
        env = self._run_steps(dict(tensors), split=split)
        return self._start_fetch(env, rows, cut, split)

    def fetch(self, pending) -> dict:
        """Complete a :meth:`dispatch` handle: wait for its copy, unpack
        each dtype group into per-output host arrays (their batch dims as
        the chunk's, cut to its events). Thread-safe: touches no chain
        state beyond the handle."""
        ready, packed, event, lead, n = pending
        if event is not None:
            event.synchronize()
        out = {
            k: v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in ready.items()
        }
        cut = (slice(None),) * (len(lead) - 1) + (slice(0, n),)
        for host, items in packed:
            host = host.numpy()
            c0 = 0
            for k, inner in items:
                c1 = c0 + int(np.prod(inner, dtype=np.int64))
                v = host[:, c0:c1].reshape(*lead, *inner)
                out[k] = v if lead[-1] == n else v[cut]
                c0 = c1
        return out

    def _run_device(self, staged) -> dict:
        """Run and fetch one staged chunk synchronously."""
        t0 = time.time()
        out = self.fetch(self.dispatch(staged))
        self.time_total += time.time() - t0
        return out

    def dispatch_chunk(self, tb_in, staged=None):
        """Link ``tb_in``'s columns, stage (unless ``staged``) and dispatch:
        no output link, no fetch. Returns ``(pending, n)`` (``None, 0`` at
        the end of input). Pair with :meth:`finish_chunk`, which a writer
        thread may run while this thread dispatches the next chunk."""
        if staged is None:
            staged = self.stage_inputs(tb_in)
            if staged is None:
                return None, 0
        return self.dispatch(staged), staged[2]

    def finish_chunk(self, pending, n: int) -> None:
        """Fetch a dispatched chunk, scan its flags (checked mode) and write
        it through the output managers into their linked buffers."""
        t0 = time.time()
        results = self.fetch(pending)
        if self._checked:
            self.raise_data_errors(results, 0)
        for man in self._output_managers.values():
            man.write(results, 0, n)
        self.time_total += time.time() - t0

    def execute(self, start: int = 0, stop: int = None, staged=None) -> None:
        """Run the chain over rows ``[start, stop)`` of the linked buffers;
        ``staged``, a :meth:`stage_inputs` handle, stands for rows ``[0,
        n)`` already on their way to the device."""
        if staged is None:
            if stop is None:
                stop = self._buffer_len
            try:
                inputs, n = self._gather_inputs(start, stop)
            except EndExecute:
                return
            if n <= 0:
                return
            staged = self._stage_chunk(inputs, n)
        else:
            start = 0
        results = self._run_device(staged)
        if self._checked:
            self.raise_data_errors(results, start)
        for man in self._output_managers.values():
            man.write(results, start, start + staged[2])

    def execute_profiled(self, start: int = 0, stop: int = None) -> None:
        """:meth:`execute`, each step's wall time (the device synchronized
        after it) summed into its ``time_total`` for :meth:`get_timing`."""
        if stop is None:
            stop = self._buffer_len
        try:
            inputs, n = self._gather_inputs(start, stop)
        except EndExecute:
            return
        if n <= 0:
            return
        tensors, event, n, cut = self._stage_chunk(inputs, n)
        if event is not None:
            event.synchronize()
        rows = n if cut is None else int(np.prod(cut.local_lead, dtype=np.int64))
        split = set(cut.split) if cut is not None else None
        try:
            env = self._run_steps(dict(tensors), profile=True, split=split)
        except DSPFatal as e:
            e.wf_range = (start, stop)
            raise
        results = self.fetch(self._start_fetch(env, rows, cut, split))
        if self._checked:
            self.raise_data_errors(results, start)
        for man in self._output_managers.values():
            man.write(results, start, start + n)

    def get_timing(self) -> dict[str, float]:
        """Per-step cumulative wall time, filled by :meth:`execute_profiled`
        (the chunk's total is ``self.time_total``)."""
        return {str(step): step.time_total for step in self._steps}

    def __call__(
        self, tb_in: lgdo.Table, out: lgdo.Table = None, staged=None
    ) -> lgdo.Table:
        if staged is None:
            self._link_inputs(tb_in)
        elif self._buffer_len is None or self._buffer_len < len(tb_in):
            self._buffer_len = len(tb_in)
        if out is None:
            out = lgdo.Table(
                {
                    varname: self.link_output_buffer(varname)
                    for varname in self._output_managers
                },
                size=self._buffer_len,
            )
        else:
            for varname in self._output_managers:
                if varname not in out:
                    raise ProcessingChainError(f"Require column {varname} in out")
                self.link_output_buffer(varname, out[varname])
        self.execute(staged=staged)
        return out

    def __str__(self) -> str:
        return (
            "Input variables:\n  "
            + "\n  ".join(str(m) for m in self._input_managers.values())
            + "\nProcessors:\n  "
            + "\n  ".join(str(s) for s in self._steps)
            + "\nOutput variables:\n  "
            + "\n  ".join(str(m) for m in self._output_managers.values())
        )

    # -- expression sub-language ------------------------------------------

    def get_variable(self, expr: str, get_names_only=False, expr_only=False):
        """Parse ``expr`` into a variable / value / kwarg dict; see the
        reference docstring (``processing_chain.py:718-772``) for the syntax.
        """
        names: list[str] = []
        try:
            stmt = ast.parse(expr).body[0]
            var = self._parse_expr(stmt.value, expr, get_names_only, names)
        except ProcessingChainError:
            raise
        except Exception as e:
            raise ProcessingChainError(
                "Could not parse expression:\n  " + expr
            ) from e
        if get_names_only:
            return names
        if isinstance(stmt, ast.Expr):
            return var
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
            if expr_only:
                raise ProcessingChainError(
                    "kwarg assignment is not allowed in this context\n  " + expr
                )
            return {stmt.targets[0].id: var}
        raise ProcessingChainError("Could not parse expression:\n  " + expr)

    def _parse_expr(self, node, expr: str, dry_run: bool, names: list[str]):
        if node is None:
            return None

        if isinstance(node, ast.List):
            return np.array(
                ast.literal_eval(expr[node.col_offset : node.end_col_offset])
            )

        if isinstance(node, ast.Constant):
            return node.value

        if isinstance(node, ast.Name):
            if node.id in ureg:
                return ureg(node.id)
            names.append(node.id)
            if dry_run:
                return None
            val = self._vars_dict.get(node.id)
            if val is None:
                val = self.add_variable(node.id)
            return val

        if isinstance(node, ast.BinOp):
            lhs = self._parse_expr(node.left, expr, dry_run, names)
            rhs = self._parse_expr(node.right, expr, dry_run, names)
            if lhs is None or rhs is None:
                return None
            op, op_form = ast_ops_dict[type(node.op)]
            if not (isinstance(lhs, ProcChainVar) or isinstance(rhs, ProcChainVar)):
                ret = op(lhs, rhs) if not isinstance(
                    lhs, (Quantity, Unit)
                ) and not isinstance(rhs, (Quantity, Unit)) else _quantity_op(
                    type(node.op), lhs, rhs
                )
                if isinstance(ret, Quantity) and ret.u.dimensionless:
                    ret = float(ret)
                return ret
            name = "(" + op_form.format(str(lhs), str(rhs)) + ")"
            if isinstance(lhs, ProcChainVar) and isinstance(rhs, ProcChainVar):
                if is_in_ureg(lhs.unit) and is_in_ureg(rhs.unit):
                    unit = _quantity_op(
                        type(node.op), Quantity(1, lhs.unit), Quantity(1, rhs.unit)
                    ).u
                    if unit.dimensionless and unit.scale == 1:
                        unit = None
                elif lhs.unit not in (None, auto) and rhs.unit not in (None, auto):
                    if type(node.op) in (ast.Mult, ast.Div, ast.FloorDiv):
                        unit = op_form.format(str(lhs.unit), str(rhs.unit))
                    else:
                        unit = str(lhs.unit)
                elif lhs.unit not in (None, auto):
                    unit = lhs.unit
                else:
                    unit = rhs.unit
                out = ProcChainVar(
                    self,
                    name,
                    grid=None if lhs.is_coord is True and rhs.is_coord is True else auto,
                    is_coord=(
                        False
                        if lhs.is_coord is True and rhs.is_coord is True
                        else auto
                    ),
                    unit=unit,
                )
            elif isinstance(lhs, ProcChainVar):
                out = ProcChainVar(
                    self, name, unit=lhs.unit, is_coord=lhs.is_coord
                )
            else:
                out = ProcChainVar(
                    self, name, unit=rhs.unit, is_coord=rhs.is_coord
                )
            # elementwise ops preserve row lengths of variable-length data
            for side in (lhs, rhs):
                if isinstance(side, ProcChainVar) and side.vector_len is not None:
                    out.vector_len = side.vector_len
                    break
            self._add_step(KernelStep(self, op, [lhs, rhs, out]))
            return out

        if isinstance(node, ast.UnaryOp):
            operand = self._parse_expr(node.operand, expr, dry_run, names)
            if operand is None:
                return None
            op, op_form = ast_ops_dict[type(node.op)]
            name = "(" + op_form.format(str(operand)) + ")"
            if isinstance(operand, ProcChainVar):
                out = ProcChainVar(
                    self,
                    name,
                    operand.shape,
                    operand.dtype,
                    operand.grid,
                    operand.unit,
                    operand.is_coord,
                )
                self._add_step(KernelStep(self, op, [operand, out]))
                return out
            if isinstance(operand, (Quantity, Unit)):
                return -Quantity(1, operand) if isinstance(operand, Unit) else -operand
            return op(operand)

        if isinstance(node, ast.Compare):
            lhs = self._parse_expr(node.left, expr, dry_run, names)
            if len(node.comparators) != 1:
                raise ProcessingChainError("Compound comparisons are not supported.")
            rhs = self._parse_expr(node.comparators[0], expr, dry_run, names)
            if lhs is None or rhs is None:
                return None
            op, op_form = ast_ops_dict[type(node.ops[0])]
            if not (isinstance(lhs, ProcChainVar) or isinstance(rhs, ProcChainVar)):
                return op(lhs, rhs)
            out = ProcChainVar(self, "(" + op_form.format(str(lhs), str(rhs)) + ")")
            self._add_step(KernelStep(self, op, [lhs, rhs, out]))
            return out

        if isinstance(node, ast.Subscript):
            return self._parse_subscript(node, expr, dry_run, names)

        if isinstance(node, ast.IfExp):
            condition = self._parse_expr(node.test, expr, dry_run, names)
            a = self._parse_expr(node.body, expr, dry_run, names)
            b = self._parse_expr(node.orelse, expr, dry_run, names)
            if dry_run:
                return None
            return self._where(condition, a, b)

        if isinstance(node, ast.Attribute):
            module = expr[node.value.col_offset : node.value.end_col_offset]
            if module in self.module_list:
                attr = getattr(self.module_list[module], node.attr)
                if not isinstance(attr, Real):
                    raise ProcessingChainError(
                        f"Attribute {node.attr} of {module} is not a number"
                    )
                return attr
            val = self._parse_expr(node.value, expr, dry_run, names)
            if val is None:
                return None
            return getattr(val, node.attr)

        if isinstance(node, ast.Call):
            func = self.func_list.get(node.func.id, None)
            args = [self._parse_expr(a, expr, dry_run, names) for a in node.args]
            kwargs = {
                kw.arg: self._parse_expr(kw.value, expr, dry_run, names)
                for kw in node.keywords
            }
            if func is not None:
                return func(self, *args, **kwargs) if not dry_run else None
            if self._validate_name(node.func.id):
                var_name = node.func.id
                names.append(var_name)
                if var_name in self._vars_dict:
                    var = self._vars_dict[var_name]
                    var.update_auto(*args, **kwargs)
                    return var
                if not dry_run:
                    # positional declaration order is (shape, dtype, ...) for
                    # new and existing variables alike (the reference's
                    # new-variable path takes (dtype, shape) — a latent
                    # inconsistency its configs never exercise)
                    var = self.add_variable(var_name)
                    var.update_auto(*args, **kwargs)
                    return var
                return None
            raise ProcessingChainError(
                f"do not recognize call to {node.func.id}"
            )

        raise ProcessingChainError(f"cannot parse AST node {node!r}")

    def _parse_subscript(self, node, expr, dry_run, names):
        val = self._parse_expr(node.value, expr, dry_run, names)
        if val is None:
            return None
        if not isinstance(val, ProcChainVar) or (
            val.shape is not auto and len(val.shape) == 0
        ):
            raise ProcessingChainError(f"Cannot apply subscript to {val}")

        def get_index(slice_value, var_len=None):
            ret = self._parse_expr(slice_value, expr, dry_run, names)
            if ret is None:
                return None
            if isinstance(ret, ProcChainVar):
                return ret
            if isinstance(ret, (Quantity, Unit)):
                q = Quantity(1, ret) if isinstance(ret, Unit) else ret
                ret = float(q / val.period)
            if isinstance(ret, Real):
                round_ret = int(round(ret))
                if abs(ret - round_ret) > 0.0001:
                    log.warning(
                        "slice value %s is non-integer; rounding to %d",
                        ret, round_ret,
                    )
                ret = round_ret
            if isinstance(ret, int) and ret < 0 and var_len is not None:
                ret = self.get_variable(f"{var_len}{ret}")
            return ret

        if not isinstance(node.slice, (ast.Slice, ast.Tuple)):
            index = get_index(node.slice, val.vector_len)
            if dry_run:
                return None
            if isinstance(index, ProcChainVar):
                # a per-event index: get_default, NaN (or the integer type's
                # largest value) where it falls outside the row
                from .processors import get_default

                out = ProcChainVar(
                    self,
                    name=f"{val}[{index}]",
                    shape=(),
                    dtype=val.dtype,
                    grid=val.grid if val.is_coord is True else None,
                    unit=val.unit,
                    is_coord=val.is_coord,
                )
                default = (
                    np.nan
                    if np.issubdtype(val.dtype, np.floating)
                    else np.iinfo(val.dtype).max
                )
                self._add_step(KernelStep(self, get_default, [val, index, default, out]))
                return out
            out_name = f"{val}[{index}]"
            out_shape = val.shape[:-1]
            out_grid = val.grid if val.is_coord is True else None
            out = ProcChainVar(
                self, out_name, shape=out_shape, dtype=val.dtype,
                grid=out_grid, unit=val.unit, is_coord=val.is_coord,
            )
            self._add_step(SliceStep(val, out, index))
            out.defined = True
            return out

        if isinstance(node.slice, ast.Tuple):
            raise ProcessingChainError("Tuple subscripts are not implemented")

        sl = slice(
            get_index(node.slice.lower),
            get_index(node.slice.upper),
            get_index(node.slice.step),
        )
        if dry_run:
            return None
        if any(isinstance(s, ProcChainVar) for s in (sl.start, sl.stop, sl.step)):
            raise ProcessingChainError("Slice values must be constants")
        if val.shape is auto:
            raise ProcessingChainError(
                f"cannot slice {val} before its shape is known"
            )
        n = val.shape[-1]
        start, stop, step = sl.indices(n)
        out_len = max(0, -(-(stop - start) // step)) if step > 0 else max(
            0, -(-(start - stop) // -step)
        )
        out_name = "{}[{}:{}{}]".format(
            val,
            "" if sl.start is None else sl.start,
            "" if sl.stop is None else sl.stop,
            "" if sl.step is None else f":{sl.step}",
        )

        if val.grid in (None, auto):
            out_grid = val.grid
        else:
            pd = val.period
            if sl.step is not None:
                pd = pd * sl.step
            off = val.offset
            if sl.start is not None and sl.start > 0:
                shift = sl.start * val.period
                if isinstance(off, ProcChainVar):
                    new_off = ProcChainVar(
                        self, name=f"({off}+{shift})", is_coord=True
                    )
                    self._add_step(KernelStep(self, np.add, [off, shift, new_off]))
                    off = new_off
                else:
                    off = off + shift
            out_grid = CoordinateGrid(pd, off)

        out = ProcChainVar(
            self,
            out_name,
            shape=val.shape[:-1] + (out_len,),
            dtype=val.dtype,
            grid=out_grid,
            unit=val.unit,
            is_coord=val.is_coord,
        )
        self._add_step(SliceStep(val, out, sl))
        out.defined = True
        return out

    def _validate_name(self, name: str, raise_exception: bool = False) -> bool:
        isgood = bool(
            re.match(r"\A\w+$", name)
            and name not in self.func_list
            and name not in ureg
            and name not in self.module_list
        )
        if raise_exception and not isgood:
            raise ProcessingChainError(f"{name} is not a valid variable name")
        return isgood

    # -- builtin chain functions (reference :1177-1482) --------------------

    def _length(self, var):
        if var is None:
            return None
        if not isinstance(var, ProcChainVar):
            raise ProcessingChainError(f"cannot call len() on {var}")
        if var.vector_len is not None:
            return var.vector_len
        if var.shape is auto or len(var.shape) != 1:
            raise ProcessingChainError(f"{var} has wrong number of dims")
        return var.shape[0]

    def _round(self, var, to_nearest=1, dtype=None, mode="round"):
        from . import processors

        fun = {
            "round": processors.round_to_nearest,
            "floor": processors.floor_to_nearest,
            "ceil": processors.ceil_to_nearest,
            "trunc": processors.trunc_to_nearest,
        }.get(mode)
        if fun is None:
            raise ProcessingChainError("Mode must be round, floor, ceil or trunc")
        if var is None:
            return None
        if not isinstance(var, ProcChainVar):
            if isinstance(var, (Quantity, Unit)) and isinstance(
                to_nearest, (Quantity, Unit)
            ):
                q = Quantity(1, var) if isinstance(var, Unit) else var
                t = Quantity(1, to_nearest) if isinstance(to_nearest, Unit) else to_nearest
                rounded = _py_round(float(q / Quantity(1, t.u)), t.m, mode)
                return rounded * t.u
            return _py_round(var, to_nearest, mode)

        name = f"{mode}({var}, {to_nearest})"
        dtype = np.dtype(dtype) if dtype is not None else var.dtype
        if var.is_coord is True:
            if isinstance(to_nearest, Real):
                grid = CoordinateGrid(var.grid.period * to_nearest, var.grid.offset)
            elif isinstance(to_nearest, (Unit, Quantity)):
                grid = CoordinateGrid(to_nearest, var.grid.offset)
            else:
                grid = CoordinateGrid(to_nearest)
            out = ProcChainVar(
                self, name, var.shape, dtype, grid, var.unit, var.is_coord
            )
            step = ConvertStep(var, grid, mode=mode, out_var=out)
            self._add_step(step)
            out.reps[_rep_id(grid)] = step.out_key
            return out
        out = ProcChainVar(
            self, name, var.shape, dtype, var.grid, var.unit, var.is_coord
        )
        self._add_step(KernelStep(self, fun, [var, to_nearest, out]))
        return out

    def _astype(self, var, dtype):
        dtype = np.dtype(dtype)
        if var is None:
            return None
        if not isinstance(var, ProcChainVar):
            raise ProcessingChainError(f"cannot call astype() on {var}")
        name = f"{var}.astype(`{dtype.char}`)"
        out = ProcChainVar(
            self, name, var.shape, dtype, var.grid, var.unit, var.is_coord
        )
        dev = _device_dtype(dtype)
        self._add_step(
            FuncStep(
                lambda x: x.to(dev), [var.key], out.key, name
            )
        )
        out.defined = True
        return out

    def _isnan(self, var):
        return self._nan_check(var, "isnan")

    def _isfinite(self, var):
        return self._nan_check(var, "isfinite")

    def _nan_check(self, var, fn_name):
        if var is None:
            return None
        if not isinstance(var, ProcChainVar):
            return getattr(np, fn_name)(var)
        name = f"{fn_name}({var})"
        out = ProcChainVar(
            self, name, var.shape, np.dtype("bool"), var.grid, var.unit, var.is_coord
        )
        fn = getattr(torch, fn_name)
        # a closure, as the JAX package's (:3658): the step stays out of
        # generic groups in both packages (numpy's isnan ufunc joins them)
        self._add_step(FuncStep(lambda x: fn(x), [var.key], out.key, name))
        out.defined = True
        return out

    def _where(self, condition, a, b, dtype=auto):
        from . import processors

        if condition is None:
            return None
        if not (
            isinstance(condition, ProcChainVar)
            and (condition.dtype is auto or condition.dtype == np.dtype("bool"))
        ):
            raise ProcessingChainError(f"{condition} must be a boolean variable")

        name = f"where({condition}, {a}, {b})"
        n_vars = sum(isinstance(x, ProcChainVar) for x in (a, b))

        if n_vars == 2:
            # two chain variables: periods and coordinate-ness must agree;
            # mismatched *offsets* select per-event between the two grids
            for attr, label in (("period", "periods"), ("is_coord", "is_coord")):
                if getattr(a, attr) != getattr(b, attr):
                    raise ProcessingChainError(
                        f"Cannot select between {a} and {b} with different {label}"
                    )
            is_coord = a.is_coord
            same_offset = a.offset == b.offset or (
                isinstance(a.offset, ProcChainVar) and a.offset is b.offset
            )
            if same_offset:
                grid = a.grid
            elif a.grid in (None, auto) or b.grid in (None, auto):
                grid = None
            else:  # recursive select over the per-event offsets
                off = self._where(condition, a.offset, b.offset)
                grid = CoordinateGrid(a.period, off)
            norm = [
                Unit(v.unit) if is_in_ureg(v.unit) else v.unit for v in (a, b)
            ]
            blank = [u in (None, auto) for u in norm]
            if norm[0] == norm[1] or blank[1]:
                unit = norm[0]
            elif blank[0]:
                unit = norm[1]
            else:
                raise ProcessingChainError(
                    f"{a} and {b} do not have compatible units"
                )
        elif n_vars == 1:
            # one variable + one literal: the variable's metadata wins; a
            # unitted literal is converted into the variable's own system
            # (its grid period when it is a coordinate)
            var, const = (a, b) if isinstance(a, ProcChainVar) else (b, a)
            grid, is_coord, unit = var.grid, var.is_coord, var.unit
            if unit not in (None, auto) and isinstance(const, (Quantity, Unit)):
                if not is_in_ureg(unit):
                    raise ProcessingChainError(
                        f"{a} and {b} do not have compatible units"
                    )
                q = const if isinstance(const, Quantity) else Quantity(1, const)
                denom = var.period if is_coord is True else Quantity(1, unit)
                conv = float(q / denom)
                if var is a:
                    b = conv
                else:
                    a = conv
        else:
            # two literals: adopt the first unitted one's unit and express
            # the other in it
            grid, is_coord, unit = None, False, None
            if isinstance(a, Quantity):
                unit = a.u
                a = a.m
                if isinstance(b, Quantity):
                    b = float(b / Quantity(1, unit))
            elif isinstance(b, Quantity):
                unit = b.u
                b = b.m

        out = ProcChainVar(self, name, auto, dtype, grid, unit, is_coord)
        self._add_step(KernelStep(self, processors.where, [condition, a, b, out]))
        return out

    def _loadlh5(self, path_to_file, path_in_file):
        from .lh5 import Scalar, read

        try:
            loaded = read(path_in_file, path_to_file)
        except (OSError, KeyError, ValueError) as e:
            raise ProcessingChainError(
                f"could not load {path_in_file} from {path_to_file}"
            ) from e
        if isinstance(loaded, Scalar):
            return loaded.value
        return loaded.nda

    func_list = {
        "len": _length,
        "isfinite": _isfinite,
        "isnan": _isnan,
        "round": _round,
        "floor": lambda self, *a, **k: self._round(*a, mode="floor", **k),
        "ceil": lambda self, *a, **k: self._round(*a, mode="ceil", **k),
        "trunc": lambda self, *a, **k: self._round(*a, mode="trunc", **k),
        "astype": _astype,
        "where": _where,
        "loadlh5": _loadlh5,
    }
    module_list = {"np": np, "numpy": np}


@functools.cache
def _copy_stream(index: int) -> torch.cuda.Stream:
    """The stream the input copies to card ``index`` run on, one for the
    process: the device memory they allocate stays in one stream's pool,
    which the next chain's copies reuse."""
    return torch.cuda.Stream(index)


def _host_tensor(v) -> torch.Tensor:
    """One gathered input as a C-contiguous host tensor of its device
    dtype (a host tensor, as ``stage_stacked`` makes, as it is)."""
    if isinstance(v, torch.Tensor):
        return v
    v = np.asarray(v)
    want = _NP_FROM_TORCH[_device_dtype(v.dtype)]
    if v.dtype != want:
        v = v.astype(want)
    if not (v.flags.c_contiguous and v.flags.writeable):
        v = np.array(v, order="C")
    return torch.from_numpy(v)


def _to_pinned(t: torch.Tensor) -> torch.Tensor:
    """Enqueue a copy of the device tensor ``t`` into new pinned host memory
    on the current stream, without blocking. The caching host allocator
    hands that memory out again only once the copy has ended and the
    returned tensor is gone."""
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


def _py_round(val, to_nearest, mode: str):
    fn = {
        "round": np.round,
        "floor": np.floor,
        "ceil": np.ceil,
        "trunc": np.trunc,
    }[mode]
    return float(fn(np.asarray(val) / to_nearest) * to_nearest)


def _quantity_op(op_type, lhs, rhs):
    """Apply an AST arithmetic op to operands that may be Quantities."""
    import operator as _op

    table = {
        ast.Add: _op.add, ast.Sub: _op.sub, ast.Mult: _op.mul,
        ast.Div: _op.truediv, ast.FloorDiv: _op.floordiv,
        ast.Lt: _op.lt, ast.LtE: _op.le, ast.Gt: _op.gt,
        ast.GtE: _op.ge, ast.Eq: _op.eq, ast.NotEq: _op.ne,
    }
    if isinstance(lhs, Unit):
        lhs = Quantity(1, lhs)
    if isinstance(rhs, Unit):
        rhs = Quantity(1, rhs)
    return table[op_type](lhs, rhs)

# ---------------------------------------------------------------------------
# I/O managers: LGDO buffers <-> environment arrays (reference :1911-2360)
# ---------------------------------------------------------------------------


def _resolve_io_unit(var: ProcChainVar, unit):
    """Reconcile a buffer's ``units`` attr with the variable's unit and return
    the representation the buffer holds (reference ``LGDOArrayIOManager``
    ``:1984-2056``)."""
    if isinstance(var.unit, (CoordinateGrid, Quantity, Unit)):
        if isinstance(var.unit, CoordinateGrid):
            var_u = var.unit.period.u
        elif isinstance(var.unit, Quantity):
            var_u = var.unit.u
        else:
            var_u = var.unit
        if unit is None:
            unit = var_u
        elif ureg.is_compatible_with(var_u, unit):
            unit = ureg.Quantity(unit).u
        else:
            raise ProcessingChainError(
                f"buffer and variable {var} have incompatible units "
                f"({var_u} and {unit})"
            )
    elif isinstance(var.unit, str) and unit is None:
        unit = var.unit
    return unit


def _set_units_attr(buff, var: ProcChainVar) -> None:
    if "units" not in buff.attrs and var.unit not in (None, auto):
        u = var.unit
        buff.attrs["units"] = str(u.u) if isinstance(u, Quantity) else str(u)


class IOManager:
    """Translates between an external buffer and environment arrays."""

    def set_buffer(self, buff) -> None:
        raise NotImplementedError

    def read(self, start: int, stop: int):
        """Return ``({env_key: np.ndarray}, n_available)``."""
        raise NotImplementedError

    def write(self, results: dict, start: int, end: int) -> None:
        raise NotImplementedError

    def out_keys(self) -> list[str]:
        return []


class NumpyIOManager(IOManager):
    def __init__(self, io_buf: np.ndarray, var: ProcChainVar, output: bool) -> None:
        var.update_auto(dtype=io_buf.dtype, shape=io_buf.shape[1:])
        self.var = var
        self.key = var.key
        if not output:
            var.defined = True
        self.set_buffer(io_buf)

    def set_buffer(self, io_buf) -> None:
        if not isinstance(io_buf, np.ndarray):
            raise ProcessingChainError(f"{self.var} must be set using a numpy array")
        if self.var.shape != io_buf.shape[1:] or self.var.dtype != io_buf.dtype:
            raise ProcessingChainError(
                f"numpy.array(shape={io_buf.shape}, dtype={io_buf.dtype}) "
                f"is not compatible with variable {self.var}"
            )
        self.io_buf = io_buf

    def read(self, start, stop):
        stop = min(stop, self.io_buf.shape[0])
        return {self.key: self.io_buf[start:stop]}, max(0, stop - start)

    def write(self, results, start, end):
        res = results[self.key][: end - start]
        self.io_buf[start:end, ...] = res.astype(self.io_buf.dtype, copy=False)

    def out_keys(self):
        return [self.key]

    def __str__(self):
        return (
            f"{self.var} linked to numpy.array(shape={self.io_buf.shape}, "
            f"dtype={self.io_buf.dtype})"
        )


class LGDOArrayIOManager(IOManager):
    def __init__(self, io_array, var: ProcChainVar, output: bool) -> None:
        unit = io_array.attrs.get("units", None)
        var.update_auto(
            dtype=io_array.dtype, shape=io_array.nda.shape[1:], unit=unit
        )
        self.var = var
        unit = _resolve_io_unit(var, unit)
        self.key = var.value_in(unit)
        if not output:
            var.defined = True
        self.set_buffer(io_array)

    def set_buffer(self, io_array) -> None:
        if not isinstance(io_array, lgdo.Array):
            raise ProcessingChainError(f"{self.var} must be set using an lgdo.Array")
        _set_units_attr(io_array, self.var)
        if self.var.shape != io_array.nda.shape[1:]:
            raise ProcessingChainError(
                f"LGDO object {io_array.form_datatype()} is incompatible "
                f"with {self.var}"
            )
        self.io_array = io_array

    def read(self, start, stop):
        if start >= len(self.io_array):
            raise EndExecute
        stop = min(stop, len(self.io_array))
        return {self.key: self.io_array.nda[start:stop]}, stop - start

    def write(self, results, start, end):
        if len(self.io_array) < end:
            self.io_array.resize(end)
        res = results[self.key]
        if self.var.is_const:
            self.io_array.nda[start:end, ...] = np.asarray(res).astype(
                self.io_array.dtype, copy=False
            )
        else:
            self.io_array.nda[start:end, ...] = res[: end - start].astype(
                self.io_array.dtype, copy=False
            )

    def out_keys(self):
        return [self.key]

    def __str__(self):
        return (
            f"{self.var} linked to lgdo.Array(shape={self.io_array.shape}, "
            f"dtype={self.io_array.dtype}, attrs={self.io_array.attrs})"
        )


class LGDOArrayOfEqualSizedArraysIOManager(LGDOArrayIOManager):
    def set_buffer(self, io_array) -> None:
        if not isinstance(io_array, lgdo.ArrayOfEqualSizedArrays):
            raise ProcessingChainError(
                f"{self.var} must be set using an lgdo.ArrayOfEqualSizedArrays"
            )
        _set_units_attr(io_array, self.var)
        if self.var.shape != io_array.nda.shape[1:]:
            raise ProcessingChainError(
                f"LGDO object {io_array.form_datatype()} is incompatible "
                f"with {self.var}"
            )
        self.io_array = io_array

    def __str__(self):
        return (
            f"{self.var} linked to lgdo.ArrayOfEqualSizedArrays"
            f"(shape={self.io_array.shape}, dtype={self.io_array.dtype}, "
            f"attrs={self.io_array.attrs})"
        )


class LGDOVectorOfVectorsIOManager(IOManager):
    """Variable-length rows <-> (padded dense array, length variable), the
    JAX package's manager (``processing_chain.py:3961-4088``).

    Rows are padded and packed on the host by the native codec
    (:mod:`.lh5._native`); the device sees fixed shapes only: a ``(B,
    maxlen)`` plane and the length variable ``len(<name>)`` (or the
    variable the config names as ``vector_len``). Both are ordinary env
    keys, so they travel through staging, :meth:`ProcessingChain.fetch` and
    the write-behind of the production loop like any other column.
    """

    def __init__(self, io_vov, var: ProcChainVar, output: bool) -> None:
        if var.vector_len is None:
            var.vector_len = ProcChainVar(
                var.proc_chain,
                f"len({var.name})",
                shape=(),
                dtype=np.dtype("uint32"),
                grid=None,
                unit=None,
            )
        # the published configs use float count outputs (e.g.
        # peak_snr_threshold's no_out) as vector lengths: any numeric
        # dtype, truncated when written
        if var.vector_len.dtype is not auto and var.vector_len.dtype.kind not in "iuf":
            raise ProcessingChainError(
                f"{var.vector_len} must be numeric to act as a vector len"
            )
        unit = io_vov.attrs.get("units", None)
        var.update_auto(dtype=io_vov.dtype, unit=unit)
        self.var = var
        self.unit = _resolve_io_unit(var, unit)
        self.key = None  # resolved once var.shape is known
        self.len_key = var.vector_len.key
        self.output = output
        if not output:
            var.defined = True
            var.vector_len.defined = True
        self.set_buffer(io_vov)

    def set_buffer(self, io_vov) -> None:
        if not isinstance(io_vov, lgdo.VectorOfVectors):
            raise ProcessingChainError(
                f"{self.var} must be set using an lgdo.VectorOfVectors"
            )
        _set_units_attr(io_vov, self.var)
        if self.var.dtype != io_vov.dtype:
            raise ProcessingChainError(
                f"LGDO object {io_vov.form_datatype()} is incompatible "
                f"with {self.var}"
            )
        self.io_vov = io_vov

    def _resolve_key(self, start, stop):
        if self.key is not None:
            return
        if self.var.shape is auto:
            cl = self.io_vov.cumulative_length.nda
            lens = np.diff(cl[start:stop], prepend=cl[start - 1] if start else 0)
            maxlen = 2 * int(lens.max()) if len(lens) else 2
            self.var.update_auto(shape=maxlen)
            log.warning(
                "No maximum length provided for VectorOfVectors %s; using %d "
                "(twice the maximum of the first batch)", self.var, maxlen
            )
        self.key = self.var.value_in(self.unit)

    def read(self, start, stop):
        from .lh5._native import vov_unpack

        if start >= len(self.io_vov):
            raise EndExecute
        stop = min(stop, len(self.io_vov))
        self._resolve_key(start, stop)
        n = stop - start
        maxlen = self.var.shape[-1]
        cl = self.io_vov.cumulative_length.nda
        flat = self.io_vov.flattened_data.nda
        starts = np.empty(n, dtype="int64")
        starts[0] = cl[start - 1] if start > 0 else 0
        starts[1:] = cl[start : stop - 1]
        stops = cl[start:stop]
        fill = 0 if np.issubdtype(self.var.dtype, np.integer) else np.nan
        padded, lens, overflow = vov_unpack(
            flat, starts, stops, maxlen, fill, self.var.dtype
        )
        if overflow:
            raise DSPFatal(
                "VectorOfVectors entry has length larger than array variable "
                "length"
            )
        return {
            self.key: padded,
            self.len_key: lens.astype(self.var.vector_len.dtype),
        }, n

    def write(self, results, start, end):
        from .lh5._native import vov_pack

        self._resolve_key(start, end)
        n = end - start
        arr = np.asarray(results[self.key][:n]).astype(
            self.io_vov.dtype, copy=False
        )
        lens = np.clip(
            np.asarray(results[self.len_key][:n]).astype("int64"), 0, arr.shape[1]
        )
        if len(self.io_vov) < end:
            self.io_vov.resize(end)
        base = int(self.io_vov.cumulative_length[start - 1]) if start > 0 else 0
        need = base + int(lens.sum())
        if len(self.io_vov.flattened_data.nda) < need:
            self.io_vov.flattened_data.resize(need)
        cum = np.empty(n, dtype="uint64")
        vov_pack(np.ascontiguousarray(arr), lens, base,
                 self.io_vov.flattened_data.nda, cum)
        self.io_vov.cumulative_length.nda[start:end] = cum.astype(
            self.io_vov.cumulative_length.dtype
        )

    def out_keys(self):
        if self.key is None:
            self._resolve_key(0, 0)
        return [self.key, self.len_key]

    def __str__(self):
        return (
            f"{self.var} linked to lgdo.VectorOfVectors"
            f"(vector_len={self.var.vector_len}, dtype={self.io_vov.dtype}, "
            f"attrs={self.io_vov.attrs})"
        )


class LGDOWaveformIOManager(IOManager):
    """WaveformTable <-> (values array, per-event t0 offset variable).

    Wires ``dt``/``t0`` into the variable's :class:`CoordinateGrid` with a
    per-event offset variable (reference ``processing_chain.py:2263-2360``).
    """

    def __init__(self, wf_table, var: ProcChainVar, output: bool) -> None:
        dt_units = wf_table.dt_units
        t0_units = wf_table.t0_units
        if dt_units is None:
            dt_units = t0_units
        elif t0_units is None:
            t0_units = dt_units

        self.wf_var = var
        if (
            var.grid is auto
            and isinstance(dt_units, str)
            and dt_units in ureg
            and isinstance(t0_units, str)
            and t0_units in ureg
        ):
            offset_var = ProcChainVar(
                var.proc_chain,
                var.name + "_dt",
                shape=(),
                dtype=wf_table.t0.dtype,
                grid=None,
                unit=dt_units,
                is_coord=True,
            )
            var.update_auto(
                grid=CoordinateGrid(
                    ureg.Quantity(float(wf_table.dt[0]), dt_units), offset_var
                ),
                is_coord=False,
            )
        else:
            var.update_auto(grid=None, is_coord=False)

        if var.grid not in (None, auto) and var.proc_chain._default_grid is None:
            var.proc_chain._default_grid = var.grid

        if isinstance(wf_table.values, lgdo.VectorOfVectors):
            self.val_ioman = LGDOVectorOfVectorsIOManager(
                wf_table.values, var, output
            )
        else:
            self.val_ioman = LGDOArrayOfEqualSizedArraysIOManager(
                wf_table.values, var, output
            )
        if dt_units is None:
            dt_units = var.grid.unit_str()
            t0_units = var.grid.unit_str()
        self.t0_units = t0_units
        self.output = output

        # env key of the per-event offset in t0 units, or a fixed float
        self.t0_ref = (
            var.grid.get_offset(t0_units) if var.grid not in (None, auto) else 0.0
        )
        self.variable_t0 = isinstance(self.t0_ref, str)
        if self.variable_t0 and not output:
            offset_var.defined = True
        self.set_buffer(wf_table)

    def set_buffer(self, wf_table) -> None:
        if not isinstance(wf_table, lgdo.WaveformTable):
            raise ProcessingChainError(
                f"IO buffer for {self.wf_var} is not a WaveformTable"
            )
        _set_units_attr(wf_table, self.wf_var)
        self.io_wf = wf_table
        self.val_ioman.set_buffer(wf_table.values)
        if self.wf_var.grid not in (None, auto):
            if not self.variable_t0:
                wf_table.t0.nda[:] = self.t0_ref
            dt_units = self.wf_var.grid.period.u
            wf_table.dt.nda[:] = self.wf_var.grid.get_period(dt_units)
            wf_table.dt_units = str(dt_units)
            wf_table.t0_units = str(dt_units)

    def read(self, start, stop):
        if start >= len(self.io_wf):
            raise EndExecute
        stop = min(stop, len(self.io_wf))
        arrs, n = self.val_ioman.read(start, stop)
        if self.variable_t0:
            arrs[self.t0_ref] = self.io_wf.t0.nda[start:stop]
        return arrs, n

    def write(self, results, start, end):
        if len(self.io_wf) < end:
            self.io_wf.resize(end)
        self.val_ioman.write(results, start, end)
        if self.variable_t0:
            self.io_wf.t0.nda[start:end] = np.asarray(
                results[self.t0_ref][: end - start]
            ).astype(self.io_wf.t0.dtype, copy=False)

    def out_keys(self):
        keys = list(self.val_ioman.out_keys())
        if self.variable_t0:
            keys.append(self.t0_ref)
        return keys

    def __str__(self):
        return f"{self.wf_var} linked to lgdo.WaveformTable({self.val_ioman})"

# ---------------------------------------------------------------------------
# build_processing_chain: config -> compiled chain (reference :2363-2873)
# ---------------------------------------------------------------------------

_DB_PARSER = re.compile(r"(?![^\w_.])db\.[\w_.]+")


def _port_module_name(mod_name: str) -> str:
    """Map the reference's ``dspeed.*`` and the JAX package's
    ``dspeed_tpu.*`` module names onto this package by name alone (importing
    them would pull in the JAX package)."""
    for prefix in ("dspeed_tpu", "dspeed"):
        if mod_name == prefix or mod_name.startswith(prefix + "."):
            return "dspeed_tpu_torch" + mod_name[len(prefix):]
    return mod_name


def _db_substitute(arg: str, db_dict, defaults, context: str):
    """Replace ``db.x.y`` tokens in ``arg`` with database values."""
    for db_var in _DB_PARSER.findall(arg):
        try:
            db_node = db_dict
            for db_key in db_var[3:].split("."):
                db_node = db_node[db_key]
            log.debug("database lookup: found %s for %s", db_node, db_var)
        except (KeyError, TypeError):
            try:
                db_node = defaults[db_var]
                log.debug(
                    "database lookup: using default value of %s for %s",
                    db_node, db_var,
                )
            except (KeyError, TypeError):
                raise ProcessingChainError(
                    f"did not find {db_var} in database and could not find "
                    f"default value ({context})"
                )
        if arg == db_var:
            arg = db_node
        else:
            arg = arg.replace(db_var, str(db_node))
    return arg


def _load_config(processors):
    if isinstance(processors, str):
        with open(processors) as f:
            if processors.endswith((".yaml", ".yml")):
                import yaml

                return yaml.safe_load(f)
            text = f.read()
        try:
            return json.loads(text)
        except json.JSONDecodeError:
            import yaml

            return yaml.safe_load(text)
    if processors is None:
        return {}
    if isinstance(processors, MutableMapping):
        return deepcopy(processors)
    raise ValueError("processors must be a dict, json/yaml file, or None")


def build_processing_chain(
    processors,
    tb_in: lgdo.Table = None,
    db_dict: dict = None,
    outputs: list[str] = None,
    block_width: int = 16,
    device=None,
    fuse: bool | str = True,
) -> tuple[ProcessingChain, list[str], lgdo.Table]:
    """Compile a JSON/YAML DSP recipe into a :class:`ProcessingChain` plus an
    output table. Config schema, ``db.*`` substitution, dependency
    resolution, const folding and ``init_args`` factory semantics match the
    reference (``processing_chain.py:2363-2873``); see its docstring for the
    recipe format.

    ``device``: where the chain runs (default CUDA; see :mod:`.config`).
    ``fuse``: run the fusion pass (:meth:`ProcessingChain.optimize_fusions`):
    ``True`` the hand patterns then the generic pass, ``"generic"`` only the
    generic pass (what a config matching no hand pattern gets; the JAX
    package's ``DSPEED_TPU_FUSE=generic``), ``False`` none.
    Processor modules named ``dspeed.*`` or ``dspeed_tpu.*`` (the reference's
    and the JAX package's configs) resolve to ``dspeed_tpu_torch.*``.
    """
    if fuse not in (True, False, "generic"):
        raise ValueError(f"fuse must be True, False or 'generic', got {fuse!r}")
    processors = _load_config(processors)

    if outputs is None:
        if "outputs" not in processors:
            raise ValueError("outputs not provided")
        outputs = processors["outputs"]
    if "processors" in processors:
        processors = processors["processors"]
    processors = dict(processors)

    buffer_len = len(tb_in) if tb_in is not None else 1
    proc_chain = ProcessingChain(block_width, buffer_len, device=device)

    # ---- pass 1: normalize nodes, substitute db values, find prereqs ----
    multi_out_procs = {}
    for key, node in processors.items():
        keys = [k for k in re.split(",| ", key) if k != ""]
        if len(keys) > 1:
            for k in keys:
                multi_out_procs[k] = key

        if isinstance(node, str):
            node = {"function": node}
            processors[key] = node
        if "function" not in node:
            raise ProcessingChainError(f"no function for parameter {key}")
        function = node["function"]
        f_parse = ast.parse(function, mode="eval").body

        mod_err = f"Module specified twice for parameter {key}"
        args_err = f"Cannot specify arguments if function is expr for parameter {key}"
        if isinstance(f_parse, ast.Name):
            pass
        elif isinstance(f_parse, ast.Attribute):
            module = function[f_parse.value.col_offset : f_parse.value.end_col_offset]
            if module in ProcessingChain.module_list and "args" not in node:
                node["module"] = None
                node["args"] = [function]
            else:
                node["function"] = f_parse.attr
                if "module" in node:
                    raise ProcessingChainError(mod_err)
                node["module"] = module
        elif isinstance(f_parse, ast.Call):
            if "args" in node:
                raise ProcessingChainError(args_err)
            if (
                isinstance(f_parse.func, ast.Name)
                and f_parse.func.id in ProcessingChain.func_list
                and "module" not in node
            ):
                node["module"] = None
                node["args"] = [function]
            elif isinstance(f_parse.func, ast.Name):
                node["function"] = f_parse.func.id
                node["args"] = [
                    function[a.col_offset : a.end_col_offset]
                    for a in f_parse.args + f_parse.keywords
                ]
            elif isinstance(f_parse.func, ast.Attribute):
                node["function"] = f_parse.func.attr
                if "module" in node:
                    raise ProcessingChainError(mod_err)
                mod = f_parse.func.value
                node["module"] = function[mod.col_offset : mod.end_col_offset]
                node["args"] = [
                    function[a.col_offset : a.end_col_offset]
                    for a in f_parse.args + f_parse.keywords
                ]
        else:
            if "args" in node:
                raise ProcessingChainError(args_err)
            if "module" in node:
                raise ProcessingChainError(mod_err)
            node["module"] = None
            node["args"] = [function]

        if "module" not in node:
            raise ProcessingChainError(f"Could not find module for parameter {key}")
        if "args" not in node:
            raise ProcessingChainError(f"Could not find args for parameter {key}")

        args = node["args"] = list(node["args"])
        for i, arg in enumerate(args):
            if isinstance(arg, str):
                args[i] = _db_substitute(
                    arg, db_dict, node.get("defaults"), f"parameter {key}"
                )

        if "prereqs" not in node:
            prereqs = []
            for arg in args:
                if not isinstance(arg, str):
                    continue
                for prereq in proc_chain.get_variable(arg, True):
                    if prereq not in prereqs and prereq not in keys:
                        prereqs.append(prereq)
            node["prereqs"] = prereqs
        log.debug("prereqs for %s are %s", key, node["prereqs"])

    processors.update(multi_out_procs)

    # ---- dependency resolution (DFS with cycle detection, ref :2601) ----
    def resolve_dependencies(par, resolved, leafs, unresolved=None):
        if unresolved is None:
            unresolved = []
        if par in resolved:
            return
        if par in unresolved:
            raise ProcessingChainError(
                f"Circular references detected for parameter '{par}'"
            )
        node = processors.get(par)
        if node is None:
            if par not in leafs:
                leafs.append(par)
            return
        if isinstance(node, str):
            resolve_dependencies(node, resolved, leafs, unresolved)
            return
        unresolved.append(par)
        for edge in node["prereqs"]:
            resolve_dependencies(edge, resolved, leafs, unresolved)
        resolved.append(par)
        unresolved.remove(par)

    proc_par_list: list[str] = []
    input_par_list: list[str] = []
    copy_par_list: list[str] = []
    out_par_list: list[str] = []
    for out_par in outputs:
        if out_par not in processors:
            copy_par_list.append(out_par)
        else:
            resolve_dependencies(out_par, proc_par_list, input_par_list)
            out_par_list.append(out_par)

    log.debug("processing parameters: %s", proc_par_list)
    log.debug("required input parameters: %s", input_par_list)
    log.debug("copied output parameters: %s", copy_par_list)
    log.debug("processed output parameters: %s", out_par_list)

    # ---- link inputs ----------------------------------------------------
    for input_par in input_par_list:
        if tb_in is None or input_par not in tb_in:
            log.warning("'%s' not found in input files or dsp config", input_par)
            continue
        try:
            proc_chain.link_input_buffer(input_par, tb_in[input_par])
        except Exception as e:
            raise ProcessingChainError(
                f"Exception raised while linking input buffer '{input_par}'."
            ) from e

    # ---- pass 2: add processors in dependency order ---------------------
    for proc_par in proc_par_list:
        recipe = processors[proc_par]
        try:
            if recipe["module"] is None:
                # built-in expression: alias its value under the output name
                assert len(recipe["args"]) == 1
                fun_var = proc_chain.get_variable(recipe["args"][0])
                if isinstance(fun_var, ProcChainVar):
                    new_var = proc_chain.add_variable(
                        name=proc_par,
                        dtype=fun_var.dtype,
                        shape=fun_var.shape,
                        grid=fun_var.grid,
                        unit=fun_var.unit,
                        is_coord=fun_var.is_coord,
                        vector_len=fun_var.vector_len,
                    )
                    if fun_var.is_const:
                        new_var.is_const = True
                        new_var.const_value = fun_var.const_value
                        new_var.defined = True
                    else:
                        proc_chain._add_step(
                            AliasStep(fun_var.key, new_var.key, f"{proc_par} = {fun_var}")
                        )
                        new_var.reps = fun_var.reps
                        new_var.defined = True
                else:
                    new_var = proc_chain.set_constant(varname=proc_par, val=fun_var)
                log.debug("setting %s = %s", new_var, fun_var)
                continue

            mod_name = _port_module_name(recipe["module"])
            try:
                module = importlib.import_module(mod_name)
                func = getattr(module, recipe["function"])
            except (ModuleNotFoundError, AttributeError):
                # the reference names per-kernel submodules (e.g.
                # dspeed.processors.get_multi_local_extrema) whose layout
                # differs here; resolve through the processor registry
                if not mod_name.startswith("dspeed_tpu_torch.processors"):
                    raise
                from . import processors

                if recipe["function"] not in processors.__all__:
                    raise ProcessingChainError(
                        f"processor {recipe['function']} is not ported to "
                        "dspeed_tpu_torch yet (see ROADMAP)"
                    )
                func = getattr(processors, recipe["function"])

            args = recipe["args"]
            new_vars = [k for k in re.split(",| ", proc_par) if k != ""]

            if "unit" in recipe:
                for i, name in enumerate(new_vars):
                    unit = recipe.get("unit", auto)
                    if isinstance(unit, list):
                        unit = unit[i]
                    proc_chain.add_variable(name, unit=unit)

            kwargs = recipe.get("kwargs", {})
            kwargs.update(
                {
                    k: recipe[k]
                    for k in ("signature", "types", "coord_grid")
                    if k in recipe
                }
            )

            if "init_args" in recipe:
                init_args = []
                init_kwargs = {}
                for arg in recipe["init_args"]:
                    if isinstance(arg, str):
                        arg = _db_substitute(
                            arg, db_dict, recipe.get("defaults"),
                            f"init_args of {proc_par}",
                        )
                        if isinstance(arg, str):
                            arg = proc_chain.get_variable(arg)
                    if isinstance(arg, MutableMapping):
                        init_kwargs.update(arg)
                    else:
                        init_args.append(arg)
                log.debug(
                    "building function from init_args: %s(%s)",
                    recipe["function"],
                    ", ".join(
                        [str(a) for a in init_args]
                        + [f"{k}={v}" for k, v in init_kwargs.items()]
                    ),
                )
                func = func(*init_args, **init_kwargs)

            # classify args; decide const folding (reference :2775-2820)
            params = []
            kw_params = {}
            out_params = []
            is_const = True
            for param in args:
                if isinstance(param, str):
                    param = proc_chain.get_variable(param)
                if isinstance(param, MutableMapping):
                    kw_params.update(param)
                    param = list(param.values())[0]
                elif isinstance(param, str):
                    params.append(f"'{param}'")
                else:
                    params.append(param)
                if isinstance(param, ProcChainVar):
                    if param.name in new_vars:
                        out_params.append(param)
                    elif not param.is_const:
                        is_const = False

            if is_const:
                if out_params:
                    for param in out_params:
                        param.is_const = True
                    step = KernelStep(
                        proc_chain, func, params, kw_params,
                        kwargs.get("signature"), kwargs.get("types"),
                    )
                    step.run({})  # executes eagerly; fills const_value
                    for param in out_params:
                        log.debug(
                            "set constant: %s = %s",
                            param.description(), param.const_value,
                        )
                else:
                    const_val = func(*params, **kw_params)
                    if len(new_vars) == 1:
                        const_val = [const_val]
                    for var, val in zip(new_vars, const_val):
                        proc_chain.set_constant(var, np.asarray(val))
            else:
                proc_chain.add_processor(func, *params, kw_params, **kwargs)

        except Exception as e:
            raise ProcessingChainError(
                "Exception raised while attempting to add processor:\n"
                + json.dumps(recipe, indent=2, default=str)
            ) from e

    # ---- output table ---------------------------------------------------
    tb_out = lgdo.Table(size=buffer_len)

    for copy_par in copy_par_list:
        if tb_in is None or copy_par not in tb_in:
            log.warning(
                "'%s' not found in input files or dsp config; building output "
                "without it", copy_par,
            )
            continue
        try:
            proc_chain.link_input_buffer(copy_par, tb_in[copy_par])
            buf_out = proc_chain.link_output_buffer(copy_par)
            buf_out.attrs.update(tb_in[copy_par].attrs)
            buf_out.resize(len(tb_out))
            tb_out.add_field(copy_par, buf_out)
        except Exception as e:
            raise ProcessingChainError(
                f"Exception raised while linking copy buffer '{copy_par}'."
            ) from e

    for out_par in out_par_list:
        try:
            buf_out = proc_chain.link_output_buffer(out_par)
            recipe = processors[out_par]
            if isinstance(recipe, str):
                recipe = processors[recipe]
            buf_out.attrs.update(recipe.get("lh5_attrs", {}))
            if recipe.get("description"):
                buf_out.attrs["description"] = recipe["description"]
            buf_out.resize(len(tb_out))
            tb_out.add_field(out_par, buf_out)
        except Exception as e:
            raise ProcessingChainError(
                f"Exception raised while linking output buffer {out_par}."
            ) from e

    field_mask = input_par_list + copy_par_list
    if fuse:
        proc_chain.optimize_fusions(generic_only=fuse == "generic")
    return proc_chain, field_mask, tb_out
