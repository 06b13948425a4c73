"""Lowering of a generic fusion group into the row tape of kernel K7.

The JAX package runs a :class:`~dspeed_tpu_torch.processing_chain.GroupStep`
by tracing its members into one Pallas program over row tiles
(``dspeed_tpu/processors/_pallas.py:1782`` ``generic_rows``), and learns
whether Mosaic takes it from a probe compile (``_gen_probe_compile`` :1720).
Here the host lowers the member list into a tape before any launch:

- a **slot** is a per-row plane (shared memory on the card) or a per-row
  scalar (a bool or an int64 too), in the dtype the unfused chain gives the
  same env key (float64 where the plain path computes in float64); a slice
  or an alias is a view of its root slot and copies nothing. A program's
  planes are float32 or bool (one word a sample, 1.0 or 0.0; a stored copy
  one byte), but for the float64 planes that ``reflected_convolve_wf``
  writes from a float32 row and float64 taps and ``avg_current`` reads and
  writes whole (the SiPM chain computes in float64 from its smoothed
  waveform on); or, in a **float64 program** (``TileProgram.f64``: a float64
  row loaded, read by ``reflected_convolve_wf``, or read or written by any
  other op), float64 or bool (two words a sample, a bool plane's 1.0 or 0.0
  a double; its stored copy one byte), every op of a float program
  (:data:`F64_OPS`; ``reflected_conv`` there reads a float64 row), run by
  K7's float64 kernel;
- an **op** is an opcode, its operand slots (or constants) and output slots,
  and static parameters (window lengths, taps, mode, direction);
- a **liveness plan** gives each plane a place in shared memory from its
  defining op to its last reader, so planes that are dead share space;
  an external plane is loaded before its first reader; an escaping root is
  stored to device memory when its op has written it. A plan over one
  block's shared memory (``_cuda._MAX_SMEM``) is refused, and so is a
  group that reads more inputs or stores more outputs than K7's
  parameters hold (``_cuda.GEN_MAX_EXT``, ``GEN_MAX_ESC``).

A member with no op, a mix of plane types that no member makes (a float32
plane in a float64 program), an operand shape the tape does not take, or a
plan over one block's shared memory (the float64 plane path's group C)
raises :class:`LoweringError`; the group then splits
(``GroupStep._exec``). The op set is the one the flagship's two generic
groups, the SiPM chain's group, the flagship DPZ's energy-front group
(``double_pole_zero``) and the flagship-extras groups need
(``poly_residual``, ``soft_pileup``, ``time_point_thresh``'s interpolation
modes, ``wf_correction``, ``wf_centroid``), the flagship's injection and
ML path need (``inject`` for the four pulse injectors, ``dense`` for the
five layers of ``ml.py``), and the coverage path runs (the twelve kernels
of ``mean_below_threshold``, ``count``, ``presum``, ``log_check``,
``trap_pickoff``, ``min_max_norm``, ``linear_slope_diff``, ``get``,
``multi_a_filter``, ``where`` and ``round``, with per-row comparisons into
bool slots and conversions into int64 slots); and it takes every
member the JAX package's ``generic_rows`` takes on float32 rows:
``trap_filter`` (the ``trap`` op's third kind), the moving windows
(``moving_window``), ``fixed_time_pickoff`` in every mode but ``s``, the
direct convolution (``conv_direct``, 32 taps or fewer), every conversion
(the ``convert`` op's kinds; a plane's by ``ewise``), the ufuncs of
``_GENERIC_UFUNC_SAFE`` over planes, per-row scalars and constants
(``ewise``, into float or bool planes; per-row ones by ``ufunc``, one
table, :data:`UFUNCS`) and its row reductions (``reduce``; ``amax`` keeps
its op); and every one of these on float64 rows too, each in the order of
its member's K7-order variant given ``f64`` (``k7_plain``), its constants
(taps, weights, pulse parameters) in float64.

:func:`~dspeed_tpu_torch.processors._cuda.generic_rows` runs a program on
the card; :func:`~dspeed_tpu_torch.processors._cuda.generic_rows_plain`
walks the same tape in PyTorch, each op calling its member kernel's body.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..processing_chain import (
    AliasStep, ConvertStep, KernelStep, SliceStep, _align_shape, _device_dtype,
    auto,
)
from ._cuda import _MAX_SMEM, GEN_MAX_CODE, GEN_MAX_DP, GEN_MAX_ESC, GEN_MAX_EXT
from ._numerics import K7_THREADS
from .convolutions import _MATMUL_MAC_LIMIT, _mode_window
from .ml import activation_flag
from .pole_zero import dpz_constants, dpz_powers
from .pulse_injector import _LOG99x4
from .soft_pileup_corr import fit_constants

log = logging.getLogger("dspeed_tpu_torch.generic")

__all__ = ["LoweringError", "TileProgram", "esc_dtype", "lower", "SPLITS",
           "reset_splits"]


class LoweringError(Exception):
    """The member list has no tape: the group splits."""


# splits of generic groups since the last reset, by reason
SPLITS: dict[str, int] = {}


def reset_splits() -> None:
    SPLITS.clear()


def count_split(group, members, err) -> None:
    SPLITS[str(err)] = SPLITS.get(str(err), 0) + 1
    log.info("%s: a run of %d members splits: %s", group, len(members), err)


# opcodes, and the record layout of the tape (mirrored in csrc/generic_rows.cu)
OPCODES = {
    "load": 1, "min_max": 2, "bl_subtract": 3, "linear_slope_fit": 4,
    "pole_zero": 5, "trap": 6, "amax": 7, "conv": 8, "time_point_thresh": 9,
    "windower": 10, "avg_current": 11, "moving_window_multi": 12,
    "fixed_time_pickoff": 13, "ufunc": 14, "convert": 15, "reflected_conv": 16,
    "double_pole_zero": 17, "poly_residual": 18, "soft_pileup": 19,
    "wf_correction": 20, "wf_centroid": 21, "soft_pileup_out": 22,
    "inject": 23, "dense": 24, "mean_below_threshold": 25, "count": 26,
    "presum": 27, "log_check": 28, "trap_pickoff": 29, "min_max_norm": 30,
    "linear_slope_diff": 31, "get": 32, "multi_a_filter": 33, "where": 34,
    "round": 35, "moving_window": 36, "conv_direct": 37, "ewise": 38, "reduce": 39,
}
OP_IN, OP_OUT, OP_IP, OP_DP = 6, 4, 8, 4
OP_INTS = 1 + OP_IN + OP_OUT + OP_IP  # code, in, out, ip
SLOT_INTS = 8  # kind, type, off, len, sidx, ext, esc, root
# a slot's type (its record's second field): planes are float32 or float64;
# a per-row scalar may also be a bool (a comparison's, a where's condition)
# or an int64 (an index), held as a double in shared memory
SLOT_TYPES = {torch.float32: 0, torch.float64: 1, torch.bool: 2, torch.int64: 3}
# the elementwise functions (ip[0] of the per-row ``ufunc`` op and of the
# plane ``ewise`` op, one table for both; csrc/generic_rows.cu ufunc_apply):
# every ufunc of the JAX package's _GENERIC_UFUNC_SAFE but its reductions,
# and ``where`` (three operands)
UFUNCS = {"add": 0, "multiply": 1, "divide": 2, "true_divide": 2,
          "greater": 3, "greater_equal": 4, "less": 5, "less_equal": 6,
          "equal": 7, "not_equal": 8, "subtract": 9, "floor_divide": 10,
          "power": 11, "remainder": 12, "mod": 12, "maximum": 13, "minimum": 14,
          "logical_and": 15, "logical_or": 16, "negative": 17, "absolute": 18,
          "abs": 18, "fabs": 18, "sqrt": 19, "square": 20, "sign": 21, "rint": 22,
          "floor": 23, "ceil": 24, "trunc": 25, "exp": 26, "expm1": 27, "log": 28,
          "log1p": 29, "log10": 30, "logical_not": 31, "isnan": 32, "isfinite": 33,
          "where": 34}
UNARY = 17  # kinds from this one on take one operand (but where, three)
EW_CONVERT = 40  # the ewise op's conversions of a plane: 40 + CONVERTS[name]
# the kinds whose results are bools (into bool slots)
BOOL_KINDS = frozenset((3, 4, 5, 6, 7, 8, 15, 16, 31, 32, 33))
BOOL_UFUNCS = tuple(k for k, v in UFUNCS.items() if v in BOOL_KINDS)
# the convert op's kinds (ip[0]), ConvertStep's kernels
CONVERTS = {"convert": 0, "convert_round": 1, "convert_floor": 2, "convert_ceil": 3,
            "convert_trunc": 4, "convert_int": 5}
# the reduce op's kinds (ip[0]): the numpy reductions of a row; amax has
# its own op. The sums run in K7's float64 block order (_numerics.k7_sum)
REDUCTIONS = {"amin": 0, "min": 0, "max": 1, "nanmin": 2, "nanmax": 3, "sum": 4,
              "mean": 5, "nansum": 6, "nanmean": 7}
# the round op's kinds (ip[0])
ROUNDERS = {"round_to_nearest": 0, "floor_to_nearest": 1, "ceil_to_nearest": 2,
            "trunc_to_nearest": 3}
THREADS = K7_THREADS  # threads per block, one row per block
STATIC_SMEM = 512  # bytes of static shared memory (the reduction scratch)
ALIGN = 4  # planes start on 16-byte boundaries
IP_PLAN = 4  # ip[4]: the barrier plan (bit 0: a block barrier before the op)
# the ops of a float64 program (csrc/generic_rows.cu generic_rows_kernel_f64):
# every op of a float program (reflected_conv there reads a float64 row)
F64_OPS = tuple(OPCODES)
# the ops of a float program that read or write float64 planes (the SiPM
# group's): a float32 row into reflected_conv's float64 plane, avg_current
# over it
F32_PROGRAM_F64_OPS = ("reflected_conv", "avg_current")
# the trap op's kinds (ip[0])
TRAP_KINDS = {"trap_norm": 0, "asym_trap_filter": 1, "trap_filter": 2}
# fixed_time_pickoff's modes that have an op (ip[0] = ord(mode)); 's' runs a
# spline solver and stays out of groups
FTP_MODES = "linfch"
# ops that run on warp 0 alone (the others on every thread of the block)
WARP_OPS = ("time_point_thresh", "fixed_time_pickoff", "ufunc", "convert", "get",
            "where", "round")
# ops with a block barrier of their own after their first reads of their
# operands and before any of their writes (csrc/generic_rows.cu)
BARRIERED_OPS = ("min_max", "linear_slope_fit", "pole_zero", "trap", "amax",
                 "conv", "moving_window_multi", "double_pole_zero",
                 "poly_residual", "soft_pileup", "wf_centroid",
                 "mean_below_threshold", "count", "log_check", "trap_pickoff",
                 "linear_slope_diff", "moving_window", "reduce")
# the dense op's kinds (ip[0]); all but the normalisation have a barrier
# of their own, and take the scratch for their warps' partial sums
DENSE_KINDS = {"normalisation_layer": 0, "dense_layer_no_bias": 1,
               "dense_layer_with_bias": 1, "classification_layer_no_bias": 2,
               "classification_layer_with_bias": 2}
# the inject op's kinds (ip[0]), with their parameter counts
INJECT_KINDS = {"inject_sig_pulse": (0, 4), "inject_exp_pulse": (1, 4),
                "inject_gumbel": (2, 3), "inject_general_logistic": (3, 6)}
# barriered ops that read their input planes again after their own barrier
READ_AFTER_BARRIER = ("trap", "pole_zero", "double_pole_zero", "wf_centroid",
                      "log_check", "moving_window")
# the block reductions' two alternating buffers: for each op that takes
# them (its first one before its first barrier), how many of the buffers
# it took last it still reads after its last barrier. One is safe, since
# the next reduction takes the other buffer; two would meet its first write
LATE_REDUCTION_READS = {"min_max": 1, "linear_slope_fit": 1, "pole_zero": 1,
                        "amax": 1, "trap": 0, "moving_window_multi": 0,
                        "double_pole_zero": 1, "poly_residual": 1,
                        "soft_pileup": 1, "wf_centroid": 1,
                        "mean_below_threshold": 1, "count": 1,
                        "linear_slope_diff": 1, "trap_pickoff": 0,
                        "moving_window": 0, "reduce": 1}
# ops that take the scratch: the prefix ops write it after their scan's
# barrier; the convolution and a product stage in it before their own
SCRATCH_OPS = ("trap", "moving_window_multi", "conv", "double_pole_zero",
               "trap_pickoff", "moving_window")


def esc_dtype(slot) -> torch.dtype:
    """The type of a root's stored copy on the card: a bool scalar's or an
    int64's value is stored as a float64, which the wrapper converts to the
    slot's type (``csrc/generic_rows.cu``'s ``put``); a bool plane as bytes."""
    if slot.kind == "plane":
        return slot.dtype
    return torch.float64 if slot.dtype in (torch.bool, torch.int64) else slot.dtype


class Slot:
    __slots__ = ("key", "kind", "dtype", "length", "root", "start", "ext",
                 "off", "sidx", "esc")

    def __init__(self, key, kind, dtype, length=0, root=None, start=0,
                 ext=False):
        self.key = key
        self.kind = kind  # "plane" | "scalar"
        self.dtype = dtype
        self.length = length
        self.root = root  # slot id of the root this one views (itself)
        self.start = start
        self.ext = ext
        self.off = -1  # plane: float offset in the shared-memory arena
        self.sidx = -1  # root scalar: index in the per-row scalar array
        self.esc = -1  # root: index of its device-memory output


class Op:
    """One tape entry. ``args`` are the member kernel's arguments in order
    (``("slot", id, dtype)`` or ``("const", value)``), for the plain walk;
    ``ins``/``ip``/``dp`` its device operands and static parameters."""

    __slots__ = ("name", "code", "args", "outs", "ins", "ip", "dp", "step",
                 "plan")

    def __init__(self, name, code, args, outs, step=None):
        self.name = name
        self.code = code
        self.args = args
        self.outs = outs
        self.ins: list = []  # slot ids, or ("const", float) scalar operands
        self.ip: list = []
        self.dp: list = []
        self.step = step  # the member step, whose kernel the plain walk calls
        self.plan = 0  # ip[IP_PLAN]: bit 0, a block barrier before the op


class TileProgram:
    """A lowered group: slots, ops, the escapes and the shared-memory plan."""

    def __init__(self):
        self.slots: list[Slot] = []
        self.by_key: dict[str, int] = {}
        self.ops: list[Op] = []
        self.taps: list[np.ndarray] = []
        self.n_taps = 0
        self.ext_keys: list[str] = []  # external inputs, by ext index
        self.escapes: dict[str, int] = {}  # escaping key -> slot
        self.esc_roots: list[int] = []  # root slots stored, by esc index
        self.n_scal = 0
        self.scratch_dbl = 0
        self.arena_floats = 0
        self.tape_dbl = 0  # shared memory: where the tape's copy starts
        self.n_dpar = 0
        self.n_code = 0
        self.smem_bytes = 0
        self.f64 = False  # float64 planes: K7's float64 kernel runs it
        self._dev: dict = {}

    # -- slots -------------------------------------------------------------

    def new_slot(self, key, kind, dtype, length=0, root=None, start=0,
                 ext=False) -> int:
        if key in self.by_key:
            raise LoweringError(f"{key} is written twice in one group")
        sid = len(self.slots)
        s = Slot(key, kind, dtype, length, sid if root is None else root,
                 start, ext)
        self.slots.append(s)
        self.by_key[key] = sid
        return sid

    def slot_of(self, key) -> int:
        try:
            return self.by_key[key]
        except KeyError:
            raise LoweringError(f"{key} is neither an input nor written") from None

    def root(self, sid) -> Slot:
        return self.slots[self.slots[sid].root]

    # -- device encoding ---------------------------------------------------

    def encode(self):
        """``(ints, doubles, taps)``: the tape as the kernel reads it."""
        ints = np.zeros(len(self.ops) * OP_INTS + len(self.slots) * SLOT_INTS,
                        np.int32)
        dbls = np.zeros(max(1, len(self.ops) * OP_DP), np.float64)
        for k, op in enumerate(self.ops):
            rec = ints[k * OP_INTS : (k + 1) * OP_INTS]
            rec[0] = op.code
            dps = list(op.dp)
            ins = []
            for e in op.ins:
                if isinstance(e, tuple):  # a constant scalar operand
                    ins.append(-1 - len(dps))
                    dps.append(float(e[1]))
                else:
                    ins.append(e)
            rec[1 : 1 + OP_IN] = -(2**30)
            rec[1 : 1 + len(ins)] = ins
            rec[1 + OP_IN : 1 + OP_IN + OP_OUT] = -(2**30)
            rec[1 + OP_IN : 1 + OP_IN + len(op.outs)] = op.outs
            rec[1 + OP_IN + OP_OUT : 1 + OP_IN + OP_OUT + len(op.ip)] = op.ip
            rec[1 + OP_IN + OP_OUT + IP_PLAN] = op.plan
            dbls[k * OP_DP : k * OP_DP + len(dps)] = dps
        base = len(self.ops) * OP_INTS
        for sid, s in enumerate(self.slots):
            r = self.root(sid)
            ints[base + sid * SLOT_INTS : base + (sid + 1) * SLOT_INTS] = [
                0 if s.kind == "plane" else 1,
                SLOT_TYPES[s.dtype],
                r.off + _plane_words(s, s.start, self.f64) if r.off >= 0 else -1,
                s.length,
                r.sidx,
                self.ext_keys.index(r.key) if r.ext and s.root == sid else -1,
                r.esc if s.root == sid else -1,
                s.root,
            ]
        taps = (np.concatenate(self.taps).astype(np.float32) if self.taps
                else np.zeros(1, np.float32))
        return ints, dbls, taps


# ---------------------------------------------------------------------------
# lowering
# ---------------------------------------------------------------------------

_FLOATS = (torch.float32, torch.float64)
_SCALARS = tuple(SLOT_TYPES)  # the types a per-row scalar slot may hold


def _add_ext(prog: TileProgram, key, v, lead) -> None:
    if not isinstance(v, torch.Tensor) or v.ndim not in (1, 2):
        raise LoweringError(f"input {key} is not a per-row scalar or plane")
    if v.shape[0] != lead:
        raise LoweringError(f"input {key} has {v.shape[0]} rows, not {lead}")
    if v.dtype not in (_FLOATS + (torch.bool,) if v.ndim == 2 else _SCALARS):
        raise LoweringError(f"input {key} is {v.dtype}, not floating")
    if v.ndim == 2:
        prog.new_slot(key, "plane", v.dtype, int(v.shape[1]), ext=True)
    else:
        prog.new_slot(key, "scalar", v.dtype, ext=True)
    prog.ext_keys.append(key)


def _fetch_keeps_shape(spec, shape) -> bool:
    """True when ``KernelStep._fetch`` leaves a value of ``shape`` as it is
    (no singleton axes inserted for broadcasting)."""
    return spec.reshape is None or _align_shape(spec.reshape, shape) == list(shape)


def _kernel_args(prog: TileProgram, step) -> list:
    """The step's arguments as tape operands. An elementwise member (a
    ufunc, ``where``) may take a per-row scalar along a plane."""
    if step.kwarg_specs or step.badrow_key is not None:
        raise LoweringError(f"{step.kernel.__name__}: keyword or badrow arguments")
    elementwise = step.kernel.__name__ in UFUNCS
    args = []
    for spec in step.arg_specs:
        if spec.kind == "const":
            args.append(("const", spec.value))
            continue
        sid = prog.slot_of(spec.key)
        s = prog.slots[sid]
        shape = (1, s.length) if s.kind == "plane" else (1,)
        if not (elementwise and s.kind == "scalar" or _fetch_keeps_shape(spec, shape)):
            raise LoweringError(f"{step.kernel.__name__}: a broadcast operand")
        want = _device_dtype(spec.dtype) if spec.dtype is not None else s.dtype
        if want not in _SCALARS:
            raise LoweringError(f"{step.kernel.__name__}: a {want} operand")
        args.append(("slot", sid, want))
    return args


def _out_slots(prog: TileProgram, step, bools=False, ints=False) -> list[int]:
    """The step's output slots in the member's types: float planes and
    scalars (bool scalars and planes with ``bools``, a comparison's; int64
    scalars with ``ints``)."""
    outs = []
    for sp in step.out_specs:
        dt = _device_dtype(sp.dtype)
        ok = _FLOATS + (torch.bool,) * bools + (torch.int64,) * ints
        if (dt not in ok or not isinstance(sp.shape, tuple) or len(sp.shape) > 1
                or (dt == torch.int64 and len(sp.shape))):
            raise LoweringError(f"{step.kernel.__name__}: output {sp.key} "
                                f"is not a float scalar or plane")
        if len(sp.shape) == 1:
            outs.append(prog.new_slot(sp.key, "plane", dt, int(sp.shape[0])))
        else:
            outs.append(prog.new_slot(sp.key, "scalar", dt))
    return outs


def _plane(prog, arg, what, dtypes=_FLOATS) -> int:
    """A plane operand, read in its slot's own type, one of ``dtypes``."""
    if arg[0] != "slot" or prog.slots[arg[1]].kind != "plane":
        raise LoweringError(f"{what} must be a plane")
    if arg[2] not in dtypes or prog.slots[arg[1]].dtype != arg[2]:
        names = "/".join(str(d).removeprefix("torch.") for d in dtypes)
        raise LoweringError(f"{what}: K7 reads {names} planes in their own type, "
                            f"not {prog.slots[arg[1]].dtype} as {arg[2]}")
    return arg[1]


def _plane_words(s: Slot, samples=None, wide=False) -> int:
    """The 32-bit words of the arena a plane slot spans (or ``samples`` of
    it): two a sample for a float64 plane, and for every plane of a float64
    program (``wide``: its bool planes hold doubles)."""
    n = s.length if samples is None else samples
    return n * (2 if wide or s.dtype == torch.float64 else 1)


def _taps64(prog: TileProgram, values) -> int:
    """``values`` in float64 into the taps, as pairs of words from an even
    word (8 bytes); returns their offset in words."""
    if prog.n_taps % 2:
        prog.taps.append(np.zeros(1, np.float32))
        prog.n_taps += 1
    off = prog.n_taps
    prog.taps.append(np.asarray(values, np.float64).view(np.float32))
    prog.n_taps += 2 * len(values)
    return off


def _scalar(prog, arg, what, types=_FLOATS):
    """A scalar operand: a slot id, read as one of ``types``, or ("const",
    float)."""
    if arg[0] == "slot":
        if prog.slots[arg[1]].kind != "scalar":
            raise LoweringError(f"{what} must be a per-row scalar")
        want = prog.slots[arg[1]].dtype if arg[2] is None else arg[2]
        if want not in types:
            raise LoweringError(f"{what}: a {want} operand")
        return arg[1]
    v = arg[1]
    if isinstance(v, (np.ndarray, torch.Tensor)) and np.ndim(v) > 0:
        raise LoweringError(f"{what} must be a scalar")
    try:
        return ("const", float(v))
    except (TypeError, ValueError):
        raise LoweringError(f"{what} must be numeric") from None


def _static(arg, what):
    if arg[0] != "const" or np.ndim(arg[1]) != 0:
        raise LoweringError(f"{what} must be a constant")
    return arg[1]


def _f32(arg) -> int:
    """1 where an argument's type is float32: a scalar operand of that type
    is rounded to float32 before use (the ``ip[7]`` mask of an op, bit k
    for operand k)."""
    if arg[0] == "slot":
        return int(arg[2] == torch.float32)
    return int(np.asarray(arg[1]).dtype == np.float32)


def _row32(prog: TileProgram, x: Op) -> int:
    """1 where op ``x``'s row (its first operand, a plane) is float32: the
    member then casts its scalars to float32, else to float64."""
    return int(prog.slots[x.ins[0]].dtype == torch.float32)


def _lower_kernel(prog: TileProgram, step) -> None:
    name = step.kernel.__name__
    args = _kernel_args(prog, step)
    outs = _out_slots(prog, step, bools=name in BOOL_UFUNCS or name == "where",
                      ints=name in UFUNCS or name in REDUCTIONS)
    o = [prog.slots[s] for s in outs]
    kinds = tuple(s.kind for s in o)

    def op(code_name):
        x = Op(f"{name}[{step.name}]", OPCODES[code_name], args, outs, step)
        prog.ops.append(x)
        return x

    def need(cond, why):
        if not cond:
            raise LoweringError(f"{name}: {why}")

    if name == "min_max":
        need(len(args) == 1 and kinds == ("scalar",) * 4, "signature")
        op("min_max").ins = [_plane(prog, args[0], name)]
    elif name == "bl_subtract":
        need(len(args) == 2 and kinds == ("plane",), "signature")
        x = op("bl_subtract")
        x.ins = [_plane(prog, args[0], name), _scalar(prog, args[1], "baseline")]
        x.ip = [0] * 7 + [_f32(args[1]) << 1]
    elif name == "linear_slope_fit":
        need(len(args) == 1 and kinds == ("scalar",) * 4, "signature")
        op("linear_slope_fit").ins = [_plane(prog, args[0], name)]
    elif name == "pole_zero":
        need(len(args) == 2 and kinds == ("plane",), "signature")
        tau = float(_static(args[1], "tau"))
        x = op("pole_zero")
        x.ins = [_plane(prog, args[0], name)]
        x.ip = [int(np.isnan(tau))]
        x.dp = [float(-np.expm1(-1.0 / tau)) if tau != 0 else 1.0]
    elif name == "double_pole_zero":
        need(len(args) == 4 and kinds == ("plane",), "signature")
        w = _plane(prog, args[0], name)
        tau1, tau2, frac = (float(_static(a, "a time constant or fraction"))
                            for a in args[1:])
        n = prog.slots[w].length
        need(n > 3 and o[0].length == n, "a row of more than 3 samples")
        k = dpz_constants(tau1, tau2, frac)
        x = op("double_pole_zero")
        x.ins = [w]
        x.ip = [prog.n_taps, int(np.isnan([tau1, tau2, frac]).any())]
        x.dp = [float(k["p"]), float(k["k1"]), float(k["k2"])]
        # the correction's factors in the row's type, then p**i from float64
        # (the JAX package's np.power), rounded likewise
        with np.errstate(invalid="ignore", over="ignore"):
            table = np.concatenate([[k["ke"], k["kd"]], dpz_powers(k["p"], n)])
        if prog.slots[w].dtype == torch.float64:
            x.ip[0] = _taps64(prog, table)
        else:
            prog.taps.append(table.astype(np.float32))
            prog.n_taps += n + 2
    elif name in TRAP_KINDS:
        kind = TRAP_KINDS[name]
        sec = [int(_static(a, "a trapezoid section")) for a in args[1:]]
        need(kinds == ("plane",) and len(sec) == (3 if kind == 1 else 2), "signature")
        rise, flat = sec[0], sec[1]
        fall = sec[2] if kind == 1 else rise
        n = prog.slots[_plane(prog, args[0], name)].length
        need(rise >= 1 and flat >= 0 and fall >= 1
             and rise + flat + fall <= n, "sections out of range")
        x = op("trap")
        x.ins = [args[0][1]]
        x.ip = [kind, rise, flat, fall]
    elif name in ("moving_window_left", "moving_window_right"):
        need(len(args) == 2 and kinds == ("plane",), "signature")
        w = _plane(prog, args[0], name)
        n = prog.slots[w].length
        ln = float(_static(args[1], "length"))
        need(0 <= ln < n and o[0].length == n, "length out of range")
        x = op("moving_window")
        x.ins = [w]
        # ip[0]: the right window; ip[1] the ramp's samples, int(length);
        # the division by the length itself, in float64
        x.ip = [int(name == "moving_window_right"), int(ln)]
        x.dp = [ln]
    elif name == "amax":
        need(len(args) == 2 and kinds == ("scalar",)
             and len(step.kernel.dims_list[0]) == 1
             and int(_static(args[1], "axis")) == 1, "a reduction of the row")
        op("amax").ins = [_plane(prog, args[0], name)]
    elif name in ("convolve_wf", "fft_convolve_wf"):
        need(len(args) == 3 and kinds == ("plane",), "signature")
        w = _plane(prog, args[0], name)
        kern = args[1][1] if args[1][0] == "const" else None
        need(isinstance(kern, np.ndarray) and kern.ndim == 1, "taps not constant")
        n, m = prog.slots[w].length, int(kern.shape[-1])
        ch = chr(int(_static(args[2], "mode")))
        need(ch in "fvs" and 1 <= m <= n, "a mode and taps no longer than the row")
        lo, p = _mode_window(ch, n, m)
        need(not np.isnan(kern).any() and o[0].length == p, "NaN taps")
        # the direct route (m <= 32, _conv_full_direct's order) or the banded
        need(m <= 32 or p * m <= _MATMUL_MAC_LIMIT, "only the FFT route fits")
        x = op("conv_direct" if m <= 32 else "conv")
        x.ins = [w]
        # the taps in the row's type, as the member casts them
        if prog.slots[w].dtype == torch.float64:
            x.ip = [_taps64(prog, kern), m, lo]
        else:
            x.ip = [prog.n_taps, m, lo]
            prog.taps.append(np.asarray(kern, np.float32))
            prog.n_taps += m
    elif name == "reflected_convolve_wf":
        need(len(args) == 2 and kinds == ("plane",), "signature")
        # a plane read in the step's type: float64 taps make the step (and
        # its output) float64; a float32 plane so read is widened exactly, a
        # float64 one (a float64 program's) read as it is
        need(args[0][0] == "slot" and prog.slots[args[0][1]].kind == "plane"
             and prog.slots[args[0][1]].dtype in (torch.float32, o[0].dtype)
             and o[0].dtype == args[0][2],
             "a float32 plane, or one of its output's type, read in that type")
        w = args[0][1]
        kern = args[1][1] if args[1][0] == "const" else None
        need(isinstance(kern, np.ndarray) and kern.ndim == 1, "taps not constant")
        n, m = prog.slots[w].length, int(kern.shape[-1])
        need(1 <= m <= 32 and not np.isnan(kern).any(),
             "only the direct route (m <= 32 NaN-free taps) has an op")
        # one reflection of the edge: a pad of m // 2 + 1 shorter than the row
        need(m <= n and m // 2 + 1 < n and o[0].length == n,
             "a row no longer than its reflected edge")
        x = op("reflected_conv")
        x.ins = [w]
        if o[0].dtype == torch.float64:
            x.ip = [_taps64(prog, kern), m]
        else:
            x.ip = [prog.n_taps, m]
            prog.taps.append(np.asarray(kern, np.float32))
            prog.n_taps += m
    elif name in ("time_point_thresh", "interpolated_time_point_thresh"):
        interp = name != "time_point_thresh"
        need(len(args) == 4 + interp and kinds == ("scalar",), "signature")
        walk = _static(args[3], "walk_forward")
        mode = int(_static(args[4], "mode_in")) if interp else 0
        need(not interp or chr(mode) in "iabrnlfc", "an interpolation mode")
        x = op("time_point_thresh")
        x.ins = [_plane(prog, args[0], name), _scalar(prog, args[1], "threshold"),
                 _scalar(prog, args[2], "t_start")]
        # ip[1]: the interpolation mode (0: time_point_thresh's integral
        # start and walk); the threshold in the row's type, as both cast it
        fwd = walk > 0 if interp else int(walk) == 1
        x.ip = [int(fwd), mode] + [0] * 5 + [_f32(args[0]) << 1 | _f32(args[2]) << 2]
    elif name in ("poly_diff", "poly_exp_rms"):
        need(len(args) == 2 and kinds == ("scalar", "scalar"), "signature")
        x = op("poly_residual")
        pars = _plane(prog, args[1], "poly_pars")
        x.ins = [_plane(prog, args[0], name), pars]
        x.ip = [int(name == "poly_exp_rms"), prog.slots[pars].length]
    elif name in ("soft_pileup_corr", "soft_pileup_corr_bl"):
        bl = name == "soft_pileup_corr_bl"
        need(len(args) == 3 + bl and kinds == ("plane",), "signature")
        w = _plane(prog, args[0], name)
        n = prog.slots[w].length
        nf = int(_static(args[1], "n_in"))
        need(2 <= nf <= n and o[0].length == n, "n_in out of range")
        # a constant tau: exp(-i/tau) over the row (float64 pairs of words
        # in the taps, on 8 bytes) and the fit's two sums that depend on it
        # alone, from the host (soft_pileup_corr.fit_constants)
        e, s2, s3 = fit_constants(n, nf, float(_static(args[2], "a constant tau")))
        tap = _taps64(prog, e.numpy())
        # two ops: the fit (its sums, one barrier) into two float64 per-row
        # scalars, A and B, then the row less the fit, one pass
        key = o[0].key
        fit = [prog.new_slot(f"{key}@fit_a", "scalar", torch.float64),
               prog.new_slot(f"{key}@fit_b", "scalar", torch.float64)]
        x = Op(f"{name}[{step.name}]:fit", OPCODES["soft_pileup"], args, fit, step)
        x.ins = [w] + ([_scalar(prog, args[3], "b_in")] if bl else [])
        x.ip = [nf, int(bl), tap] + [0] * 4 + [_f32(args[3]) << 1 if bl else 0]
        x.dp = [s2, s3]
        prog.ops.append(x)
        y = op("soft_pileup_out")
        y.ins = [w] + fit
        y.ip = [0, 0, tap]
    elif name == "wf_correction":
        need(len(args) == 4 and kinds == ("plane",), "signature")
        w = _plane(prog, args[0], name)
        n = prog.slots[w].length
        start, stop = (int(_static(a, "start_idx or stop_idx")) for a in args[2:])
        corr = args[1][1] if args[1][0] == "const" else None
        need(isinstance(corr, np.ndarray) and corr.ndim == 1, "a constant correction array")
        need(0 <= start < stop <= n and stop - start <= corr.shape[0] and o[0].length == n,
             "a window out of range")
        x = op("wf_correction")
        x.ins = [w]
        # the correction in the row's type, in the taps; a NaN in it
        # poisons every row
        nan = int(np.isnan(corr.astype(np.float64)).any())
        if o[0].dtype == torch.float64:
            x.ip = [start, stop, _taps64(prog, corr), nan]
        else:
            x.ip = [start, stop, prog.n_taps, nan]
            prog.taps.append(corr.astype(np.float32))
            prog.n_taps += corr.shape[0]
    elif name == "get_wf_centroid":
        need(len(args) == 2 and kinds == ("scalar",), "signature")
        x = op("wf_centroid")
        x.ins = [_plane(prog, args[0], name), _scalar(prog, args[1], "shift")]
        # the shift's type decides the midpoint's (int + float32 in float32)
        x.ip = [0] * 7 + [_f32(args[1]) << 1]
    elif name in INJECT_KINDS:
        kind, npar = INJECT_KINDS[name]
        need(len(args) == 1 + npar and kinds == ("plane",), "signature")
        w = _plane(prog, args[0], name)
        need(o[0].length == prog.slots[w].length, "a row as long as its input")
        wide = prog.slots[w].dtype == torch.float64
        # the constant parameters in the row's type (as _bparam rounds them)
        # in the taps, in the function's own order; one a row as operands,
        # rounded to a float32 row's type
        vec = np.zeros(6, np.float64 if wide else np.float32)
        ins, mask = [w], 0
        for q, a in enumerate(args[1:]):
            v = _scalar(prog, a, "a pulse parameter")
            if isinstance(v, tuple):
                vec[q] = v[1]
            else:
                ins.append(v)
                mask |= 1 << q
        need(len(ins) <= OP_IN, "too many parameters given one a row")
        x = op("inject")
        x.ins = ins
        if wide:
            tap = _taps64(prog, vec)
        else:
            tap = prog.n_taps
            prog.taps.append(vec)
            prog.n_taps += 6
        x.ip = [kind, tap, mask] + [0] * 4 + [0 if wide else (1 << len(ins)) - 2]
        x.dp = [float(_LOG99x4)]
    elif name in DENSE_KINDS:
        kind = DENSE_KINDS[name]
        w = _plane(prog, args[0], name)
        n = prog.slots[w].length
        wide = prog.slots[w].dtype == torch.float64

        def const_array(arg, shape, what):
            v = arg[1] if arg[0] == "const" else None
            if isinstance(v, torch.Tensor):
                v = v.cpu().numpy()
            need(isinstance(v, np.ndarray) and v.shape == shape,
                 f"{what}: a constant array of shape {shape}")
            return v.astype(np.float64 if wide else np.float32)

        def tap(arr):
            # the constants in the row's type (float64: pairs of words)
            if wide:
                return _taps64(prog, arr.reshape(-1))
            off = prog.n_taps
            prog.taps.append(arr.reshape(-1))
            prog.n_taps += arr.size
            return off

        x = op("dense")
        x.ins = [w]
        if kind == 0:
            need(len(args) == 3 and kinds == ("plane",) and o[0].length == n,
                 "signature")
            x.ip = [0, 0, tap(const_array(args[1], (n,), "means")),
                    tap(const_array(args[2], (n,), "variances"))]
        else:
            bias = name.endswith("with_bias")
            need(len(args) == 3 + bias, "signature")
            flag = activation_flag(_static(args[-1], "activation_func"), name)
            m = o[0].length if kind == 1 else 1
            need(kinds == (("plane",) if kind == 1 else ("scalar",)), "signature")
            wts = tap(const_array(args[1], (n, m) if kind == 1 else (n,), "weights"))
            b_tap = (tap(const_array(args[2], (m,), "bias")) if bias and kind == 1
                     else -1)
            scal = int(bias and kind == 2)
            if scal:
                x.ins.append(_scalar(prog, args[2], "bias"))
            x.ip = [kind, flag, wts, b_tap, 0, m, scal,
                    _f32(args[2]) << 1 if scal and not wide else 0]
    elif name == "windower":
        need(len(args) == 2 and kinds == ("plane",), "signature")
        w = _plane(prog, args[0], name)
        need(o[0].length < prog.slots[w].length, "window not shorter than the row")
        x = op("windower")
        x.ins = [w, _scalar(prog, args[1], "t0")]
        x.ip = [0] * 7 + [_f32(args[1]) << 1]
    elif name == "avg_current":
        need(len(args) == 2 and kinds == ("plane",), "signature")
        w = _plane(prog, args[0], name, _FLOATS)
        need(o[0].dtype == prog.slots[w].dtype, "mixed plane types")
        ln = float(_static(args[1], "length"))
        need(0 <= ln < prog.slots[w].length, "length out of range")
        x = op("avg_current")
        x.ins = [w]
        x.ip = [int(ln)]
        # true_div divides by it in the row's type
        x.dp = [ln if o[0].dtype == torch.float64 else float(np.float32(ln))]
    elif name == "moving_window_multi":
        need(len(args) == 4 and kinds == ("plane",), "signature")
        w = _plane(prog, args[0], name)
        ln, num, mtype = (float(_static(a, "a window parameter")) for a in args[1:])
        need(ln == int(ln) and num == int(num) and 1 <= ln < prog.slots[w].length
             and num >= 0 and int(mtype) in (0, 1, 2), "parameters out of range")
        x = op("moving_window_multi")
        x.ins = [w]
        x.ip = [int(ln), int(num), int(mtype)]
    elif name == "fixed_time_pickoff":
        need(len(args) == 3 and kinds == ("scalar",), "signature")
        mode = chr(int(_static(args[2], "mode")))
        need(mode in FTP_MODES, f"mode {mode!r} has no op")
        x = op("fixed_time_pickoff")
        x.ins = [_plane(prog, args[0], name), _scalar(prog, args[1], "t_in")]
        # the pick time in the row's type, as the kernel casts it
        x.ip = [ord(mode)] + [0] * 6 + [_f32(args[0]) << 1]
    elif name in ("mean_below_threshold", "time_over_threshold"):
        need(len(args) == 2 and kinds == ("scalar",), "signature")
        mean = name == "mean_below_threshold"
        x = op(name if mean else "count")
        x.ins = [_plane(prog, args[0], name), _scalar(prog, args[1], "a_threshold")]
        # ip[0]: the count's kind (0: samples above); the threshold in the
        # row's type, as the member casts it
        x.ip = [0] * 7 + [2 * _row32(prog, x)]
    elif name == "saturation":
        need(len(args) == 2 and kinds == ("scalar", "scalar"), "signature")
        bd = _static(args[1], "bit_depth_in")
        need(float(bd) == int(bd) and 0 < int(bd) <= 64, "a positive integral bit depth")
        x = op("count")
        x.ins = [_plane(prog, args[0], name)]
        # kind 1: samples at 0 and at the high rail, in the row's type
        x.ip = [1]
        rail = 2 ** int(bd) - int(bd)
        x.dp = [float(np.float32(rail)) if _row32(prog, x) else float(rail)]
    elif name == "presum":
        need(len(args) == 2 and kinds == ("scalar", "plane"), "signature")
        w = _plane(prog, args[0], name)
        n, m = prog.slots[w].length, o[1].length
        dn = _static(args[1], "do_norm")
        need(int(dn) in (0, 1) and 1 <= m <= n, "do_norm or the output's length")
        x = op("presum")
        x.ins = [w]
        x.ip = [int(dn), n // m]
    elif name == "log_check":
        need(len(args) == 1 and kinds == ("plane",), "signature")
        w = _plane(prog, args[0], name)
        need(o[0].length == prog.slots[w].length, "a row as long as its input")
        op("log_check").ins = [w]
    elif name == "trap_pickoff":
        need(len(args) == 4 and kinds == ("scalar",), "signature")
        w = _plane(prog, args[0], name)
        rise, flat = (int(_static(a, "a trapezoid section")) for a in args[1:3])
        need(rise >= 1 and flat >= 0 and 2 * rise + flat <= prog.slots[w].length,
             "sections out of range")
        x = op("trap_pickoff")
        x.ins = [w, _scalar(prog, args[3], "t_pickoff")]
        x.ip = [rise, flat] + [0] * 5 + [_f32(args[3]) << 1]
    elif name == "min_max_norm":
        need(len(args) == 3 and kinds == ("plane",), "signature")
        w = _plane(prog, args[0], name)
        need(o[0].length == prog.slots[w].length, "a row as long as its input")
        x = op("min_max_norm")
        x.ins = [w, _scalar(prog, args[1], "a_min"), _scalar(prog, args[2], "a_max")]
        # the extrema in the row's type
        x.ip = [0] * 7 + [6 * _row32(prog, x)]
    elif name == "linear_slope_diff":
        need(len(args) == 3 and kinds == ("scalar", "scalar"), "signature")
        x = op("linear_slope_diff")
        x.ins = [_plane(prog, args[0], name), _scalar(prog, args[1], "slope"),
                 _scalar(prog, args[2], "intercept")]
        x.ip = [0] * 7 + [_f32(args[1]) << 1 | _f32(args[2]) << 2]
    elif name in ("get", "get_default"):
        dflt = name == "get_default"
        need(len(args) == 2 + dflt and kinds == ("scalar",), "signature")
        x = op("get")
        # the index: an int64 slot, or a constant (in the tape's doubles)
        x.ins = [_plane(prog, args[0], name),
                 _scalar(prog, args[1], "the index", (torch.int64,))]
        if dflt:
            x.ins.append(_scalar(prog, args[2], "the default"))
        # ip[0]: get_default; its default in the row's type
        x.ip = [int(dflt)] + [0] * 6 + [4 * dflt * _row32(prog, x)]
    elif name == "multi_a_filter":
        need(len(args) == 2 and kinds == ("plane",), "signature")
        vt = _plane(prog, args[1], "vt_max_in")
        need(o[0].length == prog.slots[vt].length, "an output as long as the indices")
        op("multi_a_filter").ins = [_plane(prog, args[0], name), vt]
    elif name in UFUNCS and kinds == ("plane",):
        _ewise(prog, step, name, UFUNCS[name], args, outs[0])
    elif name in REDUCTIONS:
        need(len(args) == 2 and kinds == ("scalar",)
             and len(step.kernel.dims_list[0]) == 1
             and int(_static(args[1], "axis")) == 1, "a reduction of the row")
        x = op("reduce")
        x.ins = [_plane(prog, args[0], name, _FLOATS + (torch.bool,))]
        x.ip = [REDUCTIONS[name]]
    elif name == "where":
        need(len(args) == 3 and kinds == ("scalar",), "per-row scalars")
        x = op("where")
        x.ins = [_scalar(prog, args[0], "condition", (torch.bool,)),
                 _scalar(prog, args[1], name), _scalar(prog, args[2], name)]
        x.ip = [0] * 7 + [_f32(args[1]) << 1 | _f32(args[2]) << 2]
    elif name in ROUNDERS:
        need(len(args) == 2 and kinds == ("scalar",), "signature")
        x = op("round")
        x.ins = [_scalar(prog, args[0], name), _scalar(prog, args[1], "to_nearest")]
        # in the value's (and output's) type: ip[1] float32, both operands
        # rounded to it
        f32 = int(o[0].dtype == torch.float32)
        x.ip = [ROUNDERS[name], f32] + [0] * 5 + [3 * f32]
    elif name in UFUNCS:
        kind = UFUNCS[name]
        nin = 1 if kind >= UNARY else 2
        need(len(args) == nin and kinds == ("scalar",)
             and step.kernel.signature == ",".join(["()"] * nin) + "->()",
             "a per-row scalar ufunc")
        _scalar_ufunc(prog, op("ufunc"), kind, args)
    else:
        raise LoweringError(f"{name} has no K7 op")


def _scalar_ufunc(prog: TileProgram, x: Op, kind: int, args) -> None:
    """The per-row ``ufunc`` op ``x`` of table entry ``kind`` on one or two
    scalar operands; ip[1] computes in float32 where every operand is
    float32 (a unary op's second operand is a constant 0)."""
    x.ins = [_scalar(prog, a, x.name, _SCALARS) for a in args]
    mask = sum(_f32(a) << q for q, a in enumerate(args))
    if mask not in (0, (1 << len(args)) - 1):
        raise LoweringError(f"{x.name}: mixed operand types")
    if len(args) == 1:
        x.ins.append(("const", 0.0))
    x.ip = [kind, int(mask != 0)] + [0] * 5 + [mask]


def _ewise(prog: TileProgram, step, name, kind, args, out, dp=()) -> None:
    """The plane ``ewise`` op of ``kind`` (a ufunc, ``where`` or a
    conversion) into the plane ``out``: each operand a float or bool plane
    as long as the output, a per-row scalar (along the row) or a constant.
    ip[1]: the member computes in float32 (no operand is read as float64);
    ip[2] the operands; ip[3] which are planes; ip[7] the scalars rounded
    to float32. A float64 plane among its operands or its output makes the
    program a float64 one (:func:`_plane_types` refuses a float32 plane
    there). Returns the op."""
    o = prog.slots[out]
    if o.dtype not in _FLOATS + (torch.bool,):
        raise LoweringError(f"K7 takes float and bool planes; {o.key} is {o.dtype}")
    x = Op(f"{name}[{step.name}]", OPCODES["ewise"], args, [out], step)
    planes = cast = f64 = 0
    for q, a in enumerate(args):
        s = prog.slots[a[1]] if a[0] == "slot" else None
        if s is not None and s.kind == "plane":
            if s.dtype not in _FLOATS + (torch.bool,) or s.length != o.length:
                raise LoweringError(f"{name}: K7 takes float or bool plane operands "
                                    f"as long as the output, not {s.length} "
                                    f"{s.dtype} samples into {o.length}")
            x.ins.append(a[1])
            planes |= 1 << q
        else:
            x.ins.append(_scalar(prog, a, name, _SCALARS))
            cast |= _f32(a) << q
        f64 |= a[0] == "slot" and a[2] == torch.float64
    x.ip = [kind, int(not f64), len(args), planes] + [0] * 3 + [cast]
    x.dp = list(dp)
    prog.ops.append(x)
    return x


def _lower_convert(prog: TileProgram, step) -> None:
    """A ConvertStep: the ``convert`` op (a per-row scalar, float or int64)
    or, for a float plane, the ``ewise`` op's conversion."""
    name = step.kernel.__name__
    if name not in CONVERTS:
        raise LoweringError(f"{name} has no K7 op")
    sid = prog.slot_of(step.in_key)
    s = prog.slots[sid]
    plane = s.kind == "plane"
    if s.dtype not in (_FLOATS if plane else _FLOATS + (torch.int64,)):
        raise LoweringError(f"{name}: K7 converts float planes and float or "
                            f"int64 per-row scalars, not {s.dtype}")
    dt = s.dtype
    out_var = step.out_var
    if out_var is not None and out_var.dtype is not auto:
        dt = _device_dtype(out_var.dtype)
        if dt not in (_FLOATS if plane else _FLOATS + (torch.int64,)):
            raise LoweringError(f"{name}: a {dt} output")
    args = [("slot", sid, s.dtype)]
    for off in (step.from_offset, step.to_offset):
        args.append(("slot", prog.slot_of(off), None) if isinstance(off, str)
                    else ("const", off))
    args.append(("const", step.ratio))
    if plane:
        out = prog.new_slot(step.out_key, "plane", dt, s.length)
        # the ratio in the tape's doubles; the plain walk calls the member
        # with all four arguments
        _ewise(prog, step, name, EW_CONVERT + CONVERTS[name], args[:3], out,
               [float(step.ratio)]).args = args
        return
    out = prog.new_slot(step.out_key, "scalar", dt)
    x = Op(f"{name}[{step.out_key}]", OPCODES["convert"], args, [out], step)
    x.ins = [sid] + [_scalar(prog, a, "an offset") for a in args[1:3]]
    # ip[0]: the kind; ip[1] a float32 input, rounded back to it
    x.ip = [CONVERTS[name], int(s.dtype == torch.float32)]
    x.dp = [float(step.ratio)]
    prog.ops.append(x)


def _lower_step(prog: TileProgram, step) -> None:
    if isinstance(step, AliasStep):
        src = prog.slot_of(step.src_key)
        s = prog.slots[src]
        prog.new_slot(step.dst_key, s.kind, s.dtype, s.length, s.root, s.start)
    elif isinstance(step, SliceStep):
        src = prog.slot_of(step.src_key)
        s = prog.slots[src]
        sl = step.sl
        if s.kind != "plane" or not isinstance(sl, slice) or sl.step not in (None, 1):
            raise LoweringError(f"{step.name}: only unit-step slices of a plane")
        a, b, _ = sl.indices(s.length)
        if b <= a:
            raise LoweringError(f"{step.name}: an empty slice")
        prog.new_slot(step.out_key, "plane", s.dtype, b - a, s.root, s.start + a)
    elif isinstance(step, ConvertStep):
        _lower_convert(prog, step)
    elif isinstance(step, KernelStep):
        _lower_kernel(prog, step)
    else:
        raise LoweringError(f"{type(step).__name__} {step} has no K7 op")


def _plane_types(prog: TileProgram) -> None:
    """Whether ``prog`` is a float64 program (``prog.f64``: a float64 plane
    loaded, read by ``reflected_conv``, or read or written by an op other
    than the SiPM pair of :data:`F32_PROGRAM_F64_OPS`), and that its planes
    are all of its kernel's types: a float64 program's float64, or bool (a comparison's,
    held as doubles 1.0 and 0.0), and its ops all of :data:`F64_OPS`; a
    float program's float64 planes whole."""
    names = {v: k for k, v in OPCODES.items()}

    def f64(sid):
        sl = prog.slots[sid]
        return sl.kind == "plane" and sl.dtype == torch.float64

    def wide(op):
        if names[op.code] == "reflected_conv":  # a float64 row, not a float32 one
            return f64(op.ins[0])
        return names[op.code] not in F32_PROGRAM_F64_OPS and any(
            f64(e) for e in op.outs + [e for e in op.ins if not isinstance(e, tuple)])

    prog.f64 = any(s.ext and f64(sid) for sid, s in enumerate(prog.slots)) or any(
        wide(op) for op in prog.ops)
    for sid, s in enumerate(prog.slots):
        if s.kind != "plane":
            continue
        if prog.f64 and s.dtype not in (torch.float64, torch.bool):
            raise LoweringError(f"K7's float64 programs take float64 and bool planes; "
                                f"{s.key} is {s.dtype}")
        if not prog.f64 and f64(sid) and (s.start, s.length) != (
                0, prog.slots[s.root].length):
            raise LoweringError(f"{s.key}: a slice of a float64 plane in a float program")
    if prog.f64:
        for op in prog.ops:
            if names[op.code] not in F64_OPS:
                raise LoweringError(f"{op.name}: K7 runs {names[op.code]} on float32 "
                                    f"planes only (it has no float64 form)")


def _plan(prog: TileProgram) -> None:
    """Loads, scalar places, plane places (first fit over live ranges) and
    the block's shared memory; refuses a plan over one block's."""
    # an external plane is loaded just before its first reader
    ops = []
    loaded = set()
    for op in prog.ops:
        for e in op.ins:
            if isinstance(e, tuple):
                continue
            r = prog.slots[e].root
            if prog.slots[r].ext and prog.slots[r].kind == "plane" and r not in loaded:
                loaded.add(r)
                ld = Op(f"load[{prog.slots[r].key}]", OPCODES["load"], [], [r])
                ld.ins = [r]
                ops.append(ld)
        ops.append(op)
    prog.ops = ops
    for op in ops:
        n_const = sum(isinstance(e, tuple) for e in op.ins)
        if (len(op.ins) > OP_IN or len(op.outs) > OP_OUT or len(op.ip) > OP_IP
                or len(op.dp) + n_const > OP_DP):
            raise LoweringError(f"{op.name}: too many operands for a tape record")
        # the plan's field is free in every record
        assert len(op.ip) <= IP_PLAN or not op.ip[IP_PLAN], op.name

    # live range [def, last read] of each root plane, in op order
    first, last = {}, {}
    for k, op in enumerate(ops):
        for sid in op.outs:
            r = prog.slots[sid].root
            if prog.slots[r].kind == "plane":
                first.setdefault(r, k)
                last.setdefault(r, k)
        if op.code == OPCODES["load"]:
            continue
        for e in op.ins:
            if not isinstance(e, tuple):
                r = prog.slots[e].root
                if prog.slots[r].kind == "plane":
                    last[r] = max(last[r], k)
    free: list[tuple[int, int]] = []  # (offset, size) holes
    live: dict[int, tuple[int, int]] = {}
    top = 0

    def alloc(size):
        nonlocal top
        size = -(-size // ALIGN) * ALIGN
        for j, (off, sz) in enumerate(free):
            if sz >= size:
                free[j] = (off + size, sz - size)
                return off
        if free and free[-1][0] + free[-1][1] == top:  # grow the top hole
            off = free.pop()[0]
        else:
            off = top
        top = off + size
        return off

    def release(off, size):
        size = -(-size // ALIGN) * ALIGN
        free.append((off, size))
        free.sort()
        merged = []
        for o_, s_ in free:
            if merged and merged[-1][0] + merged[-1][1] == o_:
                merged[-1] = (merged[-1][0], merged[-1][1] + s_)
            elif s_:
                merged.append((o_, s_))
        free[:] = merged

    for k in range(len(ops)):
        # a moving window whose input plane dies here runs in that plane's
        # space: its stages rewrite their row in place anyway
        op = ops[k]
        if op.code == OPCODES["moving_window_multi"]:
            src = prog.slots[op.ins[0]]
            r, o = src.root, op.outs[0]
            if (last[r] == k and src.start == 0
                    and src.length == prog.slots[r].length
                    and prog.slots[o].length == src.length):
                prog.slots[o].off = prog.slots[r].off
                live[o] = live.pop(r)
        for r, d in first.items():
            if d == k and r not in live:
                words = _plane_words(prog.slots[r], wide=prog.f64)
                prog.slots[r].off = alloc(words)
                live[r] = (prog.slots[r].off, words)
        for r in [r for r in live if last[r] == k]:
            release(*live.pop(r))
    prog.arena_floats = top

    # per-row scalars (an even count, so that the scratch after them starts
    # on 16 bytes), and the scratch the ops need: a float64 prefix of the
    # row (with a pad double after every 16 where the scan's runs are of an
    # even length), double_pole_zero's float64 runs, or the convolution's
    # zero-padded window (the outputs and the taps' 32-tap chunks, with the
    # 16-byte loads' tail) and its taps padded to 4
    for sid, s in enumerate(prog.slots):
        if s.root == sid and s.kind == "scalar":
            s.sidx = prog.n_scal
            prog.n_scal += 1
    prog.n_scal += prog.n_scal % 2
    scratch = 0
    for op in ops:
        if op.code in (OPCODES["trap"], OPCODES["moving_window_multi"],
                       OPCODES["trap_pickoff"], OPCODES["moving_window"]):
            n = prog.slots[op.ins[0]].length
            even = -(-n // THREADS) % 2 == 0  # runs of an even length
            scratch = max(scratch, n + ((n >> 4) + 1 if even else 0))
        elif op.code == OPCODES["double_pole_zero"]:
            # the runs' float64 recurrence
            scratch = max(scratch, prog.slots[op.ins[0]].length)
        elif op.code == OPCODES["dense"] and op.ip[0]:
            # each warp's partial sums of the m outputs
            scratch = max(scratch, (THREADS // 32) * op.ip[5])
        elif op.code == OPCODES["conv"] and prog.f64:
            # the row's window and the taps, in float64
            p, m = prog.slots[op.outs[0]].length, op.ip[1]
            scratch = max(scratch, p + 2 * m - 1)
        elif op.code == OPCODES["conv"]:
            p, m = prog.slots[op.outs[0]].length, op.ip[1]
            mc = -(-m // 32) * 32
            span = -(-(p + mc + 4) // 4) * 4
            scratch = max(scratch, -(-(span + -(-m // 4) * 4) // 2))
    prog.scratch_dbl = scratch + scratch % 2
    _barriers(prog)
    # then the tape's copy, its doubles on 8 bytes, then its ints
    prog.n_code = len(ops) * OP_INTS + len(prog.slots) * SLOT_INTS
    prog.n_dpar = max(1, len(ops) * OP_DP)
    prog.tape_dbl = -(-(8 * (prog.n_scal + prog.scratch_dbl)
                        + 4 * (prog.arena_floats + len(prog.slots))) // 8)
    prog.smem_bytes = 8 * (prog.tape_dbl + prog.n_dpar) + 4 * prog.n_code
    if prog.n_code > GEN_MAX_CODE or prog.n_dpar > GEN_MAX_DP:
        raise LoweringError(
            f"a tape of {len(ops)} ops and {len(prog.slots)} slots; K7's "
            f"parameters hold {GEN_MAX_CODE} ints and {GEN_MAX_DP} doubles"
        )
    if prog.smem_bytes + STATIC_SMEM > _MAX_SMEM:
        raise LoweringError(
            f"the plan needs {prog.smem_bytes} bytes of shared memory; one "
            f"block holds at most {_MAX_SMEM - STATIC_SMEM}"
        )


def _barriers(prog: TileProgram) -> None:
    """The barrier plan: ``op.plan`` = 1 on each op that must wait at a
    block barrier. An op waits when, since the last barrier, another thread
    wrote what it reads (a plane and its flag word: ``reflected_conv`` reads
    each output's neighbours and the reflected edges, written by other
    threads; or for an op of the
    whole block a scalar that warp 0 stored), or read or wrote the arena or
    scratch space that it writes before its own first barrier, or still
    reads the reduction buffer that it takes first. Ops of ``WARP_OPS`` run
    on warp 0 alone, and read what warp 0 stored after a ``__syncwarp``. An
    op of ``BARRIERED_OPS`` settles, at its own barrier, everything before
    it; what it does after that barrier stays pending."""
    slots = prog.slots
    names = {v: k for k, v in OPCODES.items()}
    planes: set = set()  # root planes written, with their flag words
    scalars: set = set()  # root scalars stored by warp 0
    spans: list = []  # arena [lo, hi) read or written
    scratch = False  # the scratch read or written
    late = 0  # reduction buffers read after the last barrier

    def span(sid):
        s = slots[sid]
        lo = slots[s.root].off + _plane_words(s, s.start, prog.f64)
        return lo, lo + _plane_words(s, wide=prog.f64)

    def overlaps(a):
        return any(a[0] < b[1] and b[0] < a[1] for b in spans)

    for op in prog.ops:
        name = names[op.code]
        warp = name in WARP_OPS
        ins = [] if name == "load" else [e for e in op.ins if not isinstance(e, tuple)]
        in_planes = [e for e in ins if slots[e].kind == "plane"]
        out_planes = [o for o in op.outs if slots[o].kind == "plane"]
        products = name == "dense" and op.ip[0] != 0  # a dense or classification
        uses_scratch = products or name in SCRATCH_OPS
        own_barrier = products or name in BARRIERED_OPS
        need = any(slots[e].root in planes for e in in_planes)
        need |= not warp and any(slots[e].root in scalars for e in ins
                                 if slots[e].kind == "scalar")
        if not own_barrier:
            # writes before any barrier of the op's own
            need |= any(overlaps(span(o)) for o in out_planes)
        if name == "conv" or products:  # stage in the scratch before their barrier
            need |= scratch
        if name in LATE_REDUCTION_READS:  # of two buffers
            need |= late > 1
        if need:
            planes, scalars, spans, scratch, late = set(), set(), [], False, 0
        op.plan = int(need)
        if own_barrier:
            planes, scalars, spans, scratch = set(), set(), [], False
            late = LATE_REDUCTION_READS.get(name, 0)
            # reads its input after it
            if name in READ_AFTER_BARRIER:
                spans += [span(e) for e in in_planes]
        else:
            spans += [span(e) for e in in_planes]
        spans += [span(o) for o in out_planes]
        planes |= {slots[o].root for o in out_planes}
        scalars |= {slots[o].root for o in op.outs if slots[o].kind == "scalar"}
        scratch |= uses_scratch


def lower(members, vals: dict, escapes) -> TileProgram:
    """The tape of ``members`` for the external inputs ``vals`` (env key ->
    ``(B,)`` scalar or ``(B, n)`` plane tensor), producing ``escapes``.
    Raises :class:`LoweringError` where K7 cannot run the list."""
    prog = TileProgram()
    lead = None
    for k, v in sorted(vals.items()):
        if lead is None and isinstance(v, torch.Tensor) and v.ndim:
            lead = v.shape[0]
        _add_ext(prog, k, v, lead)
    for m in members:
        _lower_step(prog, m)
    for k in escapes:
        prog.escapes[k] = prog.slot_of(k)
        r = prog.root(prog.escapes[k])
        if not r.ext and r.esc < 0:
            r.esc = len(prog.esc_roots)
            prog.esc_roots.append(r.root)
    if len(prog.ext_keys) > GEN_MAX_EXT or len(prog.esc_roots) > GEN_MAX_ESC:
        raise LoweringError(
            f"{len(prog.ext_keys)} inputs and {len(prog.esc_roots)} stored "
            f"outputs; K7's parameters hold {GEN_MAX_EXT} and {GEN_MAX_ESC}"
        )
    _plane_types(prog)
    _plan(prog)
    return prog
