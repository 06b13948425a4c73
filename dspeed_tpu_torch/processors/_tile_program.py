"""Lowering of a generic fusion group into the row tape of kernel K7.

The JAX package runs a :class:`~dspeed_tpu_torch.processing_chain.GroupStep`
by tracing its members into one Pallas program over row tiles
(``dspeed_tpu/processors/_pallas.py:1782`` ``generic_rows``), and learns
whether Mosaic takes it from a probe compile (``_gen_probe_compile`` :1720).
Here the host lowers the member list into a tape before any launch:

- a **slot** is a per-row plane (shared memory on the card) or a per-row
  scalar, in the dtype the unfused chain gives the same env key (float64
  where the plain path computes in float64); a slice or an alias is a view
  of its root slot and copies nothing. Planes are float32, except the
  float64 planes that ``reflected_convolve_wf`` writes from float64 taps
  and ``avg_current`` reads and writes (the SiPM chain computes in float64
  from its smoothed waveform on), which take two words each and have no
  slices;
- an **op** is an opcode, its operand slots (or constants) and output slots,
  and static parameters (window lengths, taps, mode, direction);
- a **liveness plan** gives each plane a place in shared memory from its
  defining op to its last reader, so planes that are dead share space;
  an external plane is loaded before its first reader; an escaping root is
  stored to device memory when its op has written it. A plan over one
  block's shared memory (``_cuda._MAX_SMEM``) is refused.

A member with no op, a plane that is not float32 or an operand shape the
tape does not take raises :class:`LoweringError`; the group then splits
(``GroupStep._exec``). The op set is the one the flagship's two generic
groups and the SiPM chain's group need (``ROADMAP.md`` lists the tile-safe
kernels still without one).

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
from ._cuda import _MAX_SMEM, GEN_MAX_CODE, GEN_MAX_DP
from .convolutions import _MATMUL_MAC_LIMIT, _mode_window

log = logging.getLogger("dspeed_tpu_torch.generic")

__all__ = ["LoweringError", "TileProgram", "lower", "SPLITS", "reset_splits"]


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
}
OP_IN, OP_OUT, OP_IP, OP_DP = 6, 4, 8, 4
OP_INTS = 1 + OP_IN + OP_OUT + OP_IP  # code, in, out, ip
SLOT_INTS = 8  # kind, f64, off, len, sidx, ext, esc, root
UFUNCS = {"add": 0, "multiply": 1, "divide": 2, "true_divide": 2}
THREADS = 256  # threads per block, one row per block
STATIC_SMEM = 512  # bytes of static shared memory (the reduction scratch)
ALIGN = 4  # planes start on 16-byte boundaries
IP_PLAN = 4  # ip[4]: the barrier plan (bit 0: a block barrier before the op)
# ops whose output planes may be float64 (two words a sample)
F64_PLANE_OPS = ("reflected_convolve_wf", "avg_current")
# ops that run on warp 0 alone (the others on every thread of the block)
WARP_OPS = ("time_point_thresh", "fixed_time_pickoff", "ufunc", "convert")
# ops with a block barrier of their own after their first reads of their
# operands and before any of their writes (csrc/generic_rows.cu)
BARRIERED_OPS = ("min_max", "linear_slope_fit", "pole_zero", "trap", "amax",
                 "conv", "moving_window_multi")
# the block reductions' two alternating buffers: for each op that takes
# them (its first one before its first barrier), how many of the buffers
# it took last it still reads after its last barrier. One is safe, since
# the next reduction takes the other buffer; two would meet its first write
LATE_REDUCTION_READS = {"min_max": 1, "linear_slope_fit": 1, "pole_zero": 1,
                        "amax": 1, "trap": 0, "moving_window_multi": 0}


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
                int(s.dtype == torch.float64),
                r.off + s.start if r.off >= 0 else -1,
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


def _add_ext(prog: TileProgram, key, v, lead) -> None:
    if not isinstance(v, torch.Tensor) or v.ndim not in (1, 2):
        raise LoweringError(f"input {key} is not a per-row scalar or plane")
    if v.shape[0] != lead:
        raise LoweringError(f"input {key} has {v.shape[0]} rows, not {lead}")
    if v.dtype not in _FLOATS:
        raise LoweringError(f"input {key} is {v.dtype}, not floating")
    if v.ndim == 2:
        if v.dtype != torch.float32:
            raise LoweringError(f"K7 takes float32 planes; {key} is {v.dtype}")
        prog.new_slot(key, "plane", v.dtype, int(v.shape[1]), ext=True)
    else:
        prog.new_slot(key, "scalar", v.dtype, ext=True)
    prog.ext_keys.append(key)


def _fetch_keeps_shape(spec, shape) -> bool:
    """True when ``KernelStep._fetch`` leaves a value of ``shape`` as it is
    (no singleton axes inserted for broadcasting)."""
    return spec.reshape is None or _align_shape(spec.reshape, shape) == list(shape)


def _kernel_args(prog: TileProgram, step) -> list:
    """The step's arguments as tape operands."""
    if step.kwarg_specs or step.badrow_key is not None:
        raise LoweringError(f"{step.kernel.__name__}: keyword or badrow arguments")
    args = []
    for spec in step.arg_specs:
        if spec.kind == "const":
            args.append(("const", spec.value))
            continue
        sid = prog.slot_of(spec.key)
        s = prog.slots[sid]
        shape = (1, s.length) if s.kind == "plane" else (1,)
        if not _fetch_keeps_shape(spec, shape):
            raise LoweringError(f"{step.kernel.__name__}: a broadcast operand")
        want = _device_dtype(spec.dtype) if spec.dtype is not None else s.dtype
        if want not in _FLOATS:
            raise LoweringError(f"{step.kernel.__name__}: a {want} operand")
        args.append(("slot", sid, want))
    return args


def _out_slots(prog: TileProgram, step, f64_planes=False) -> list[int]:
    outs = []
    for sp in step.out_specs:
        dt = _device_dtype(sp.dtype)
        if dt not in _FLOATS or not isinstance(sp.shape, tuple) or len(sp.shape) > 1:
            raise LoweringError(f"{step.kernel.__name__}: output {sp.key} "
                                f"is not a float scalar or plane")
        if len(sp.shape) == 1:
            if dt != torch.float32 and not f64_planes:
                raise LoweringError(f"K7 takes float32 planes; {sp.key} is {dt}")
            outs.append(prog.new_slot(sp.key, "plane", dt, int(sp.shape[0])))
        else:
            outs.append(prog.new_slot(sp.key, "scalar", dt))
    return outs


def _plane(prog, arg, what, dtypes=(torch.float32,)) -> int:
    """A plane operand, read in its slot's own type, one of ``dtypes``."""
    if arg[0] != "slot" or prog.slots[arg[1]].kind != "plane":
        raise LoweringError(f"{what} must be a plane")
    if arg[2] not in dtypes or prog.slots[arg[1]].dtype != arg[2]:
        raise LoweringError(f"{what}: K7 takes float32 planes")
    return arg[1]


def _plane_words(s: Slot) -> int:
    """The 32-bit words of the arena a plane slot spans."""
    return s.length * (2 if s.dtype == torch.float64 else 1)


def _scalar(prog, arg, what):
    """A scalar operand: a slot id, or ("const", float)."""
    if arg[0] == "slot":
        if prog.slots[arg[1]].kind != "scalar":
            raise LoweringError(f"{what} must be a per-row scalar")
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


def _lower_kernel(prog: TileProgram, step) -> None:
    name = step.kernel.__name__
    args = _kernel_args(prog, step)
    outs = _out_slots(prog, step, f64_planes=name in F64_PLANE_OPS)
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
    elif name in ("trap_norm", "asym_trap_filter"):
        sec = [int(_static(a, "a trapezoid section")) for a in args[1:]]
        need(kinds == ("plane",) and len(sec) == (2 if name == "trap_norm" else 3),
             "signature")
        rise, flat = sec[0], sec[1]
        fall = rise if name == "trap_norm" else sec[2]
        n = prog.slots[_plane(prog, args[0], name)].length
        need(rise >= 1 and flat >= 0 and fall >= 1
             and rise + flat + fall <= n, "sections out of range")
        x = op("trap")
        x.ins = [args[0][1]]
        x.ip = [int(name != "trap_norm"), rise, flat, fall]
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
        need(ch in "fvs" and 32 < m <= n, "only the banded route has an op")
        lo, p = _mode_window(ch, n, m)
        need(p * m <= _MATMUL_MAC_LIMIT and not np.isnan(kern).any()
             and o[0].length == p, "only the banded route has an op")
        x = op("conv")
        x.ins = [w]
        x.ip = [prog.n_taps, m, lo]
        prog.taps.append(np.asarray(kern, np.float32))
        prog.n_taps += m
    elif name == "reflected_convolve_wf":
        need(len(args) == 2 and kinds == ("plane",), "signature")
        # a float32 plane, read in the step's type: float64 taps make the
        # step (and its output) float64
        need(args[0][0] == "slot" and prog.slots[args[0][1]].kind == "plane"
             and prog.slots[args[0][1]].dtype == torch.float32
             and o[0].dtype == args[0][2], "a float32 plane read in the output's type")
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
            # float64 taps as pairs of words, on 8 bytes
            if prog.n_taps % 2:
                prog.taps.append(np.zeros(1, np.float32))
                prog.n_taps += 1
            x.ip = [prog.n_taps, m]
            prog.taps.append(np.asarray(kern, np.float64).view(np.float32))
            prog.n_taps += 2 * m
        else:
            x.ip = [prog.n_taps, m]
            prog.taps.append(np.asarray(kern, np.float32))
            prog.n_taps += m
    elif name == "time_point_thresh":
        need(len(args) == 4 and kinds == ("scalar",), "signature")
        walk = _static(args[3], "walk_forward")
        x = op("time_point_thresh")
        x.ins = [_plane(prog, args[0], name), _scalar(prog, args[1], "threshold"),
                 _scalar(prog, args[2], "t_start")]
        # the threshold in the row's type (time_point_thresh casts it)
        x.ip = [int(int(walk) == 1)] + [0] * 6 + [2 | _f32(args[2]) << 2]
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
        need(mode in "li", f"mode {mode!r} has no op")
        x = op("fixed_time_pickoff")
        x.ins = [_plane(prog, args[0], name), _scalar(prog, args[1], "t_in")]
        # the pick time in the row's type, as the kernel casts it
        x.ip = [ord(mode)] + [0] * 6 + [2]
    elif name in UFUNCS:
        need(len(args) == 2 and kinds == ("scalar",)
             and step.kernel.signature == "(),()->()", "a per-row scalar ufunc")
        x = op("ufunc")
        x.ins = [_scalar(prog, args[0], name), _scalar(prog, args[1], name)]
        mask = _f32(args[0]) | _f32(args[1]) << 1
        need(mask in (0, 3), "mixed operand types")
        x.ip = [UFUNCS[name], int(mask == 3)] + [0] * 5 + [mask]
    else:
        raise LoweringError(f"{name} has no K7 op")


def _lower_convert(prog: TileProgram, step) -> None:
    name = step.kernel.__name__
    if name not in ("convert", "convert_round"):
        raise LoweringError(f"{name} has no K7 op")
    sid = prog.slot_of(step.in_key)
    s = prog.slots[sid]
    if s.kind != "scalar":
        raise LoweringError(f"{name}: K7 converts per-row scalars only")
    dt = s.dtype
    out_var = step.out_var
    if out_var is not None and out_var.dtype is not auto:
        dt = _device_dtype(out_var.dtype)
        if dt not in _FLOATS:
            raise LoweringError(f"{name}: a {dt} output")
    args = [("slot", sid, s.dtype)]
    for off in (step.from_offset, step.to_offset):
        args.append(("slot", prog.slot_of(off), None) if isinstance(off, str)
                    else ("const", off))
    args.append(("const", step.ratio))
    out = prog.new_slot(step.out_key, "scalar", dt)
    x = Op(f"{name}[{step.out_key}]", OPCODES["convert"], args, [out], step)
    x.ins = [sid] + [_scalar(prog, a, "an offset") for a in args[1:3]]
    x.ip = [int(name == "convert_round"), int(s.dtype == torch.float32)]
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
        if s.dtype != torch.float32:
            raise LoweringError(f"{step.name}: a slice of a float64 plane")
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
        # the plan's fields are free in every record
        assert not any(op.ip[IP_PLAN : IP_PLAN + 3]), op.name

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
                prog.slots[r].off = alloc(_plane_words(prog.slots[r]))
                live[r] = (prog.slots[r].off, _plane_words(prog.slots[r]))
        for r in [r for r in live if last[r] == k]:
            release(*live.pop(r))
    prog.arena_floats = top

    # per-row scalars (an even count, so that the scratch after them starts
    # on 16 bytes), and the scratch the ops need: a float64 prefix of the
    # row (with a pad double after every 16 where the scan's runs are of an
    # even length), or the convolution's zero-padded window (the outputs
    # and the taps' 32-tap chunks, with the 16-byte loads' tail) and its
    # taps padded to 4
    for sid, s in enumerate(prog.slots):
        if s.root == sid and s.kind == "scalar":
            s.sidx = prog.n_scal
            prog.n_scal += 1
    prog.n_scal += prog.n_scal % 2
    scratch = 0
    for op in ops:
        if op.code in (OPCODES["trap"], OPCODES["moving_window_multi"]):
            n = prog.slots[op.ins[0]].length
            even = -(-n // THREADS) % 2 == 0  # runs of an even length
            scratch = max(scratch, n + ((n >> 4) + 1 if even else 0))
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
        lo = slots[s.root].off + s.start
        return lo, lo + _plane_words(s)

    def overlaps(a):
        return any(a[0] < b[1] and b[0] < a[1] for b in spans)

    for op in prog.ops:
        name = names[op.code]
        warp = name in WARP_OPS
        ins = [] if name == "load" else [e for e in op.ins if not isinstance(e, tuple)]
        in_planes = [e for e in ins if slots[e].kind == "plane"]
        out_planes = [o for o in op.outs if slots[o].kind == "plane"]
        uses_scratch = name in ("trap", "moving_window_multi", "conv")
        own_barrier = name in BARRIERED_OPS
        need = any(slots[e].root in planes for e in in_planes)
        need |= not warp and any(slots[e].root in scalars for e in ins
                                 if slots[e].kind == "scalar")
        if not own_barrier:
            # writes before any barrier of the op's own
            need |= any(overlaps(span(o)) for o in out_planes)
        if name == "conv":  # stages its window before its barrier
            need |= scratch
        if name in LATE_REDUCTION_READS:  # of two buffers
            need |= late > 1
        if need:
            planes, scalars, spans, scratch, late = set(), set(), [], False, 0
        op.plan = int(need)
        if own_barrier:
            planes, scalars, spans, scratch = set(), set(), [], False
            late = LATE_REDUCTION_READS.get(name, 0)
            if name in ("trap", "pole_zero"):  # reads its input after it
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
    _plan(prog)
    return prog
