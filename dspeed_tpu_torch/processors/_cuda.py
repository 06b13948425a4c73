"""The port's hand-written CUDA kernels, their plain PyTorch versions, and
their launch counts.

Each kernel replaces one Pallas TPU kernel of the JAX package
(``dspeed_tpu/processors/_pallas.py``):

- :func:`fused_energy` (``csrc/fused_energy.cu``) — K1, the fused energy
  front (``_fused_energy_kernel`` :287, entry ``fused_energy`` :1451);
- :func:`banded_conv_multi` (``csrc/banded_conv.cu``) — K4, the banded
  convolution bank (``_banded_conv_kernel`` :999, entry :1063);
- :func:`fused_t0` (``csrc/fused_t0.cu``) — K3, the t0 front with its
  absorbed A/E current (``_fused_t0_kernel`` :1140, entry ``fused_t0``
  :1315);
- :func:`cascade_tp` (``csrc/cascade_tp.cu``) — K2, the rise-time cascade
  (``_cascade_kernel`` :1528, entry ``cascade_tp`` :1650);
- :func:`fused_current` (``csrc/fused_current.cu``) — the A/E current
  front (entry ``fused_current`` :1398): K5, the polyphase route
  (``_fused_current_poly_kernel`` :804), where the plan of
  :mod:`._poly_plan` holds, else K6, the up-domain route
  (``_fused_current_kernel`` :572, also :func:`fused_current_updomain`);
- :func:`generic_rows` (``csrc/generic_rows.cu``) — K7, a generic fusion
  group as one row-tape launch (``generic_rows`` :1782), its tape lowered
  by :mod:`._tile_program`.

Three kernels replace no Pallas kernel: :func:`peakdet_scan`
(``csrc/peakdet_scan.cu``), the Billauer peak finder's sweep, which the JAX
package runs as a ``lax.scan`` (``dspeed_tpu/processors/peak_finding.py:49``),
:func:`recurrence` (``csrc/recurrence.cu``), the linear recurrences of
the recursive-filter family, which the JAX package runs as blocked matmuls
and ``associative_scan`` calls (``_numerics.py:250``, ``rc_cr2.py:39``,
``recursive_filter.py:41``, ``_spline.py:27``), and :func:`bilevel_scan`
(``csrc/bilevel_scan.cu``), the bi-level trigger's state machine, a
``lax.scan`` over sample pairs in the JAX package
(``time_point_thresh.py:400``).

A wrapper given a CPU tensor computes the kernel's plain version
(:func:`fused_energy_plain`, :func:`banded_conv_plain`,
:func:`fused_t0_plain`, :func:`cascade_tp_plain`,
:func:`fused_current_plain`, :func:`generic_rows_plain`,
:func:`peakdet_scan_plain`, :func:`recurrence_plain`,
:func:`bilevel_scan_plain`); given a CUDA
tensor it launches the kernel or raises — it never falls back. Every launch adds one to
``LAUNCHES[<kernel>]`` (K5 counts as ``fused_current_poly``, K6 as
``fused_current``). :func:`fused_current_poly_plain` is K5's own arithmetic
in PyTorch, for holding the kernel and the plan; no path runs it.

The sources are compiled with ``nvcc`` for ``sm_90a`` into shared libraries
with a plain C interface under ``dspeed_tpu_torch/_build/`` on first use (or
all at once by :func:`build_all`), and bound with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import glob
import math
import os
import shutil
import subprocess
import threading

import numpy as np
import torch

from ..errors import DSPFatal
from ._helpers import as_tensor, per_row

__all__ = [
    "LAUNCHES",
    "reset_launches",
    "build_all",
    "fused_energy",
    "fused_energy_plain",
    "fused_energy_launch",
    "banded_conv_launch",
    "banded_conv_multi",
    "banded_conv_plain",
    "fused_t0",
    "fused_t0_launch",
    "fused_t0_plain",
    "cascade_tp",
    "cascade_tp_launch",
    "cascade_tp_plain",
    "fused_current",
    "fused_current_updomain",
    "fused_current_launch",
    "fused_current_plain",
    "fused_current_poly_plain",
    "generic_rows",
    "generic_rows_launch",
    "generic_rows_plain",
    "peakdet_scan",
    "peakdet_scan_launch",
    "peakdet_scan_plain",
    "recurrence",
    "recurrence_launch",
    "recurrence_plain",
    "bilevel_scan",
    "bilevel_scan_launch",
    "bilevel_scan_plain",
]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(_PKG, "_build")
SOURCES = {
    "fused_energy": "fused_energy.cu",
    "banded_conv": "banded_conv.cu",
    "fused_t0": "fused_t0.cu",
    "cascade_tp": "cascade_tp.cu",
    "fused_current": "fused_current.cu",
    "generic_rows": "generic_rows.cu",
    "peakdet_scan": "peakdet_scan.cu",
    "recurrence": "recurrence.cu",
    "bilevel_scan": "bilevel_scan.cu",
}

LAUNCHES = {
    "fused_energy": 0, "banded_conv_multi": 0, "fused_t0": 0, "cascade_tp": 0,
    "fused_current_poly": 0, "fused_current": 0, "generic_rows": 0,
    "peakdet_scan": 0, "recurrence": 0, "bilevel_scan": 0,
}

_LIBS: dict = {}
_LOCK = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a CUDA host")


def _compile(name: str, verbose: bool = False) -> tuple[str, str]:
    """Compile ``csrc/<source>`` into ``_build/lib<name>.so`` unless an
    up-to-date library is there; returns ``(path, compiler output)``. With
    ``verbose`` it always compiles, so that the output holds ``ptxas``'s
    registers, shared memory and spills per kernel."""
    src = os.path.join(_CSRC, SOURCES[name])
    so = os.path.join(_BUILD, f"libdspeed_{name}.so")
    # a source is as new as the newest of itself and the shared headers
    newest = max(
        os.path.getmtime(p)
        for p in [src, *glob.glob(os.path.join(_CSRC, "*.cuh"))]
    )
    if not verbose and os.path.exists(so) and os.path.getmtime(so) >= newest:
        return so, ""
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", tmp, src,
    ]
    if verbose:
        cmd[1:1] = ["-Xptxas", "-v"]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed to build {SOURCES[name]}:\n{res.stdout}{res.stderr}"
        )
    os.replace(tmp, so)
    return so, res.stdout + res.stderr


def _bind(name: str, so: str):
    lib = ctypes.CDLL(so)
    lib.dspeed_cuda_error_string.restype = ctypes.c_char_p
    lib.dspeed_cuda_error_string.argtypes = [ctypes.c_int]
    if name == "fused_energy":
        lib.dspeed_fused_energy.restype = ctypes.c_int
        lib.dspeed_fused_energy.argtypes = [
            ctypes.POINTER(_EnergyParams), ctypes.c_void_p,
        ]
        lib.dspeed_fused_energy_smem_bytes.restype = ctypes.c_int
        lib.dspeed_fused_energy_smem_bytes.argtypes = [ctypes.c_int]
        lib.dspeed_fused_energy_config.restype = ctypes.c_int
        lib.dspeed_fused_energy_config.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ]
    elif name == "banded_conv":
        lib.dspeed_banded_conv.restype = ctypes.c_int
        lib.dspeed_banded_conv.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        )
        lib.dspeed_banded_conv_smem_bytes.restype = ctypes.c_int
        lib.dspeed_banded_conv_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.dspeed_banded_conv_config.restype = ctypes.c_int
        lib.dspeed_banded_conv_config.argtypes = [ctypes.c_int] * 4 + [
            ctypes.POINTER(ctypes.c_int),
        ]
    elif name == "fused_t0":
        lib.dspeed_fused_t0.restype = ctypes.c_int
        lib.dspeed_fused_t0.argtypes = [
            ctypes.POINTER(_T0Params), ctypes.c_void_p,
        ]
        lib.dspeed_fused_t0_smem_bytes.restype = ctypes.c_int
        lib.dspeed_fused_t0_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.dspeed_fused_t0_config.restype = ctypes.c_int
        lib.dspeed_fused_t0_config.argtypes = [ctypes.c_int] * 3 + [
            ctypes.POINTER(ctypes.c_int),
        ]
    elif name == "cascade_tp":
        lib.dspeed_cascade_tp.restype = ctypes.c_int
        lib.dspeed_cascade_tp.argtypes = [
            ctypes.POINTER(_CascadeParams), ctypes.c_void_p,
        ]
        lib.dspeed_cascade_tp_config.restype = ctypes.c_int
        lib.dspeed_cascade_tp_config.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ]
    elif name == "generic_rows":
        lib.dspeed_generic_rows.restype = ctypes.c_int
        lib.dspeed_generic_rows.argtypes = [
            ctypes.POINTER(_GenParams), ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.dspeed_generic_rows_config.restype = ctypes.c_int
        lib.dspeed_generic_rows_config.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ]
    elif name == "peakdet_scan":
        lib.dspeed_peakdet_scan.restype = ctypes.c_int
        lib.dspeed_peakdet_scan.argtypes = [
            ctypes.POINTER(_PeakdetParams), ctypes.c_void_p,
        ]
        lib.dspeed_peakdet_scan_config.restype = ctypes.c_int
        lib.dspeed_peakdet_scan_config.argtypes = [ctypes.POINTER(ctypes.c_int)]
    elif name == "bilevel_scan":
        lib.dspeed_bilevel_scan.restype = ctypes.c_int
        lib.dspeed_bilevel_scan.argtypes = [
            ctypes.POINTER(_BilevelParams), ctypes.c_void_p,
        ]
        lib.dspeed_bilevel_scan_max_slots.restype = ctypes.c_int
        lib.dspeed_bilevel_scan_max_slots.argtypes = [ctypes.c_int]
        lib.dspeed_bilevel_scan_config.restype = ctypes.c_int
        lib.dspeed_bilevel_scan_config.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ]
    elif name == "recurrence":
        lib.dspeed_recurrence.restype = ctypes.c_int
        lib.dspeed_recurrence.argtypes = [
            ctypes.POINTER(_RecParams), ctypes.c_void_p,
        ]
        lib.dspeed_recurrence_smem_order.restype = ctypes.c_int
        lib.dspeed_recurrence_smem_order.argtypes = []
        lib.dspeed_recurrence_config.restype = ctypes.c_int
        lib.dspeed_recurrence_config.argtypes = [ctypes.POINTER(ctypes.c_int)]
    else:
        for fn in (lib.dspeed_fused_current, lib.dspeed_fused_current_poly):
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.POINTER(_CurrentParams), ctypes.c_void_p]
        lib.dspeed_fused_current_smem_bytes.restype = ctypes.c_int
        lib.dspeed_fused_current_smem_bytes.argtypes = [ctypes.c_int]
        lib.dspeed_fused_current_config.restype = ctypes.c_int
        lib.dspeed_fused_current_config.argtypes = [ctypes.c_int] * 3 + [
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.dspeed_fused_current_poly_smem_bytes.restype = ctypes.c_int
        lib.dspeed_fused_current_poly_smem_bytes.argtypes = [ctypes.c_int] * 4
        lib.dspeed_fused_current_poly_config.restype = ctypes.c_int
        lib.dspeed_fused_current_poly_config.argtypes = [ctypes.c_int] * 6 + [
            ctypes.POINTER(ctypes.c_int),
        ]
    return lib


def _lib(name: str):
    lib = _LIBS.get(name)
    if lib is None:
        with _LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                so, _ = _compile(name)
                lib = _LIBS[name] = _bind(name, so)
    return lib


def build_all(verbose: bool = False) -> dict[str, str]:
    """Build every kernel library at once (one ``nvcc`` per source, all
    started together) and load them; returns the compiler output per
    source (register and shared-memory use with ``verbose``)."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(SOURCES)) as ex:
        futs = {n: ex.submit(_compile, n, verbose) for n in SOURCES}
        built = {n: f.result() for n, f in futs.items()}
    with _LOCK:
        for n, (so, _) in built.items():
            _LIBS[n] = _bind(n, so)
    return {n: log for n, (_, log) in built.items()}


def _check_rc(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.dspeed_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


_MAX_SMEM = 232448  # bytes of shared memory one H100 block may use


def _require_cuda_f32(x: torch.Tensor, what: str, strided_rows=False) -> None:
    """Float32, and contiguous; with ``strided_rows`` a 2-D tensor whose rows
    are contiguous at any row stride (a slice ``x[:, a:b]``) is taken too."""
    if x.dtype != torch.float32:
        raise TypeError(f"{what}: the CUDA kernel takes float32, got {x.dtype}")
    if x.is_contiguous() or (strided_rows and x.dim() == 2 and x.stride(1) == 1):
        return
    raise ValueError(f"{what}: the CUDA kernel takes a contiguous tensor")


# ---------------------------------------------------------------------------
# K1: fused energy front
# ---------------------------------------------------------------------------

_EN_MAX_TRAPS, _EN_MAX_EMAX, _EN_MAX_SLOPES, _EN_MAX_MASKS = 8, 8, 4, 4


class _TrapSpec(ctypes.Structure):
    _fields_ = [(f, ctypes.c_int) for f in ("kind", "rise", "flat", "fall")]


class _EnergyParams(ctypes.Structure):
    """Field for field the ``EnergyParams`` struct of ``fused_energy.cu``."""

    _fields_ = [
        ("w", ctypes.c_void_p),
        ("bl", ctypes.c_void_p),
        ("pz", ctypes.c_void_p),
        ("blsub", ctypes.c_void_p),
        ("mm", ctypes.c_void_p * 4),
        ("B", ctypes.c_int),
        ("n", ctypes.c_int),
        ("omc", ctypes.c_double),
        ("ntrap", ctypes.c_int),
        ("trap", _TrapSpec * _EN_MAX_TRAPS),
        ("trap_out", ctypes.c_void_p * _EN_MAX_TRAPS),
        ("nemax", ctypes.c_int),
        ("emax_idx", ctypes.c_int * _EN_MAX_EMAX),
        ("emax_out", ctypes.c_void_p * _EN_MAX_EMAX),
        ("nslope", ctypes.c_int),
        ("slope_src", ctypes.c_int * _EN_MAX_SLOPES),
        ("slope_a0", ctypes.c_int * _EN_MAX_SLOPES),
        ("slope_b0", ctypes.c_int * _EN_MAX_SLOPES),
        ("slope_out", ctypes.c_void_p * (4 * _EN_MAX_SLOPES)),
        ("nmask", ctypes.c_int),
        ("mask_trap", _TrapSpec * _EN_MAX_MASKS),
        ("mask_si", ctypes.c_int * _EN_MAX_MASKS),
        ("mask_oi", ctypes.c_int * _EN_MAX_MASKS),
        ("mask_fwd", ctypes.c_int * _EN_MAX_MASKS),
        ("mask_bwd", ctypes.c_int * _EN_MAX_MASKS),
        ("mask_out", ctypes.c_void_p * _EN_MAX_MASKS),
    ]


def _trap_tuple(s) -> tuple:
    if s[0] == "norm":
        return ("norm", int(s[1]), int(s[2]))
    if s[0] == "asym":
        return ("asym", int(s[1]), int(s[2]), int(s[3]))
    raise DSPFatal(f"unknown trap spec kind {s[0]!r}")


def _set_trap(dst: _TrapSpec, spec: tuple) -> None:
    dst.kind = 0 if spec[0] == "norm" else 1
    dst.rise = spec[1]
    dst.flat = spec[2]
    dst.fall = spec[3] if spec[0] == "asym" else spec[1]


def _energy_specs(trap_specs, emax_for, slope_specs, mask_specs):
    trap_specs = tuple(_trap_tuple(s) for s in trap_specs)
    emax_for = tuple(int(i) for i in emax_for)
    slope_specs = tuple(tuple(int(v) for v in s) for s in slope_specs)
    mask_specs = tuple(
        (_trap_tuple(sp), int(si), int(oi), bool(ff), bool(bb))
        for sp, si, oi, ff, bb in mask_specs
    )
    return trap_specs, emax_for, slope_specs, mask_specs


def fused_energy_plain(
    w, baseline, tau, trap_specs, emax_for=(0,), emit_blsub=False,
    emit_minmax=False, slope_specs=(), mask_specs=(),
):
    """Plain version of K1: the unfused processor bodies composed exactly as
    the JAX package's fallback composes them (``fused.py:381-438``).

    Returns ``(pz, [traps], [emaxes], *slope outputs (4 per spec),
    *[t_min, t_max, a_min, a_max], [blsub], *masks)``; every float output is
    NaN-poisoned on rows whose waveform or baseline holds a NaN, except the
    raw min_max quadruple (waveform NaN only).
    """
    from ._helpers import any_bad, isnan_any, nanmask
    from .bl_subtract import bl_subtract
    from .linear_slope_fit import linear_slope_fit
    from .min_max import min_max
    from .pole_zero import pole_zero
    from .trap_filters import asym_trap_filter, trap_norm

    trap_specs, emax_for, slope_specs, mask_specs = _energy_specs(
        trap_specs, emax_for, slope_specs, mask_specs
    )
    bad = any_bad(isnan_any(w, 1), isnan_any(baseline))
    (wsub,) = bl_subtract(w, baseline)
    (pz,) = pole_zero(wsub, float(tau))
    slopes = tuple(
        o
        for src, a0, b0 in slope_specs
        for o in linear_slope_fit((wsub if src == 0 else pz)[..., a0:b0])
    )
    mm = min_max(w) if emit_minmax else ()
    done = {}

    def one_trap(s):
        if s not in done:
            if s[0] == "norm":
                (done[s],) = trap_norm(pz, s[1], s[2])
            else:
                (done[s],) = asym_trap_filter(pz, s[1], s[2], s[3])
        return done[s]

    traps = [one_trap(s) for s in trap_specs]
    emaxes = [torch.amax(traps[i], dim=-1) for i in emax_for]
    masks = []
    if mask_specs:
        from .time_point_thresh import _crossing_masks

        for sp, si, oi, ff, bb in mask_specs:
            tr = one_trap(sp)
            fwd, bwd = _crossing_masks(tr, slopes[4 * si + oi].to(tr.dtype))
            bits = torch.zeros(tr.shape, dtype=torch.uint8, device=tr.device)
            if ff:
                bits = bits | fwd.to(torch.uint8)
            if bb:
                bits = bits | (bwd.to(torch.uint8) << 1)
            badm = bad
            if isinstance(badm, torch.Tensor):
                badm = badm[..., None]
            masks.append(torch.where(
                torch.as_tensor(badm, device=tr.device), 0, bits
            ).to(torch.uint8))
    dt = w.dtype
    outs = [nanmask(bad, pz.to(dt)), [nanmask(bad, t.to(dt)) for t in traps],
            [nanmask(bad, e.to(dt)) for e in emaxes]]
    # slope fits self-mask on their slice (== bad rows after poisoning);
    # min_max carries its own waveform-only mask
    outs += [s.to(dt) for s in slopes]
    outs += [m.to(dt) for m in mm]
    if emit_blsub:
        outs.append(nanmask(bad, wsub.to(dt)))
    outs += masks
    return tuple(outs)


def fused_energy_launch(n: int) -> dict:
    """How K1 launches for rows of ``n`` samples on this card: threads and
    shared memory per block, blocks per SM, and the kernel's registers and
    local (spill) bytes per thread."""
    lib = _lib("fused_energy")
    out = (ctypes.c_int * 5)()
    _check_rc(lib, lib.dspeed_fused_energy_config(int(n), out), "fused_energy")
    keys = ("threads", "smem_bytes", "blocks_per_sm", "registers", "local_bytes")
    return dict(zip(keys, out))


def fused_energy(
    w, baseline, tau, trap_specs, emax_for=(0,), emit_blsub=False,
    emit_minmax=False, slope_specs=(), mask_specs=(),
):
    """K1: baseline subtraction, pole-zero(``tau``), every trapezoid of
    ``trap_specs`` (``("norm", rise, flat)`` / ``("asym", rise, flat,
    fall)``), the maxima of the traps indexed by ``emax_for``, and the
    optional outputs (see :func:`fused_energy_plain`, same layout) in one
    pass per row. ``w`` is ``(..., n)`` float32, ``baseline`` broadcasts
    against ``w``'s leading dims."""
    if w.device.type == "cpu":
        return fused_energy_plain(
            w, baseline, tau, trap_specs, emax_for, emit_blsub, emit_minmax,
            slope_specs, mask_specs,
        )
    trap_specs, emax_for, slope_specs, mask_specs = _energy_specs(
        trap_specs, emax_for, slope_specs, mask_specs
    )
    _require_cuda_f32(w, "fused_energy")
    *lead, n = w.shape
    B = int(np.prod(lead, dtype=np.int64))
    k, ke, ns, nm = (
        len(trap_specs), len(emax_for), len(slope_specs), len(mask_specs)
    )
    if (k > _EN_MAX_TRAPS or ke > _EN_MAX_EMAX or ns > _EN_MAX_SLOPES
            or nm > _EN_MAX_MASKS):
        raise ValueError(
            f"fused_energy: the CUDA kernel takes at most {_EN_MAX_TRAPS} "
            f"traps, {_EN_MAX_EMAX} maxima, {_EN_MAX_SLOPES} slope fits and "
            f"{_EN_MAX_MASKS} masks; got {k}, {ke}, {ns}, {nm}"
        )
    if any(not 0 <= i < k for i in emax_for):
        raise ValueError("fused_energy: emax_for must index trap_specs")
    for src, a0, b0 in slope_specs:
        if src not in (0, 1) or not 0 <= a0 < b0 <= n:
            raise ValueError(
                f"fused_energy: slope spec {(src, a0, b0)} outside a row of {n}"
            )
    for _sp, si, oi, _ff, _bb in mask_specs:
        if not (0 <= si < ns and 0 <= oi < 4):
            raise ValueError("fused_energy: mask_specs must index a slope output")
    lib = _lib("fused_energy")
    smem = lib.dspeed_fused_energy_smem_bytes(n)
    if smem > _MAX_SMEM:
        raise ValueError(
            f"fused_energy: a row of {n} samples needs {smem} bytes of shared "
            f"memory; one block holds at most {_MAX_SMEM}"
        )
    dev = w.device
    bl = torch.as_tensor(baseline, device=dev)
    bl = bl.to(torch.float32).expand(lead).contiguous()

    def plane(dtype=torch.float32):
        return torch.empty((B, n), dtype=dtype, device=dev)

    def scal():
        return torch.empty((B,), dtype=torch.float32, device=dev)

    P = _EnergyParams()
    P.w, P.bl, P.B, P.n = w.data_ptr(), bl.data_ptr(), B, n
    P.omc = float(-np.expm1(-1.0 / float(tau)))
    pz = plane()
    P.pz = pz.data_ptr()
    P.ntrap = k
    traps = []
    for t, spec in enumerate(trap_specs):
        _set_trap(P.trap[t], spec)
        traps.append(plane())
        P.trap_out[t] = traps[-1].data_ptr()
    P.nemax = ke
    emaxes = []
    for e, ti in enumerate(emax_for):
        P.emax_idx[e] = ti
        emaxes.append(scal())
        P.emax_out[e] = emaxes[-1].data_ptr()
    P.nslope = ns
    slopes = []
    for s, (src, a0, b0) in enumerate(slope_specs):
        P.slope_src[s], P.slope_a0[s], P.slope_b0[s] = src, a0, b0
        for q in range(4):
            slopes.append(scal())
            P.slope_out[4 * s + q] = slopes[-1].data_ptr()
    mm = []
    if emit_minmax:
        for q in range(4):
            mm.append(scal())
            P.mm[q] = mm[-1].data_ptr()
    blsub = None
    if emit_blsub:
        blsub = plane()
        P.blsub = blsub.data_ptr()
    P.nmask = nm
    masks = []
    for q, (sp, si, oi, ff, bb) in enumerate(mask_specs):
        _set_trap(P.mask_trap[q], sp)
        P.mask_si[q], P.mask_oi[q] = si, oi
        P.mask_fwd[q], P.mask_bwd[q] = int(ff), int(bb)
        masks.append(plane(torch.uint8))
        P.mask_out[q] = masks[-1].data_ptr()
    rc = lib.dspeed_fused_energy(ctypes.byref(P), _stream())
    _check_rc(lib, rc, "fused_energy")
    LAUNCHES["fused_energy"] += 1

    def rows(x):
        return x.reshape(*lead, *x.shape[1:])

    outs = [rows(pz), [rows(t) for t in traps], [rows(e) for e in emaxes]]
    outs += [rows(s) for s in slopes] + [rows(m) for m in mm]
    if blsub is not None:
        outs.append(rows(blsub))
    outs += [rows(m) for m in masks]
    return tuple(outs)


# ---------------------------------------------------------------------------
# K4: banded convolution bank
# ---------------------------------------------------------------------------

_BC_MAX_NK = 4
_TAPS_CACHE: dict = {}


def _taps_on(kerns, device) -> torch.Tensor:
    """The bank's taps as one ``(nk, m)`` float32 tensor on ``device``,
    uploaded once per distinct bank."""
    arr = np.ascontiguousarray(np.stack(kerns).astype(np.float32))
    key = (str(device), arr.shape, arr.tobytes())
    t = _TAPS_CACHE.get(key)
    if t is None:
        if len(_TAPS_CACHE) >= 32:
            _TAPS_CACHE.pop(next(iter(_TAPS_CACHE)))
        t = _TAPS_CACHE[key] = torch.from_numpy(arr).to(device)
    return t


def banded_conv_launch(B: int, m: int, nk: int, p: int) -> dict:
    """How K4 launches for ``B`` rows, ``nk`` kernels of ``m`` taps and
    ``p`` outputs on this card: outputs per thread, threads, rows and
    segments per row and shared memory per block, blocks per SM, blocks,
    and the kernel instance's registers and local (spill) bytes per
    thread."""
    lib = _lib("banded_conv")
    out = (ctypes.c_int * 9)()
    rc = lib.dspeed_banded_conv_config(int(B), int(m), int(nk), int(p), out)
    _check_rc(lib, rc, "banded_conv_multi")
    keys = ("outputs_per_thread", "threads", "rows_per_block", "segments",
            "smem_bytes", "blocks_per_sm", "blocks", "registers",
            "local_bytes")
    return dict(zip(keys, out))


def banded_conv_plain(w, kerns, lo, p, n_in=None):
    """Plain version of K4: one banded matrix product per kernel (the JAX
    package's route, ``convolutions.py:158``), rows with a NaN in the read
    window poisoned."""
    from ._helpers import isnan_any, nanmask
    from .convolutions import _conv_banded_matmul

    if n_in is not None and w.shape[-1] > n_in:
        w = w[..., :n_in]
    bad = isnan_any(w, 1)
    return [
        nanmask(bad, _conv_banded_matmul(w, np.asarray(k), lo, p))
        for k in kerns
    ]


def banded_conv_multi(w, kerns, lo, p, n_in=None):
    """K4: ``full_conv(w[..., :n_in], k_j)[..., lo:lo+p]`` for each of the
    same-length 1-D kernels ``kerns`` (numpy), sharing one read of the
    window; NaN rows poisoned. Returns a list of ``(..., p)`` tensors."""
    kerns = [np.asarray(k) for k in kerns]
    nk = len(kerns)
    m = int(kerns[0].shape[-1])
    if any(k.ndim != 1 or k.shape[-1] != m for k in kerns):
        raise DSPFatal("banded_conv_multi kernels must be 1-D and same-length")
    n_full = w.shape[-1]
    n = n_full if n_in is None else int(n_in)
    lo, p = int(lo), int(p)
    if n > n_full:
        raise ValueError(f"banded_conv_multi: n_in={n} exceeds the row ({n_full})")
    if w.device.type == "cpu":
        return banded_conv_plain(w, kerns, lo, p, n_in)
    _require_cuda_f32(w, "banded_conv_multi", strided_rows=True)
    if nk > _BC_MAX_NK:
        raise ValueError(
            f"banded_conv_multi: the CUDA kernel takes at most {_BC_MAX_NK} "
            f"kernels per bank, got {nk}"
        )
    lib = _lib("banded_conv")
    smem = lib.dspeed_banded_conv_smem_bytes(m, nk, p)
    if smem > _MAX_SMEM:
        raise ValueError(
            f"banded_conv_multi: {nk} kernels of {m} taps and {p} outputs "
            f"need {smem} bytes of shared memory; one block holds at most "
            f"{_MAX_SMEM}"
        )
    *lead, _ = w.shape
    B = int(np.prod(lead, dtype=np.int64))
    taps = _taps_on(kerns, w.device)
    out = torch.empty((B, nk, p), dtype=torch.float32, device=w.device)
    row_stride = w.stride(0) if w.dim() == 2 else n_full
    rc = lib.dspeed_banded_conv(
        w.data_ptr(), taps.data_ptr(), out.data_ptr(), B, row_stride, n, m,
        nk, lo, p, _stream(),
    )
    _check_rc(lib, rc, "banded_conv_multi")
    LAUNCHES["banded_conv_multi"] += 1
    return [out[:, j, :].reshape(*lead, p) for j in range(nk)]


# ---------------------------------------------------------------------------
# K3: t0 front
# ---------------------------------------------------------------------------


class _T0Params(ctypes.Structure):
    """Field for field the ``T0Params`` struct of ``fused_t0.cu``."""

    _fields_ = [
        ("w", ctypes.c_void_p),
        ("taps", ctypes.c_void_p),
        ("a", ctypes.c_void_p),
        ("out", ctypes.c_void_p * 6),
        ("curr", ctypes.c_void_p),
        ("B", ctypes.c_int),
        ("n", ctypes.c_int),
        ("m", ctypes.c_int),
        ("lo", ctypes.c_int),
        ("need_min", ctypes.c_int),
        ("has_atrap", ctypes.c_int),
        ("atrap", _TrapSpec),
        ("win_m", ctypes.c_int),
        ("avg_len", ctypes.c_int),
        ("n_curr", ctypes.c_int),
    ]


def fused_t0_launch(n: int, m: int, has_atrap: bool = False) -> dict:
    """How K3 launches for rows of ``n`` samples and ``m`` taps (with an
    absorbed trapezoid where ``has_atrap``) on this card: outputs per
    thread, threads and shared memory per block, blocks per SM, and the
    kernel's registers and local (spill) bytes per thread."""
    lib = _lib("fused_t0")
    out = (ctypes.c_int * 6)()
    rc = lib.dspeed_fused_t0_config(int(n), int(m), int(bool(has_atrap)), out)
    _check_rc(lib, rc, "fused_t0")
    keys = ("outputs_per_thread", "threads", "smem_bytes", "blocks_per_sm",
            "registers", "local_bytes")
    return dict(zip(keys, out))


def _curr_spec(curr_spec, n):
    """``curr_spec`` as ints, with the limits of ``windower`` (a window
    shorter than the row) and ``avg_current`` (``0 < avg_len < win_m``)."""
    if curr_spec is None:
        return None
    win_m, avg_len, n_curr = (int(x) for x in curr_spec)
    if not (0 < avg_len < win_m < n and n_curr > 0):
        raise DSPFatal(
            f"curr_spec {(win_m, avg_len, n_curr)} needs 0 < avg_len < win_m "
            f"< {n} (the row) and n_curr > 0"
        )
    return win_m, avg_len, n_curr


def fused_t0_plain(w, kern, a_std, curr_spec=None, atrap_spec=None,
                   need=(True,) * 4):
    """Plain version of K3: ``convolve_wf(w, kern, 's')`` -> ``min_max`` ->
    ``time_point_thresh(conv, a_std, t_max, 0)``; with ``curr_spec =
    (win_m, avg_len, n_curr)`` the A/E current ``avg_current(windower(w,
    tp_0, win_m), avg_len)``; with ``atrap_spec`` ``trap(w)`` ->
    ``time_point_thresh(trap, a_std, t_max, 0)`` — the JAX package's
    fallback composition (``fused.py:236-262``). Returns ``(t_min, t_max,
    a_min, a_max, tp_0[, curr][, tp_atrap])``; ``need`` is accepted for the
    kernel's signature and every output is computed."""
    from .convolutions import convolve_wf
    from .min_max import min_max
    from .moving_windows import avg_current
    from .time_point_thresh import time_point_thresh
    from .trap_filters import asym_trap_filter, trap_norm
    from .windower import windower

    n = w.shape[-1]
    curr_spec = _curr_spec(curr_spec, n)
    (c,) = convolve_wf(w, np.asarray(kern), ord("s"), dims={"p": n})
    t_min, t_max, a_min, a_max = min_max(c)
    (tp0,) = time_point_thresh(c, a_std, t_max, 0)
    res = [t_min, t_max, a_min, a_max, tp0]
    if curr_spec is not None:
        win_m, avg_len, n_curr = curr_spec
        (wle,) = windower(w, tp0, dims={"m": win_m})
        res += avg_current(wle, float(avg_len), dims={"m": n_curr})
    if atrap_spec is not None:
        sp = _trap_tuple(atrap_spec)
        if sp[0] == "norm":
            (atr,) = trap_norm(w, sp[1], sp[2])
        else:
            (atr,) = asym_trap_filter(w, sp[1], sp[2], sp[3])
        res += time_point_thresh(atr, a_std, t_max, 0)
    return tuple(res)


def fused_t0(w, kern, a_std, curr_spec=None, atrap_spec=None,
             need=(True,) * 4):
    """K3: the t0 front of the HPGe chain in one pass per row — the
    ``'same'`` convolution of ``w`` with the constant 1-D ``kern`` (numpy),
    its first-occurrence ``min_max``, and the backward threshold search
    from ``t_max`` against ``a_std``; with ``curr_spec = (win_m, avg_len,
    n_curr)`` the A/E current of the ``win_m`` samples from ``tp_0`` (a
    ``(..., n_curr)`` output); with ``atrap_spec`` (a ``("norm", rise,
    flat)`` / ``("asym", rise, flat, fall)`` trapezoid of ``w``) the trap's
    own backward search from the same ``t_max`` too. The filtered row never
    leaves the card's shared memory. ``need`` flags which of ``(t_min,
    t_max, a_min, a_max)`` anything reads; the kernel skips the minimum
    where neither ``t_min`` nor ``a_min`` is needed, and an elided output
    holds 0. Same outputs as :func:`fused_t0_plain`."""
    kern = np.asarray(kern)
    if kern.ndim != 1:
        raise DSPFatal("fused_t0 needs a 1-D kernel")
    need = tuple(bool(x) for x in need)
    if len(need) != 4:
        raise DSPFatal("need must have four entries")
    if atrap_spec is not None:
        atrap_spec = _trap_tuple(atrap_spec)
    if w.device.type == "cpu":
        return fused_t0_plain(w, kern, a_std, curr_spec, atrap_spec, need)
    _require_cuda_f32(w, "fused_t0")
    *lead, n = w.shape
    curr_spec = _curr_spec(curr_spec, n)
    m = int(kern.shape[-1])
    if not 1 <= m <= n:
        raise ValueError(f"fused_t0: {m} taps for a row of {n} samples")
    lib = _lib("fused_t0")
    smem = lib.dspeed_fused_t0_smem_bytes(n, m, int(atrap_spec is not None))
    if smem > _MAX_SMEM:
        raise ValueError(
            f"fused_t0: a row of {n} samples with {m} taps"
            f"{' and a trapezoid' if atrap_spec else ''} needs {smem} bytes "
            f"of shared memory; one block holds at most {_MAX_SMEM}"
        )
    B = int(np.prod(lead, dtype=np.int64))
    dev = w.device
    # the threshold in the row's type, as time_point_thresh casts it
    a = torch.as_tensor(a_std, device=dev).to(torch.float32)
    a = a.expand(lead).contiguous()
    taps = _taps_on([kern], dev)
    nout = 5 + (atrap_spec is not None)
    out = torch.empty((nout, B), dtype=torch.float32, device=dev)
    P = _T0Params()
    P.w, P.taps, P.a = w.data_ptr(), taps.data_ptr(), a.data_ptr()
    for q in range(nout):
        P.out[q] = out[q].data_ptr()
    P.B, P.n, P.m, P.lo = B, n, m, (m - 1) // 2  # numpy 'same' window
    P.need_min = int(need[0] or need[2])
    P.has_atrap = int(atrap_spec is not None)
    if atrap_spec is not None:
        _set_trap(P.atrap, atrap_spec)
    curr = None
    if curr_spec is not None:
        P.win_m, P.avg_len, P.n_curr = curr_spec
        curr = torch.empty((B, curr_spec[2]), dtype=torch.float32, device=dev)
        P.curr = curr.data_ptr()
    rc = lib.dspeed_fused_t0(ctypes.byref(P), _stream())
    _check_rc(lib, rc, "fused_t0")
    LAUNCHES["fused_t0"] += 1
    res = [out[q].reshape(lead) for q in range(5)]
    if curr is not None:
        res.append(curr.reshape(*lead, curr_spec[2]))
    if atrap_spec is not None:
        res.append(out[5].reshape(lead))
    return tuple(res)


# ---------------------------------------------------------------------------
# K2: rise-time cascade
# ---------------------------------------------------------------------------

_CT_MAX_LINKS = 16


class _CascadeParams(ctypes.Structure):
    """Field for field the ``CascadeParams`` struct of ``cascade_tp.cu``."""

    _fields_ = [
        ("w", ctypes.c_void_p),
        ("base", ctypes.c_void_p),
        ("t", ctypes.c_void_p),
        ("out", ctypes.c_void_p),
        ("B", ctypes.c_int),
        ("n", ctypes.c_int),
        ("m", ctypes.c_int),
        ("factors", ctypes.c_float * _CT_MAX_LINKS),
        ("dirs", ctypes.c_int * _CT_MAX_LINKS),
        ("starts", ctypes.c_int * _CT_MAX_LINKS),
    ]


def _cascade_links(factors, dirs, starts):
    factors = tuple(float(f) for f in factors)
    dirs = tuple(int(d) for d in dirs)
    starts = tuple(int(s) for s in starts)
    if not len(factors) == len(dirs) == len(starts):
        raise DSPFatal("factors/walk_forward/start_from must have equal length")
    if any(s >= k for k, s in enumerate(starts)):
        raise DSPFatal("start_from must reference an earlier time point")
    return factors, dirs, starts


def _cascade_thresholds(w, a_base, factors):
    """The links' thresholds ``factor_k * base`` in ``w``'s type, with
    the engine's arithmetic for a ``0.99*trapTmax`` expression (a python
    float times the tensor), so that the fused and the unfused chains see
    the same bits; factor 1 is the base itself."""
    base = as_tensor(a_base, w, w.dtype).expand(w.shape[:-1])
    return [f * base if f != 1.0 else base for f in factors]


def cascade_tp_plain(w, a_base, t_start, factors, dirs, starts, badrow=None):
    """Plain version of K2: the links one by one, each a
    ``time_point_thresh`` search (``_crossing_masks`` + ``_first_true_from``)
    from ``t_start`` or from an earlier link's result. Returns the ``m``
    time points; a link is NaN where its start is bad (NaN row, NaN,
    non-integral or out-of-range start, or a bad earlier link), its
    threshold is NaN, or no crossing is found."""
    from ._helpers import isnan_any, nanmask
    from .time_point_thresh import _crossing_masks, _first_true_from, _start_index

    factors, dirs, starts = _cascade_links(factors, dirs, starts)
    *lead, n = w.shape
    thr = _cascade_thresholds(w, a_base, factors)
    t, ti0, ok0 = _start_index(t_start, tuple(lead), n, w.device)
    row = isnan_any(w, 1) if badrow is None else badrow
    root_bad = row | isnan_any(t) | ~ok0
    results, bads = [], []
    for k in range(len(factors)):
        if starts[k] < 0:
            s, sbad = ti0, root_bad
        else:
            sbad = bads[starts[k]]
            prev = torch.where(sbad, 0.0, results[starts[k]])
            s = prev.to(torch.int64)
        fwd, bwd = _crossing_masks(w, thr[k])
        mask, sgn = (fwd, +1) if dirs[k] == 1 else (bwd, -1)
        idx, found = _first_true_from(mask, s, sgn)
        bad = sbad | torch.isnan(thr[k]) | ~found
        results.append(nanmask(bad, idx.to(w.dtype)))
        bads.append(bad)
    return tuple(results)


def cascade_tp(w, a_base, t_start, factors, dirs, starts, badrow=None):
    """K2: a cascade of ``m`` threshold searches over each row of ``w``.
    Link ``k`` has the threshold ``factors[k] * a_base``, walks forward
    (``dirs[k] == 1``: first crossing at or after its start) or backward
    (last crossing at or before it), and starts from ``t_start``
    (``starts[k] == -1``) or from link ``starts[k]``'s result. The kernel
    takes the base and the factors and forms each threshold with the bits
    of :func:`_cascade_thresholds`. Bit-identical to
    :func:`cascade_tp_plain`; ``badrow`` is used on the CPU only (the
    kernel scans its staged row)."""
    factors, dirs, starts = _cascade_links(factors, dirs, starts)
    if w.device.type == "cpu":
        return cascade_tp_plain(w, a_base, t_start, factors, dirs, starts, badrow)
    _require_cuda_f32(w, "cascade_tp")
    m = len(factors)
    if not 1 <= m <= _CT_MAX_LINKS:
        raise ValueError(
            f"cascade_tp: the CUDA kernel takes 1 to {_CT_MAX_LINKS} links, "
            f"got {m}"
        )
    *lead, n = w.shape
    B = math.prod(lead)
    row_bytes = 4 * (-(-n // 4) * 4)  # a warp's buffer: n rounded up to 16 B
    if row_bytes > _MAX_SMEM:
        raise ValueError(
            f"cascade_tp: a row of {n} samples needs {row_bytes} bytes of "
            f"shared memory; one block holds at most {_MAX_SMEM}"
        )
    lib = _lib("cascade_tp")
    dev = w.device
    base = as_tensor(a_base, w, w.dtype).expand(lead).contiguous()
    t = torch.as_tensor(t_start, device=dev)
    if t.dtype == torch.float64:
        raise TypeError("cascade_tp: the CUDA kernel takes a float32 start")
    t = t.to(torch.float32).expand(lead).contiguous()
    out = torch.empty((m, B), dtype=torch.float32, device=dev)
    P = _CascadeParams()
    P.w, P.base, P.t, P.out = w.data_ptr(), base.data_ptr(), t.data_ptr(), out.data_ptr()
    P.B, P.n, P.m = B, n, m
    P.factors[:m], P.dirs[:m], P.starts[:m] = factors, dirs, starts
    rc = lib.dspeed_cascade_tp(ctypes.byref(P), _stream())
    _check_rc(lib, rc, "cascade_tp")
    LAUNCHES["cascade_tp"] += 1
    return out.view(m, *lead).unbind(0)


def cascade_tp_launch(n: int) -> dict:
    """How K2 launches for rows of ``n`` samples on this card: rows (one a
    warp) and threads a block, shared memory per block, blocks per SM, and
    the kernel's registers and local (spill) bytes per thread."""
    lib = _lib("cascade_tp")
    out = (ctypes.c_int * 6)()
    _check_rc(lib, lib.dspeed_cascade_tp_config(int(n), out), "cascade_tp")
    keys = ("rows_per_block", "threads", "smem_bytes", "blocks_per_sm",
            "registers", "local_bytes")
    return dict(zip(keys, out))


# ---------------------------------------------------------------------------
# K5 / K6: the A/E current front
# ---------------------------------------------------------------------------


class _CurrentParams(ctypes.Structure):
    """Field for field the ``CurrentParams`` struct of ``fused_current.cu``."""

    _fields_ = [
        ("c", ctypes.c_void_p),
        ("H", ctypes.c_void_p),
        ("out", ctypes.c_void_p * 4),
        ("B", ctypes.c_int),
        ("n_curr", ctypes.c_int),
        ("ratio", ctypes.c_int),
        ("half", ctypes.c_int),
        ("n_up", ctypes.c_int),
        ("L", ctypes.c_int),
        ("num", ctypes.c_int),
        ("mtype", ctypes.c_int),
        ("need", ctypes.c_int * 4),
        ("W", ctypes.c_int),
        ("EL", ctypes.c_int),
        ("ERW", ctypes.c_int),
        ("nq", ctypes.c_int),
        ("q_min", ctypes.c_int),
    ]


def _current_geometry(c, ratio, half, n_up, L, num, mtype, need):
    """The front's arguments as ints, checked against its limits
    (``fused.py:126-146`` of the JAX package): an integer ratio whose
    replication map writes every output slot, ``half = ratio // 2`` (the
    upsampler's map), ``0 <= L < n_up`` and ``L <= 128``, ``num >= 0`` and
    ``mtype`` in 0, 1, 2."""
    ratio, half, n_up = int(ratio), int(half), int(n_up)
    L, num, mtype = int(L), int(num), int(mtype)
    need = tuple(bool(x) for x in need)
    if len(need) != 4:
        raise DSPFatal("need must have four entries")
    n_curr = c.shape[-1]
    geom = (f"n_curr={n_curr}, ratio={ratio}, half={half}, n_up={n_up}, "
            f"L={L}, num={num}, mtype={mtype}")
    if ratio < 1 or half != ratio // 2 or half + n_up > n_curr * ratio:
        raise ValueError(
            f"fused_current: the replication map of ratio {ratio} must write "
            f"every one of n_up slots with half = ratio // 2 ({geom})"
        )
    if not (0 <= L < n_up and L <= 128 and num >= 0 and mtype in (0, 1, 2)):
        raise ValueError(f"fused_current: geometry out of range ({geom})")
    return (ratio, half, n_up, L, num, mtype), need, geom


def fused_current_plain(c, ratio, half, n_up, L, num, mtype, need=(True,) * 4):
    """Plain version of K5 and K6: the port's ``upsampler(c, ratio)`` ->
    ``moving_window_multi(., L, num, mtype)`` -> ``min_max`` — the JAX
    package's fallback composition (``fused.py:153-161``). Returns
    ``(t_min, t_max, a_min, a_max)``; ``need`` is accepted for the kernels'
    signature and every output is computed."""
    from .min_max import min_max
    from .moving_windows import moving_window_multi
    from .upsampler import upsampler

    (ratio, _half, n_up, L, num, mtype), _, _ = _current_geometry(
        c, ratio, half, n_up, L, num, mtype, need
    )
    (up,) = upsampler(c, float(ratio), dims={"m": n_up})
    (av,) = moving_window_multi(up, float(L), float(num), np.int32(mtype))
    return min_max(av)


def _extrema(y, need):
    """First-occurrence ``(t_min, t_max, a_min, a_max)`` of the rows of
    ``y``; an extremum that ``need`` does not ask for is not reduced, and
    an output nothing needs holds 0 (the kernels' rule)."""
    n = y.shape[-1]
    idx = torch.arange(n, device=y.device)
    zero = torch.zeros(y.shape[:-1], dtype=y.dtype, device=y.device)
    t_min = t_max = a_min = a_max = zero
    if need[0] or need[2]:
        a_min = y.amin(dim=-1)
        if need[0]:
            t_min = torch.where(y == a_min[..., None], idx, n).amin(dim=-1)
    if need[1] or need[3]:
        a_max = y.amax(dim=-1)
        if need[1]:
            t_max = torch.where(y == a_max[..., None], idx, n).amin(dim=-1)
    return t_min.to(y.dtype), t_max.to(y.dtype), a_min, a_max


def fused_current_poly_plain(c, ratio, half, n_up, L, num, mtype,
                             need=(True,) * 4):
    """K5's arithmetic in PyTorch, for holding the kernel and its plan: the
    two edge windows of :mod:`._poly_plan` run the staged cascade (the
    port's moving-window bodies, float64 prefix sums rounded to float32 per
    stage), the interior is the per-phase filters ``Hm`` (in float32, summed
    in ascending tap order) on the current itself, and the regions'
    first-occurrence extrema are taken over the curve laid out in ascending
    order, as the kernel's ordered fold takes them. NaN rows poison all four
    outputs; ``need`` elides as in the kernel. Raises where the plan does
    not hold."""
    from ._helpers import isnan_any, nanmask
    from ._poly_plan import W, poly_plan
    from .moving_windows import mw_cascade

    (ratio, half, n_up, L, num, mtype), need, geom = _current_geometry(
        c, ratio, half, n_up, L, num, mtype, need
    )
    plan = poly_plan(c.shape[-1], ratio, half, n_up, L, num, mtype)
    if plan is None:
        raise ValueError(f"fused_current_poly_plain: no polyphase plan ({geom})")
    EL, ERW, nq, q_min = plan["EL"], plan["ERW"], plan["nq"], plan["q_min"]
    dev = c.device
    j = torch.arange(W, device=dev)

    def edge(j0):
        return mw_cascade(c[..., (j0 + j + half) // ratio], float(L), num, mtype)

    left = edge(0)[..., :EL]
    right = edge(n_up - W)[..., W - ERW:]
    total_t = (n_up - ERW - EL) // ratio
    t = plan["t0_base"] + torch.arange(total_t, device=dev)
    H = torch.from_numpy(plan["Hm"]).to(device=dev, dtype=c.dtype)
    y = torch.zeros((*c.shape[:-1], total_t, ratio), dtype=c.dtype, device=dev)
    for k in range(nq):
        y = y + c[..., t + q_min + k][..., None] * H[:, k]
    curve = torch.cat([left, y.flatten(-2), right], dim=-1)
    bad = isnan_any(c, 1)
    return tuple(nanmask(bad, o) for o in _extrema(curve, need))


def _launch_current(lib, entry, c, geometry, need, plan=None):
    ratio, half, n_up, L, num, mtype = geometry
    *lead, n_curr = c.shape
    B = int(np.prod(lead, dtype=np.int64))
    out = torch.empty((4, B), dtype=torch.float32, device=c.device)
    P = _CurrentParams()
    P.c = c.data_ptr()
    for q in range(4):
        P.out[q] = out[q].data_ptr()
        P.need[q] = int(need[q])
    P.B, P.n_curr, P.ratio, P.half = B, n_curr, ratio, half
    P.n_up, P.L, P.num, P.mtype = n_up, L, num, mtype
    if plan is not None:
        from ._poly_plan import W

        H = _taps_on([plan["Hm"].ravel()], c.device)
        P.H, P.W = H.data_ptr(), W
        P.EL, P.ERW, P.nq, P.q_min = (
            plan["EL"], plan["ERW"], plan["nq"], plan["q_min"]
        )
    rc = entry(ctypes.byref(P), _stream())
    _check_rc(lib, rc, "fused_current")
    return tuple(out[q].reshape(lead) for q in range(4))


def fused_current_poly_launch(n_curr: int, ratio: int, n_up: int, nq: int,
                              need=(False, True, False, True)) -> dict:
    """How K5 launches for rows of ``n_curr`` current samples, ``ratio``
    phases of ``nq`` taps and ``n_up`` upsampled samples on this card, in
    the instance for ``need`` (the flagship chain's by default): events
    (one a warp) and threads a block, shared memory per block, blocks per
    SM, and the kernel's registers and local (spill) bytes per thread."""
    lib = _lib("fused_current")
    out = (ctypes.c_int * 6)()
    rc = lib.dspeed_fused_current_poly_config(
        int(n_curr), int(ratio), int(n_up), int(nq),
        int(bool(need[0] or need[2])), int(bool(need[1] or need[3])), out,
    )
    _check_rc(lib, rc, "fused_current_poly")
    keys = ("events_per_block", "threads", "smem_bytes", "blocks_per_sm",
            "registers", "local_bytes")
    return dict(zip(keys, out))


def fused_current_launch(n_up: int, need=(False, True, False, True)) -> dict:
    """How K6 launches for rows of ``n_up`` upsampled samples on this card,
    in the instance for ``need`` (the flagship chain's by default): threads
    and rows a block, shared memory per block (the float64 prefix, and the
    row where a thread's run is not held in registers), blocks per SM, and
    the kernel's registers and local (spill) bytes per thread."""
    lib = _lib("fused_current")
    out = (ctypes.c_int * 6)()
    rc = lib.dspeed_fused_current_config(
        int(n_up), int(bool(need[0] or need[2])), int(bool(need[1] or need[3])),
        out,
    )
    _check_rc(lib, rc, "fused_current")
    keys = ("threads", "rows_per_block", "smem_bytes", "blocks_per_sm",
            "registers", "local_bytes")
    return dict(zip(keys, out))


def fused_current_updomain(c, ratio, half, n_up, L, num, mtype,
                           need=(True,) * 4):
    """K6, the up-domain route of :func:`fused_current`: the cascade at the
    full upsampled width, one row a block, for any geometry whose float64
    prefix (and, past 5120 samples, its row) fits one block's shared
    memory. Same outputs as :func:`fused_current`."""
    geometry, need, geom = _current_geometry(
        c, ratio, half, n_up, L, num, mtype, need
    )
    if c.device.type == "cpu":
        return fused_current_plain(c, *geometry, need)
    _require_cuda_f32(c, "fused_current")
    lib = _lib("fused_current")
    smem = lib.dspeed_fused_current_smem_bytes(geometry[2])
    if smem > _MAX_SMEM or (geometry[4] > 0 and geometry[3] < 1):
        raise ValueError(
            f"fused_current: the up-domain kernel does not take this geometry "
            f"({geom}: {smem} bytes of shared memory, at most {_MAX_SMEM}; "
            f"L >= 1 where num > 0)"
        )
    outs = _launch_current(lib, lib.dspeed_fused_current, c, geometry, need)
    LAUNCHES["fused_current"] += 1
    return outs


def fused_current(c, ratio, half, n_up, L, num, mtype, need=(True,) * 4):
    """The A/E current front: upsample each row of ``c`` ``(..., n_curr)``
    by replication (``x[j] = c[(j + half) // ratio]``, ``j < n_up``), run
    ``num`` alternating moving averages of ``L`` samples (``mtype`` as in
    ``moving_window_multi``), and return the first-occurrence ``(t_min,
    t_max, a_min, a_max)`` per row. ``need`` flags the outputs anything
    reads: an extremum neither of whose outputs is needed is not reduced,
    and an output nothing needs holds 0. A row with a NaN gives NaN, and
    so does a row with an infinite sample, whose cascade's prefix
    differences are NaN (on the card, K5 gives all four outputs NaN there,
    as the plain version does).

    CPU: :func:`fused_current_plain`. CUDA: K5, the polyphase kernel, where
    :func:`._poly_plan.poly_plan` finds a plan for the geometry, else K6
    (:func:`fused_current_updomain`). Both are float32 kernels; a geometry
    that fits neither raises. On a near-tie the two routes, and the plain
    version, may report indices some upsampled samples apart, as in the JAX
    package (``_pallas.py:1413-1420``): the amplitudes agree within float32
    rounding."""
    from ._poly_plan import poly_plan

    geometry, need, geom = _current_geometry(
        c, ratio, half, n_up, L, num, mtype, need
    )
    if c.device.type == "cpu":
        return fused_current_plain(c, *geometry, need)
    _require_cuda_f32(c, "fused_current")
    plan = None
    if geometry[3] >= 1 or geometry[4] == 0:
        plan = poly_plan(c.shape[-1], *geometry)
    if plan is None:
        return fused_current_updomain(c, *geometry, need)
    lib = _lib("fused_current")
    ratio, _, n_up = geometry[:3]
    from ._poly_plan import W

    smem = lib.dspeed_fused_current_poly_smem_bytes(
        c.shape[-1], n_up, ratio * plan["nq"], W
    )
    if smem > _MAX_SMEM:
        raise ValueError(
            f"fused_current: the polyphase kernel needs {smem} bytes of shared "
            f"memory ({geom}); one block holds at most {_MAX_SMEM}"
        )
    outs = _launch_current(
        lib, lib.dspeed_fused_current_poly, c, geometry, need, plan
    )
    LAUNCHES["fused_current_poly"] += 1
    return outs


# ---------------------------------------------------------------------------
# K7: a generic fusion group as one row-tape launch
# ---------------------------------------------------------------------------

# the inputs and stored outputs (GEN_MAX_EXT, GEN_MAX_ESC), the tape's ints
# and doubles (GEN_MAX_CODE, GEN_MAX_DP) that K7's parameters hold; a group
# over any of them is refused at lowering
GEN_MAX_EXT, GEN_MAX_ESC = 32, 64
GEN_MAX_CODE, GEN_MAX_DP = 3072, 512


class _GenParams(ctypes.Structure):
    """Field for field the ``GenParams`` struct of ``generic_rows.cu``."""

    _fields_ = [
        ("taps", ctypes.c_void_p),
        ("B", ctypes.c_int),
        ("n_ops", ctypes.c_int),
        ("n_slots", ctypes.c_int),
        ("n_scal", ctypes.c_int),
        ("scratch_dbl", ctypes.c_int),
        ("arena_floats", ctypes.c_int),
        ("tape_dbl", ctypes.c_int),
        ("n_dpar", ctypes.c_int),
        ("n_code", ctypes.c_int),
        ("ext", ctypes.c_void_p * GEN_MAX_EXT),
        ("ext_stride", ctypes.c_longlong * GEN_MAX_EXT),
        ("esc", ctypes.c_void_p * GEN_MAX_ESC),
        ("dpar", ctypes.c_double * GEN_MAX_DP),
        ("code", ctypes.c_int * GEN_MAX_CODE),
    ]


def _slot_value(program, roots: dict, sid: int):
    """Slot ``sid``'s value from its root's (slot id -> tensor): a slice is a
    view of its root, an alias the root itself."""
    s = program.slots[sid]
    v = roots[s.root]
    if s.kind == "plane" and (s.start, s.length) != (0, program.slots[s.root].length):
        v = v[..., s.start : s.start + s.length]
    return v


def _escape_values(program, roots: dict) -> dict:
    return {k: _slot_value(program, roots, sid) for k, sid in program.escapes.items()}


def generic_rows_plain(program, vals: dict) -> dict:
    """Plain version of K7: the tape of ``program`` (:mod:`._tile_program`)
    walked in PyTorch. Each op calls its member kernel's own body on the
    slots' values, cast as the unfused step casts them, and binds its
    outputs in the slots' types; views are slices of their root. On the CPU
    this is the unfused chain's arithmetic exactly, but where K7 sums in an
    order of its own: a member whose kernel names its variant in
    ``k7_plain`` runs that variant (``double_pole_zero``'s pole by runs,
    ``mean_below_threshold``, ``linear_slope_diff``, ``trap_pickoff``,
    ``presum``, ``trap_filter`` and the moving windows: K7's block sums,
    prefix and sums in turn), a dense or classification layer sums in K7's
    order (:func:`.ml.layer_rows`), and so does the reduce op
    (:func:`.._numpy_funcs.k7_reduce`). A float64 program (``program.f64``)
    passes ``f64=True`` to the variant (and to the layers' and the
    reductions' sums), which then takes K7's float64 order (the prefix ops,
    the fits, the banded and direct convolutions, the polynomial residual,
    soft pile-up) and rounds nothing to float32. A member lowered
    into several ops (soft pile-up: its fit, then the row less the fit)
    gives every op's outputs in turn, and each op binds its own. An
    ``ewise`` op takes its per-row scalars along the row, as the unfused
    step's fetch broadcasts them. Returns the escapes."""
    from .._numpy_funcs import K7_SUMS, k7_reduce
    from .ml import layer_rows
    from ._tile_program import OPCODES

    roots = {program.by_key[k]: vals[k] for k in program.ext_keys}
    kw = {"f64": True} if program.f64 else {}
    taken: dict = {}  # a member's outputs bound so far, by its step

    def value(sid, dtype):
        v = _slot_value(program, roots, sid)
        return v if dtype is None or v.dtype == dtype else v.to(dtype)

    for op in program.ops:
        if op.code == OPCODES["load"]:
            continue
        args = [value(a[1], a[2]) if a[0] == "slot" else a[1] for a in op.args]
        if op.code == OPCODES["ewise"]:
            args = [a[:, None] if isinstance(a, torch.Tensor) and a.ndim == 1 else a
                    for a in args]
        kern = op.step.kernel
        variant = getattr(kern, "k7_plain", None)
        if op.code == OPCODES["reduce"] and kern.__name__ in K7_SUMS:
            outs = (k7_reduce(kern.__name__, args[0], **kw),)
        elif op.code == OPCODES["dense"] and op.ip[0]:
            outs = (layer_rows(args[0], args[1], args[2] if len(args) == 4 else None,
                               op.ip[1], kern.__name__, **kw),)
        elif getattr(kern, "uses_dims", False):
            outs = (variant or kern.fn)(*args, dims=op.step.dims,
                                        **(kw if variant else {}))
        elif variant is not None:
            outs = variant(*args, **kw)
        else:
            outs = kern(*args)
        outs = outs if isinstance(outs, tuple) else (outs,)
        k = taken.get(id(op.step), 0)
        taken[id(op.step)] = k + len(op.outs)
        for sid, o in zip(op.outs, outs[k:]):
            want = program.slots[sid].dtype
            roots[sid] = o if o.dtype == want else o.to(want)
    return _escape_values(program, roots)


def _program_on(program, device):
    """``(params, taps)``: the launch parameters with the tape filled in,
    and the taps on ``device``, both made once per program."""
    arrs = program._dev.get(str(device))
    if arrs is None:
        ints, dbls, taps = program.encode()  # _plan refused a longer tape
        P = _GenParams()
        ctypes.memmove(P.code, ints.ctypes.data, ints.nbytes)
        ctypes.memmove(P.dpar, dbls.ctypes.data, dbls.nbytes)
        P.n_ops, P.n_slots = len(program.ops), len(program.slots)
        P.n_scal, P.scratch_dbl = program.n_scal, program.scratch_dbl
        P.arena_floats = program.arena_floats
        P.tape_dbl, P.n_dpar, P.n_code = program.tape_dbl, len(dbls), len(ints)
        arrs = program._dev[str(device)] = (P, torch.from_numpy(taps).to(device))
    return arrs


def generic_rows_launch(program) -> dict:
    """How K7 launches a lowered program on this card: threads a block,
    blocks per SM at the program's shared memory, the kernel's registers
    and local (spill) bytes per thread, and its shared bytes (static, and
    the program's); the float64 kernel for a float64 program."""
    lib = _lib("generic_rows")
    out = (ctypes.c_int * 5)()
    rc = lib.dspeed_generic_rows_config(int(program.smem_bytes), int(program.f64), out)
    _check_rc(lib, rc, "generic_rows")
    keys = ("threads", "blocks_per_sm", "registers", "local_bytes",
            "static_smem_bytes")
    launch = dict(zip(keys, out))
    launch["smem_bytes"] = int(program.smem_bytes)
    return launch


def generic_rows(program, vals: dict) -> dict:
    """K7: run a lowered generic group (:func:`._tile_program.lower`) over
    the rows of its external inputs ``vals`` (env key -> ``(B,)`` scalar or
    ``(B, n)`` plane, float32, float64 or bool, its rows contiguous at any
    row stride), one block per row, and return its escapes (env key ->
    tensor) with the shapes and strides the unfused chain gives them: an
    escaping slice is a view of its root's plane. A float64 program runs
    K7's float64 kernel. CPU tensors run :func:`generic_rows_plain`."""
    ref = vals[program.ext_keys[0]]
    if ref.device.type == "cpu":
        return generic_rows_plain(program, vals)
    lib = _lib("generic_rows")
    dev = ref.device
    B = int(ref.shape[0])
    template, taps = _program_on(program, dev)
    P = _GenParams.from_buffer_copy(template)
    keep = []
    for e, key in enumerate(program.ext_keys):
        v = vals[key]
        if v.device != dev or v.shape[0] != B:
            raise ValueError(f"generic_rows: input {key} is not {B} rows on {dev}")
        if v.ndim == 2:
            if v.dtype != program.slots[program.by_key[key]].dtype:
                raise TypeError(f"generic_rows: input {key} is {v.dtype}, the "
                                f"program's plane {program.slots[program.by_key[key]].dtype}")
            if v.stride(1) != 1:
                v = v.contiguous()
            P.ext_stride[e] = v.stride(0)
        elif v.stride(0) != 1:
            v = v.contiguous()
        keep.append(v)
        P.ext[e] = v.data_ptr()
    from ._tile_program import esc_dtype

    roots = {program.by_key[k]: vals[k] for k in program.ext_keys}
    for q, sid in enumerate(program.esc_roots):
        s = program.slots[sid]
        shape = (B, s.length) if s.kind == "plane" else (B,)
        roots[sid] = torch.empty(shape, dtype=esc_dtype(s), device=dev)
        P.esc[q] = roots[sid].data_ptr()
    P.taps, P.B = taps.data_ptr(), B
    rc = lib.dspeed_generic_rows(ctypes.byref(P), program.smem_bytes, int(program.f64),
                                 _stream())
    _check_rc(lib, rc, "generic_rows")
    LAUNCHES["generic_rows"] += 1
    for sid in program.esc_roots:
        want = program.slots[sid].dtype
        if roots[sid].dtype != want:  # a bool's or an int64's float64 copy
            roots[sid] = esc_value(roots[sid], want)
    return _escape_values(program, roots)


def esc_value(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A bool's or an int64's float64 copy (K7's ``put``) in its slot's
    type; an int64 at or past 2**63 (``convert_int``'s mark for a result
    that is not an integer, ``iinfo(int64).max``) saturates, as the card's
    conversion does and the host's need not."""
    if dtype != torch.int64:
        return v.to(dtype)
    big = torch.iinfo(torch.int64).max
    return torch.where(v >= 2.0**63, big, v.to(dtype))


# ---------------------------------------------------------------------------
# the Billauer peak finder's sweep (no Pallas counterpart: a lax.scan)
# ---------------------------------------------------------------------------


class _PeakdetParams(ctypes.Structure):
    """Field for field the ``PeakdetParams`` struct of ``peakdet_scan.cu``."""

    _fields_ = [
        ("w", ctypes.c_void_p),
        ("stride", ctypes.c_longlong),
        ("dmax", ctypes.c_void_p),
        ("dmin", ctypes.c_void_p),
        ("amax", ctypes.c_void_p),
        ("amin", ctypes.c_void_p),
        ("smax", ctypes.c_void_p),
        ("smin", ctypes.c_void_p),
        ("nmax", ctypes.c_void_p),
        ("nmin", ctypes.c_void_p),
    ] + [(f, ctypes.c_int) for f in ("B", "n", "m_max", "m_min", "reverse", "f64")]


def _row_params(w, *xs):
    """Each of ``xs`` (scalar or ``(B,)``) as a contiguous ``(B,)`` tensor in
    ``w``'s type on its device."""
    return [per_row(x, w).contiguous() for x in xs]


def peakdet_scan_plain(w, dmax, dmin, amax, amin, m_max, m_min, reverse=False):
    """Plain version of :func:`peakdet_scan`: the step of the JAX package's
    ``_peakdet_scan`` (``peak_finding.py:49``) as a loop over the samples in
    PyTorch, batched over the rows. Returns ``(vt_max (B, m_max), vt_min
    (B, m_min), n_max (B,) int32, n_min (B,) int32)``: NaN-padded sample
    indices in declaration order, in ``w``'s type."""
    B, n = w.shape
    dt, dev = w.dtype, w.device
    dM, dm, aM, am = _row_params(w, dmax, dmin, amax, amin)
    vx = torch.full((B,), -math.inf, dtype=dt, device=dev)
    vn = torch.full((B,), math.inf, dtype=dt, device=dev)
    ix = torch.zeros(B, dtype=torch.int32, device=dev)
    im = torch.zeros_like(ix)
    find_max = torch.ones(B, dtype=torch.bool, device=dev)
    nmx = torch.zeros_like(ix)
    nmn = torch.zeros_like(ix)
    smax = torch.full((B, m_max), math.nan, dtype=dt, device=dev)
    smin = torch.full((B, m_min), math.nan, dtype=dt, device=dev)
    slot_mx = torch.arange(m_max, device=dev)[None, :]
    slot_mn = torch.arange(m_min, device=dev)[None, :]
    for i in (range(n - 1, -1, -1) if reverse else range(n)):
        wi = w[:, i]
        iv = torch.full((B,), i, dtype=torch.int32, device=dev)
        newmax = wi > vx
        vx = torch.where(newmax, wi, vx)
        ix = torch.where(newmax, iv, ix)
        newmin = wi < vn
        vn = torch.where(newmin, wi, vn)
        im = torch.where(newmin, iv, im)
        decl_max = find_max & (wi < vx - dM) & (nmx < m_max) & (vx > aM)
        decl_min = ~find_max & (wi > vn + dm) & (nmn < m_min) & (vn < am)
        smax = torch.where(decl_max[:, None] & (slot_mx == nmx[:, None]),
                           ix[:, None].to(dt), smax)
        smin = torch.where(decl_min[:, None] & (slot_mn == nmn[:, None]),
                           im[:, None].to(dt), smin)
        nmx = nmx + decl_max.to(torch.int32)
        nmn = nmn + decl_min.to(torch.int32)
        # a declaration restarts the opposite tracker at the current sample
        vn = torch.where(decl_max, wi, vn)
        im = torch.where(decl_max, iv, im)
        vx = torch.where(decl_min, wi, vx)
        ix = torch.where(decl_min, iv, ix)
        find_max = torch.where(decl_max, False, torch.where(decl_min, True, find_max))
    return smax, smin, nmx, nmn


def peakdet_scan_launch() -> dict:
    """How the sweep launches on this card (its float32 instance): threads
    a block (a warp a row), blocks per SM, registers and local (spill)
    bytes a thread."""
    lib = _lib("peakdet_scan")
    out = (ctypes.c_int * 4)()
    _check_rc(lib, lib.dspeed_peakdet_scan_config(out), "peakdet_scan")
    return dict(zip(("threads", "blocks_per_sm", "registers", "local_bytes"), out))


def peakdet_scan(w, dmax, dmin, amax, amin, m_max, m_min, reverse=False):
    """One direction of the Billauer sweep over the rows of ``w`` (``(B,
    n)``; ``dmax``, ``dmin``, ``amax``, ``amin`` scalars or ``(B,)``), one
    warp per row, ``reverse`` visiting ``n-1 ... 0``; see
    :func:`peakdet_scan_plain` for the outputs, which it equals bit for bit.
    CPU tensors run :func:`peakdet_scan_plain`."""
    if w.device.type == "cpu":
        return peakdet_scan_plain(w, dmax, dmin, amax, amin, m_max, m_min, reverse)
    if w.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"peakdet_scan: the CUDA kernel takes float rows, got {w.dtype}")
    if w.dim() != 2 or w.stride(1) != 1:
        raise ValueError("peakdet_scan: the CUDA kernel takes rows of contiguous samples")
    lib = _lib("peakdet_scan")
    B, n = w.shape
    dev = w.device
    pars = _row_params(w, dmax, dmin, amax, amin)
    smax = torch.empty((B, m_max), dtype=w.dtype, device=dev)
    smin = torch.empty((B, m_min), dtype=w.dtype, device=dev)
    nmx = torch.empty(B, dtype=torch.int32, device=dev)
    nmn = torch.empty(B, dtype=torch.int32, device=dev)
    P = _PeakdetParams(
        w.data_ptr(), w.stride(0), *(t.data_ptr() for t in pars),
        smax.data_ptr(), smin.data_ptr(), nmx.data_ptr(), nmn.data_ptr(),
        B, n, int(m_max), int(m_min), int(bool(reverse)),
        int(w.dtype == torch.float64),
    )
    rc = lib.dspeed_peakdet_scan(ctypes.byref(P), _stream())
    _check_rc(lib, rc, "peakdet_scan")
    LAUNCHES["peakdet_scan"] += 1
    return smax, smin, nmx, nmn


# ---------------------------------------------------------------------------
# linear recurrences along a row (no Pallas counterpart: scans and matmuls)
# ---------------------------------------------------------------------------


class _RecParams(ctypes.Structure):
    """Field for field the ``RecParams`` struct of ``recurrence.cu``."""

    _fields_ = [
        ("u", ctypes.c_void_p),
        ("u_stride", ctypes.c_longlong),
        ("y", ctypes.c_void_p),
        ("m", ctypes.c_void_p),
        ("m_const", ctypes.c_double),
        ("c", ctypes.c_void_p),
        ("y0", ctypes.c_void_p),
        ("ring", ctypes.c_void_p),
    ] + [(f, ctypes.c_int) for f in ("B", "n", "order", "m_kind", "c_per_row",
                                     "reverse", "f64")]


_M_CONST, _M_ROW, _M_POS = 0, 1, 2


def _rec_args(u, m, y0, c, per_position):
    """The recurrence's operands in float64 on ``u``'s device: ``(m, m_kind,
    c, y0)``, with ``m`` a python float (``m_kind`` 0) or a ``(B,)`` /
    ``(n,)`` tensor, ``c`` None or ``(d,)`` / ``(B, d)``, ``y0`` None or
    ``(B,)`` (first order) / ``(B, d)``."""
    B, n = u.shape
    f64, dev = torch.float64, u.device

    def t64(x):
        if isinstance(x, torch.Tensor):
            return x.to(dev, f64)
        return torch.as_tensor(np.asarray(x, np.float64), device=dev)

    m_kind = _M_CONST
    if c is None:
        if isinstance(m, torch.Tensor) and m.ndim:
            m = t64(m)
            m_kind = _M_POS if per_position else _M_ROW
            if m.shape != ((n,) if per_position else (B,)):
                raise ValueError(f"recurrence: multipliers of shape {tuple(m.shape)}")
        else:
            m = float(m)
        d = 1
    else:
        c = t64(c)
        d = c.shape[-1]
        if c.ndim not in (1, 2) or (c.ndim == 2 and c.shape[0] != B) or d == 0:
            raise ValueError(f"recurrence: coefficients of shape {tuple(c.shape)}")
    if y0 is not None:
        y0 = t64(y0)
        y0 = y0.expand(B) if c is None else y0.expand(B, d)
        if c is None and y0.ndim != 1:
            raise ValueError("recurrence: a first-order state is one value a row")
    return m, m_kind, c, y0


def recurrence_plain(u, m=0.0, y0=None, *, c=None, reverse=False,
                     per_position=False):
    """Plain version of :func:`recurrence`: a loop over the samples in
    PyTorch, batched over the rows, each product and sum rounded once in
    float64, in the kernel's order."""
    B, n = u.shape
    m, _, c, y0 = _rec_args(u, m, y0, c, per_position)
    uu = u.to(torch.float64)
    out = torch.empty((B, n), dtype=torch.float64, device=u.device)
    order = range(n - 1, -1, -1) if reverse else range(n)
    if c is None:
        y = torch.zeros(B, dtype=torch.float64, device=u.device) if y0 is None else y0
        for i in order:
            y = (m[i] if per_position else m) * y + uu[:, i]
            out[:, i] = y
        return out.to(u.dtype)
    d = c.shape[-1]
    hist = [torch.zeros(B, dtype=torch.float64, device=u.device) if y0 is None
            else y0[:, k] for k in range(d)]
    ck = [c[..., k] for k in range(d)]
    for i in order:
        v = uu[:, i]
        for k in range(d):
            v = v - ck[k] * hist[k]
        hist = [v] + hist[:-1]
        out[:, i] = v
    return out.to(u.dtype)


def recurrence_launch() -> dict:
    """How the first-order float32 instance launches on this card: rows a
    block, blocks per SM, registers and local (spill) bytes a thread, its
    shared bytes and threads a block."""
    lib = _lib("recurrence")
    out = (ctypes.c_int * 6)()
    _check_rc(lib, lib.dspeed_recurrence_config(out), "recurrence")
    return dict(zip(("rows", "blocks_per_sm", "registers", "local_bytes",
                     "smem_bytes", "threads"), out))


def recurrence(u, m=0.0, y0=None, *, c=None, reverse=False, per_position=False):
    """A linear recurrence along each row of ``u`` (``(B, n)``, float32 or
    float64), one thread per row (32 rows a block of 128 threads, which
    stage the rows through shared memory), in float64, written in ``u``'s
    type:

    - without ``c``, first order: ``y[i] = m * y[i-1] + u[i]``, ``m`` a
      number, a ``(B,)`` tensor (one a row) or, with ``per_position``, an
      ``(n,)`` tensor; ``y0`` (a number or ``(B,)``) is ``y[-1]``; with
      ``reverse`` it runs from the end: ``y[i] = m * y[i+1] + u[i]``;
    - with ``c`` (``(d,)`` or ``(B, d)``), order d:
      ``y[i] = u[i] - sum_k c[k] * y[i-1-k]``, ``y0`` (``(B, d)``) holding
      ``y[-1], ..., y[-d]``.

    Zero initial state without ``y0``. CPU tensors run
    :func:`recurrence_plain`, which it equals bit for bit."""
    if u.device.type == "cpu":
        return recurrence_plain(u, m, y0, c=c, reverse=reverse,
                                per_position=per_position)
    if u.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"recurrence: the CUDA kernel takes float rows, got {u.dtype}")
    if u.dim() != 2 or u.stride(1) != 1:
        raise ValueError("recurrence: the CUDA kernel takes rows of contiguous samples")
    lib = _lib("recurrence")
    B, n = u.shape
    m, m_kind, c, y0 = _rec_args(u, m, y0, c, per_position)
    y = torch.empty((B, n), dtype=u.dtype, device=u.device)
    keep = [t.contiguous() if isinstance(t, torch.Tensor) else None for t in (m, c, y0)]
    d = 1 if c is None else c.shape[-1]
    ring = None
    if c is not None and d > lib.dspeed_recurrence_smem_order():
        ring = torch.empty((B, d), dtype=torch.float64, device=u.device)
    P = _RecParams(
        u.data_ptr(), u.stride(0), y.data_ptr(),
        keep[0].data_ptr() if keep[0] is not None else None,
        m if m_kind == _M_CONST else 0.0,
        keep[1].data_ptr() if keep[1] is not None else None,
        keep[2].data_ptr() if keep[2] is not None else None,
        ring.data_ptr() if ring is not None else None,
        B, n, d, m_kind, int(c is not None and c.ndim == 2), int(bool(reverse)),
        int(u.dtype == torch.float64),
    )
    rc = lib.dspeed_recurrence(ctypes.byref(P), _stream())
    _check_rc(lib, rc, "recurrence")
    LAUNCHES["recurrence"] += 1
    return y


# ---------------------------------------------------------------------------
# the bi-level zero-crossing trigger's sweep (no Pallas counterpart: a lax.scan)
# ---------------------------------------------------------------------------


class _BilevelParams(ctypes.Structure):
    """Field for field the ``BilevelParams`` struct of ``bilevel_scan.cu``."""

    _fields_ = [
        ("w", ctypes.c_void_p),
        ("stride", ctypes.c_longlong),
        ("pos", ctypes.c_void_p),
        ("neg", ctypes.c_void_p),
        ("gate", ctypes.c_void_p),
        ("start", ctypes.c_void_p),
        ("nc", ctypes.c_void_p),
        ("pol", ctypes.c_void_p),
        ("trig", ctypes.c_void_p),
    ] + [(f, ctypes.c_int) for f in ("B", "n", "m", "f64")]


def bilevel_scan_plain(w, pos, neg, gate, start, m):
    """Plain version of :func:`bilevel_scan`: the step of the JAX package's
    ``bi_level_zero_crossing_time_points`` scan (``time_point_thresh.py:
    460-505``) as a loop over the sample pairs in PyTorch, batched over the
    rows, each row's update in the same order. Returns ``(n_crossings (B,)
    int32, polarity (B, m), trigger (B, m))``, the slots in ``w``'s type,
    NaN where not written."""
    B, n = w.shape
    dt, dev = w.dtype, w.device
    i32 = torch.int32
    above = torch.full((B,), -1, dtype=i32, device=dev)
    below = torch.full((B,), -1, dtype=i32, device=dev)
    crossed = torch.zeros(B, dtype=torch.bool, device=dev)
    pos_cand = torch.zeros(B, dtype=i32, device=dev)
    neg_cand = torch.zeros(B, dtype=i32, device=dev)
    nc = torch.zeros(B, dtype=i32, device=dev)
    pol = torch.full((B, m), math.nan, dtype=dt, device=dev)
    trig = torch.full((B, m), math.nan, dtype=dt, device=dev)
    slots = torch.arange(m, device=dev)[None, :]

    def put(arr, emit, val):
        sel = (emit & (nc < m))[:, None] & (slots == nc[:, None])
        return torch.where(sel, val[:, None], arr)

    zero, one = torch.zeros(B, dtype=dt, device=dev), torch.ones(B, dtype=dt, device=dev)
    for i in range(n - 1):
        w0, w1 = w[:, i], w[:, i + 1]
        act = i >= start
        below_on = below >= 0
        zneg = act & below_on & (w0 <= 0) & (0 < w1)
        crossed = crossed | zneg
        neg_cand = torch.where(zneg, i, neg_cand)
        # the positive threshold, then the zero crossing back down
        pcross = act & (w0 <= pos) & (pos < w1)
        armed = pcross & crossed & below_on
        in_gate = (i - below) < gate
        emit = armed & in_gate
        pol = put(pol, emit, zero)
        trig = put(trig, emit, neg_cand.to(dt))
        nc = nc + emit.to(i32)
        above = torch.where((armed & ~in_gate) | (pcross & ~(crossed & below_on)),
                            i, above)
        below = torch.where(armed, -1, below)
        crossed = torch.where(pcross & below_on, False, crossed)
        above_on = above >= 0
        zpos = act & above_on & (w0 >= 0) & (0 > w1)
        crossed = crossed | zpos
        pos_cand = torch.where(zpos, i, pos_cand)
        # the negative threshold
        ncross = act & (w0 >= neg) & (neg > w1)
        armed = ncross & crossed & above_on
        in_gate = (i - above) < gate
        emit = armed & in_gate
        pol = put(pol, emit, one)
        trig = put(trig, emit, pos_cand.to(dt))
        nc = nc + emit.to(i32)
        below = torch.where((armed & ~in_gate) | (ncross & ~(crossed & above_on)),
                            i, below)
        above = torch.where(armed, -1, above)
        crossed = torch.where(ncross & above_on, False, crossed)
    return nc, pol, trig


def bilevel_scan_launch() -> dict:
    """How the sweep's float32 instance launches on this card: rows and
    threads a block (a warp a row), blocks per SM, registers and local
    (spill) bytes a thread, and its shared bytes (static; none) at ``m`` =
    8."""
    lib = _lib("bilevel_scan")
    out = (ctypes.c_int * 6)()
    _check_rc(lib, lib.dspeed_bilevel_scan_config(8, out), "bilevel_scan")
    return dict(zip(("rows", "threads", "blocks_per_sm", "registers", "local_bytes",
                     "smem_bytes"), out))


def bilevel_scan(w, pos, neg, gate, start, m):
    """The bi-level trigger's sweep over the rows of ``w`` (``(B, n)``,
    float32 or float64, rows of contiguous samples): ``pos``, ``neg`` the
    thresholds (``(B,)`` in ``w``'s type), ``gate`` and ``start`` the gate
    length and first sample (``(B,)`` int32), ``m`` the slots a row. One
    warp walks one row, 4 rows a block, the slots written straight to
    device memory; see
    :func:`bilevel_scan_plain` for the outputs, which it equals bit for
    bit. CPU tensors run :func:`bilevel_scan_plain`."""
    if w.device.type == "cpu":
        return bilevel_scan_plain(w, pos, neg, gate, start, m)
    if w.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"bilevel_scan: the CUDA kernel takes float rows, got {w.dtype}")
    if w.dim() != 2 or w.stride(1) != 1:
        raise ValueError("bilevel_scan: the CUDA kernel takes rows of contiguous samples")
    B, n = w.shape
    dev = w.device
    pars = [pos.to(dev, w.dtype).contiguous(), neg.to(dev, w.dtype).contiguous(),
            gate.to(dev, torch.int32).contiguous(), start.to(dev, torch.int32).contiguous()]
    if any(p.shape != (B,) for p in pars):
        raise ValueError("bilevel_scan: the parameters take one value a row")
    lib = _lib("bilevel_scan")
    if m > lib.dspeed_bilevel_scan_max_slots(int(w.dtype == torch.float64)):
        raise ValueError(f"bilevel_scan: {m} slots a row are more than the kernel "
                         f"takes")
    nc = torch.empty(B, dtype=torch.int32, device=dev)
    pol = torch.empty((B, m), dtype=w.dtype, device=dev)
    trig = torch.empty((B, m), dtype=w.dtype, device=dev)
    P = _BilevelParams(
        w.data_ptr(), w.stride(0), *(p.data_ptr() for p in pars), nc.data_ptr(),
        pol.data_ptr(), trig.data_ptr(), B, n, int(m), int(w.dtype == torch.float64),
    )
    rc = lib.dspeed_bilevel_scan(ctypes.byref(P), _stream())
    _check_rc(lib, rc, "bilevel_scan")
    LAUNCHES["bilevel_scan"] += 1
    return nc, pol, trig
