"""The port's hand-written CUDA kernels, their plain PyTorch versions, and
their launch counts.

Each kernel replaces one Pallas TPU kernel of the JAX package
(``dspeed_tpu/processors/_pallas.py``):

- :func:`fused_energy` (``csrc/fused_energy.cu``) — K1, the fused energy
  front (``_fused_energy_kernel`` :287, entry ``fused_energy`` :1451);
- :func:`banded_conv_multi` (``csrc/banded_conv.cu``) — K4, the banded
  convolution bank (``_banded_conv_kernel`` :999, entry :1063).

A wrapper given a CPU tensor computes the kernel's plain version
(:func:`fused_energy_plain`, :func:`banded_conv_plain`); given a CUDA tensor
it launches the kernel or raises — it never falls back. Every launch adds one
to ``LAUNCHES[<kernel>]``.

The sources are compiled with ``nvcc`` for ``sm_90a`` into shared libraries
with a plain C interface under ``dspeed_tpu_torch/_build/`` on first use (or
all at once by :func:`build_all`), and bound with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

import numpy as np
import torch

from ..errors import DSPFatal

__all__ = [
    "LAUNCHES",
    "reset_launches",
    "build_all",
    "fused_energy",
    "fused_energy_plain",
    "banded_conv_multi",
    "banded_conv_plain",
]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(_PKG, "_build")
SOURCES = {"fused_energy": "fused_energy.cu", "banded_conv": "banded_conv.cu"}

LAUNCHES = {"fused_energy": 0, "banded_conv_multi": 0}

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
    up-to-date library is there; returns ``(path, compiler output)``."""
    src = os.path.join(_CSRC, SOURCES[name])
    so = os.path.join(_BUILD, f"libdspeed_{name}.so")
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src):
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
    else:
        lib.dspeed_banded_conv.restype = ctypes.c_int
        lib.dspeed_banded_conv.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        )
        lib.dspeed_banded_conv_smem_bytes.restype = ctypes.c_int
        lib.dspeed_banded_conv_smem_bytes.argtypes = [ctypes.c_int] * 3
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


def _require_cuda_f32(x: torch.Tensor, what: str) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"{what}: the CUDA kernel takes float32, got {x.dtype}")
    if not x.is_contiguous():
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
    _require_cuda_f32(w, "banded_conv_multi")
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
    rc = lib.dspeed_banded_conv(
        w.data_ptr(), taps.data_ptr(), out.data_ptr(), B, n_full, n, m, nk,
        lo, p, _stream(),
    )
    _check_rc(lib, rc, "banded_conv_multi")
    LAUNCHES["banded_conv_multi"] += 1
    return [out[:, j, :].reshape(*lead, p) for j in range(nk)]
