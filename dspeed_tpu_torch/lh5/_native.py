"""ctypes bindings for the native VoV codec (``native/vov_codec.cpp``).

Compiles the shared library with g++ on first use (cached next to the
source), and falls back to vectorized numpy when no toolchain is available.
The codec is the host-side hot path feeding variable-length SiPM data to the
device — the runtime-native counterpart of the reference's numba ``_vov2nda``
(reference ``processing_chain.py:2198-2235``).
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess

import numpy as np

log = logging.getLogger("dspeed_tpu_torch.lh5.native")

_LIB = None
_TRIED = False

_SRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
    "vov_codec.cpp",
)
_SO = os.path.join(os.path.dirname(_SRC), "libvov_codec.so")


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.getenv("DSPEED_TORCH_NATIVE", "1") in ("0", "false"):
        return None
    try:
        if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
            subprocess.run(
                ["g++", "-O3", "-march=native", "-shared", "-fPIC",
                 "-o", _SO, _SRC],
                check=True,
                capture_output=True,
            )
        lib = ctypes.CDLL(_SO)
        for fn, restype in (
            ("vov_unpack_f32", ctypes.c_int),
            ("vov_unpack_f64", ctypes.c_int),
            ("vov_pack_f32", ctypes.c_int64),
            ("vov_pack_f64", ctypes.c_int64),
        ):
            getattr(lib, fn).restype = restype
        _LIB = lib
        log.debug("loaded native VoV codec from %s", _SO)
    except (OSError, subprocess.CalledProcessError) as e:
        log.debug("native VoV codec unavailable (%s); using numpy", e)
        _LIB = None
    return _LIB


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def vov_unpack(flat, starts, stops, max_len: int, fill, dtype):
    """(flat, row starts, row stops) -> (padded (n, max_len), lens (n,)).

    Rows longer than ``max_len`` are truncated; the returned ``overflow``
    flag reports whether any row overflowed.
    """
    n = len(starts)
    dtype = np.dtype(dtype)
    lib = _load() if dtype.kind == "f" else None
    if lib is not None and dtype.itemsize in (4, 8):
        flat = np.ascontiguousarray(flat, dtype)
        starts = np.ascontiguousarray(starts, "uint64")
        stops = np.ascontiguousarray(stops, "uint64")
        padded = np.empty((n, max_len), dtype)
        lens = np.empty(n, "uint32")
        fn = lib.vov_unpack_f32 if dtype.itemsize == 4 else lib.vov_unpack_f64
        cfill = (ctypes.c_float if dtype.itemsize == 4 else ctypes.c_double)(
            float(fill)
        )
        bad = fn(
            _ptr(flat), _ptr(starts), _ptr(stops),
            ctypes.c_int64(n), ctypes.c_int64(max_len), cfill,
            _ptr(padded), _ptr(lens),
        )
        return padded, lens.astype("int64"), bool(bad)

    # numpy fallback: gather with a clipped index matrix
    starts = np.asarray(starts, "int64")
    lens = np.asarray(stops, "int64") - starts
    flat = np.asarray(flat)
    padded = np.full((n, max_len), fill, dtype)
    idx = starts[:, None] + np.arange(max_len)[None, :]
    mask = np.arange(max_len)[None, :] < lens[:, None]
    if len(flat):
        np.copyto(
            padded, flat[np.clip(idx, 0, len(flat) - 1)].astype(dtype), where=mask
        )
    return padded, lens, bool((lens > max_len).any())


def vov_pack(padded, lens, base: int, flat_out, cumlen_out) -> int:
    """(padded, lens) -> write into ``flat_out`` starting at ``base`` and
    fill ``cumlen_out``; returns elements written."""
    n, max_len = padded.shape
    lens = np.clip(np.asarray(lens, "int64"), 0, max_len)
    dtype = padded.dtype
    lib = _load() if dtype.kind == "f" else None
    if (
        lib is not None
        and dtype.itemsize in (4, 8)
        and flat_out.dtype == dtype
        and flat_out.flags.c_contiguous
    ):
        padded = np.ascontiguousarray(padded)
        cum = np.empty(n, "uint64")
        fn = lib.vov_pack_f32 if dtype.itemsize == 4 else lib.vov_pack_f64
        wrote = fn(
            _ptr(padded), _ptr(lens), ctypes.c_int64(n),
            ctypes.c_int64(max_len), ctypes.c_int64(base),
            _ptr(flat_out), _ptr(cum),
        )
        cumlen_out[:n] = cum
        return int(wrote)

    # numpy fallback: boolean-mask compaction
    mask = np.arange(max_len)[None, :] < lens[:, None]
    vals = padded[mask]
    flat_out[base : base + len(vals)] = vals.astype(flat_out.dtype, copy=False)
    cumlen_out[:n] = base + np.cumsum(lens)
    return int(len(vals))
