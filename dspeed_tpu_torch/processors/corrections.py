"""Waveform corrections and alignment (reference
``dspeed/processors/inl_correction.py:20``, ``wf_correction.py:18``,
``wf_alignment.py:20``, ``get_wf_centroid.py:20``; JAX package
``dspeed_tpu/processors/corrections.py``).

Gathers and masked arithmetic. ``wf_correction`` and ``get_wf_centroid``
are tile safe and run as K7 ops (``wf_correction``, ``wf_centroid``) inside a
generic group on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from ..errors import DSPFatal
from ._helpers import any_bad, as_tensor, isnan_any, nanmask, static_int
from ._kernel import kernel

__all__ = [
    "inl_correction",
    "wf_correction",
    "wf_alignment",
    "get_wf_centroid",
]


def _tensor(x, dev):
    """``x`` as a tensor on ``dev``: a python number in float64 (the JAX
    package's weak type under x64), a tensor or numpy value in its own."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    return torch.as_tensor(np.asarray(x, np.float64 if isinstance(x, (int, float))
                                      else None), device=dev)


@kernel("(n),(p)->(n)", ["if->f", "id->d"])
def inl_correction(w_in, inl):
    """Add the per-ADC-code INL correction, ``w + inl[w]``, from a table
    shared by every event (``(p,)``) or one a event (``(..., p)``). A code
    outside the table poisons its event (the reference raises per sample);
    a NaN in an event's table poisons that event, a NaN in a shared table
    every event."""
    inl = as_tensor(inl, w_in)
    p = inl.shape[-1]
    code = w_in.to(torch.int32)
    ok = ((code >= 0) & (code < p)).all(-1)
    idx = code.clamp(0, p - 1).long()
    if inl.ndim == 1:
        corr = inl[idx]
    else:
        lead = torch.broadcast_shapes(inl.shape[:-1], idx.shape[:-1])
        corr = torch.gather(inl.expand(*lead, p), -1, idx.expand(*lead, idx.shape[-1]))
    out = (w_in + corr).to(corr.dtype)
    return nanmask(any_bad(~ok, isnan_any(inl, 1)), out)


def correction_window(n, m, start_idx, stop_idx) -> tuple[int, int]:
    """``[start, stop)`` of :func:`wf_correction`, static, checked as the
    reference checks it (``DSPFatal``)."""
    start = static_int(start_idx, "wf_correction", "start_idx")
    stop = static_int(stop_idx, "wf_correction", "stop_idx")
    if start < 0:
        raise DSPFatal("start_idx must be positive")
    if start > n:
        raise DSPFatal("start_idx must be shorter than input waveform size")
    if stop < 0:
        raise DSPFatal("stop_idx must be positive")
    if stop > n:
        raise DSPFatal("stop_idx must be shorter than input waveform size")
    if start >= stop:
        raise DSPFatal("start_idx must be smaller than stop_idx")
    if stop - start > m:
        raise DSPFatal("stop_idx - start_idx must be smaller than len(w_corr)")
    return start, stop


@kernel("(n),(m),(),()->(n)", ["ffii->f", "ddii->d"])
def wf_correction(w_in, w_corr, start_idx, stop_idx):
    """Subtract a correction array over ``[start, stop)`` (reference
    ``wf_correction.py:18``): ``w[i] - w_corr[i - start]`` there, ``w``
    elsewhere."""
    n = w_in.shape[-1]
    corr = as_tensor(w_corr, w_in, w_in.dtype)
    m = corr.shape[-1]
    start, stop = correction_window(n, m, start_idx, stop_idx)
    out = w_in.clone() if corr.ndim == 1 else w_in.expand(
        torch.broadcast_shapes(w_in.shape, corr.shape[:-1] + (n,))).clone()
    out[..., start:stop] = out[..., start:stop] - corr[..., : stop - start]
    return nanmask(any_bad(isnan_any(w_in, 1), isnan_any(corr, 1)), out)


@kernel("(n),(),(),(),(m)", ["fffff", "ddddd"], nout=1, uses_dims=True)
def wf_alignment(w_in, centroid, shift, size, dims):
    """Center the waveform at ``centroid`` in a window of ``size`` samples
    (reference ``wf_alignment.py:20``), with ``half = size / 2.0``: where
    ``half <= centroid < n - half`` the samples from ``trunc(centroid -
    half)``; where ``half - shift < centroid < half`` the samples from
    ``-trunc((size + 1) / 2 - centroid)``, the row's first sample before
    the row starts; else the first ``size`` samples."""
    n = w_in.shape[-1]
    m = dims["m"]
    size_s = static_int(size, "wf_alignment", "size")
    if size_s <= 0:
        raise DSPFatal("size must be positive")
    if size_s > n:
        raise DSPFatal("size must be shorter than input waveform size")
    dev = w_in.device
    c = _tensor(centroid, dev)
    c = (c if c.is_floating_point() else c.to(torch.float64)).expand(w_in.shape[:-1])
    sh = _tensor(shift, dev)
    half = size_s / 2.0
    ar = torch.arange(m, device=dev)
    cz = torch.nan_to_num(c)
    idx1 = torch.trunc(cz - half).to(torch.int64)[..., None] + ar
    case1 = (c >= half) & (c < n - half)
    ss = torch.trunc((size_s + 1) / 2.0 - cz).to(torch.int64)
    idx2 = ar - ss[..., None]
    case2 = (c > half - sh) & (c < half)
    idx = torch.where(case1[..., None], idx1, torch.where(case2[..., None], idx2, ar))
    gather = torch.gather(w_in.expand(*idx.shape[:-1], n), -1, idx.clamp(0, n - 1))
    out = torch.where(case2[..., None] & (idx < 0), w_in[..., :1], gather)
    bad = any_bad(isnan_any(w_in, 1), isnan_any(c), isnan_any(sh))
    return nanmask(bad, out.to(w_in.dtype))


@kernel("(n),()->()", ["ff->f", "dd->d"])
def get_wf_centroid(w_in, shift):
    """The centroid of a step-convolution product (reference
    ``get_wf_centroid.py:20``): between the row's minimum and maximum (first
    occurrences), the midpoint of the first positive and the last negative
    sample, plus ``shift``, rounded half to even. NaN where either is
    missing."""
    n = w_in.shape[-1]
    dev = w_in.device
    sh = _tensor(shift, dev)
    imin = torch.argmin(w_in, dim=-1)
    imax = torch.argmax(w_in, dim=-1)
    pos = torch.arange(n, device=dev)
    in_win = (pos >= imin[..., None]) & (pos < imax[..., None])
    rel = pos - imin[..., None]
    big = n + 1
    first_pos = torch.where(in_win & (w_in > 0), rel, big).amin(-1)
    last_neg = torch.where(in_win & (w_in < 0), rel, -1).amax(-1)
    found = (first_pos < big) & (last_neg >= 0)
    shf = sh if sh.is_floating_point() else sh.to(torch.float64)
    centroid = torch.round(((first_pos + imin + shf) + (last_neg + imin + shf)) / 2.0)
    bad = any_bad(isnan_any(w_in, 1), isnan_any(sh), ~found)
    return nanmask(bad, centroid.to(w_in.dtype))


def _float_isnan(x):
    return torch.isnan(x) if x.is_floating_point() else torch.zeros(
        x.shape, dtype=torch.bool, device=x.device)


def _code(skip, code, w_in):
    code = torch.where(skip, 0, code) if isinstance(skip, torch.Tensor) else (
        torch.zeros_like(code) if skip else code)
    return code.to(torch.int32).expand(
        torch.broadcast_shapes(code.shape, w_in.shape[:-1]))


def _centroid_checker(w_in, shift):
    """The checked-mode flag of the reference's shift fatals
    (``get_wf_centroid.py:54-60``; a NaN waveform gives NaN first): 1 =
    shift NaN, 2 = shift negative, 3 = shift past the row (JAX package
    ``corrections.py:146``)."""
    n = w_in.shape[-1]
    sh = _tensor(shift, w_in.device)
    code = torch.where(_float_isnan(sh), 1, torch.where(
        sh < 0, 2, torch.where(sh > n - 1, 3, 0)))
    return _code(isnan_any(w_in, 1), code, w_in)


get_wf_centroid.checker = _centroid_checker
get_wf_centroid.check_messages = {
    1: "shift is nan",
    2: "shift must be positive",
    3: "shift must be shorter than input waveform size",
}


def _alignment_checker(w_in, centroid, shift, size):
    """The checked-mode flag of the reference's centroid and shift fatals
    (``wf_alignment.py:63-71``; a NaN waveform gives NaN first; the size
    checks are static and raise when the chain is built): 1 = centroid NaN,
    2 = shift NaN, 3 = shift negative, 4 = shift past the row (JAX package
    ``corrections.py:171``)."""
    n = w_in.shape[-1]
    c = _tensor(centroid, w_in.device)
    sh = _tensor(shift, w_in.device)
    code = torch.where(_float_isnan(c), 1, torch.where(
        _float_isnan(sh), 2, torch.where(sh < 0, 3, torch.where(sh > n, 4, 0))))
    return _code(isnan_any(w_in, 1), code, w_in)


wf_alignment.checker = _alignment_checker
wf_alignment.check_messages = {
    1: "centroid is nan",
    2: "shift is nan",
    3: "shift must be positive",
    4: "shift must be shorter than input waveform size",
}

# generic row-tile fusion (the JAX package's flags)
get_wf_centroid.tile_safe = True
wf_correction.tile_safe = True
