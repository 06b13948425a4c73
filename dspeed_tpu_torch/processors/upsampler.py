"""Upsampling by sample replication (reference
``dspeed/processors/upsampler.py:19``; JAX package
``dspeed_tpu/processors/upsampler.py:27``).

The reference writes the output in a sequential scatter loop. The ratio and
lengths are static, so the write pattern is inverted on the host into a
gather map (output slot -> source sample, the last write winning), and the
device work is one gather. ``interpolating_upsampler`` (reference :57, JAX
package :72) maps each output sample to its source segment on the host in
the same way, and blends on the device; mode ``s`` takes the natural
spline of :mod:`._spline`.
"""

from __future__ import annotations

from math import ceil

import numpy as np
import torch
import torch.nn.functional as F

from ..errors import DSPFatal
from ._helpers import isnan_any, nanmask, static_float, static_int
from ._kernel import kernel
from ._spline import natural_spline_w2

__all__ = ["upsampler", "interpolating_upsampler"]


def _gather_map(n: int, up: float, m: int) -> np.ndarray:
    """``src[j]``: the input sample the reference's scatter leaves in output
    slot ``j``, or -1 where it writes nothing."""
    src = np.full(m, -1, dtype="int64")
    width = int(up)
    half = int(np.floor(up / 2))
    for t_in in range(n):
        t0 = int(t_in * up - half)
        lo = max(t0, 0)
        hi = min(t0 + width, m)
        if lo < hi:
            src[lo:hi] = t_in
    return src


@kernel("(n),(),(m)", ["fff", "ddd"], nout=1, uses_dims=True)
def upsampler(w_in, upsample, dims):
    """Sample replication: each input sample is written to ``int(upsample)``
    output slots starting at ``int(i*upsample - floor(upsample/2))``;
    unwritten slots are NaN, and a row with a NaN is all NaN."""
    up = static_float(upsample, "upsampler", "upsample")
    if not up > 0:
        raise DSPFatal("Upsample must be greater than 0")
    n = w_in.shape[-1]
    m = dims["m"]
    src = _gather_map(n, up, m)
    valid = src >= 0
    # poisoning the input row poisons every output slot copied from it
    w_in = nanmask(isnan_any(w_in, 1), w_in)
    width = int(up)
    if up == width:
        # integer ratio: the map is the staircase src[j] = (j + half) // width
        half = int(np.floor(up / 2))
        rep = torch.repeat_interleave(w_in, width, dim=-1)
        if half + m > n * width:
            rep = F.pad(rep, (0, half + m - n * width))
        out = rep[..., half : half + m]
    else:
        idx = torch.from_numpy(np.where(valid, src, 0)).to(w_in.device)
        out = w_in[..., idx]
    if not valid.all():
        out = torch.where(
            torch.from_numpy(valid).to(w_in.device), out,
            torch.full((), float("nan"), dtype=w_in.dtype, device=w_in.device),
        )
    return out


def _segments(ch: str, n: int, m: int) -> np.ndarray:
    """The source sample (modes ``n f c``) or segment (``l h s``) of each
    output sample, mirroring the reference's per-segment loops, including
    its trailing extrapolation."""
    up = m / n
    seg = np.zeros(m, dtype="int64")
    if ch == "n":
        last = 0
        for i_in in range(n):
            b = min(ceil(up * (i_in + 0.5)), m)
            seg[last:b] = i_in
            last = b
        seg[last:] = n - 1
    elif ch in ("f", "c"):
        last = 0
        for i_in in range(n):
            b = ceil(up * (i_in + 1)) if ch == "f" else int(np.floor(up * i_in)) + 1
            b = min(max(b, 0), m)
            seg[last:b] = i_in
            last = b
        seg[last:] = n - 1
    elif ch == "s":
        # the reference's spline back-substitution (upsampler.py:201-213)
        # walks the segments downward with inclusive bounds: an output
        # sample on a segment boundary takes the segment below, extrapolated
        seg = np.clip(np.floor((np.arange(m) - 1) / up).astype("int64"), 0, n - 2)
    else:
        last = 0
        n_seg = n if ch == "l" else n - 1
        for i_in in range(n_seg):
            b = min(ceil(up * (i_in + 1)), m)
            seg[last:b] = i_in
            last = b
        seg[last:] = n_seg - 1
    return seg


@kernel("(n),(),(m)", ["fbf", "dbd"], nout=1, static=[1], uses_dims=True)
def interpolating_upsampler(w_in, mode_in, dims):
    """Interpolated upsampling, modes i/n/f/c/l/h/s (reference
    ``upsampler.py:57``). The ratio is ``m/n``; a row with a NaN is all
    NaN."""
    mode = static_int(mode_in, "interpolating_upsampler", "mode_in")
    ch = chr(mode)
    if ch not in "infclhs":
        raise DSPFatal("Unrecognized interpolation mode")
    n = w_in.shape[-1]
    m = dims["m"]
    up = m / n
    dev, dtype = w_in.device, w_in.dtype
    bad = isnan_any(w_in, 1)

    def idx(a):
        return torch.from_numpy(np.asarray(a, "int64")).to(dev)

    if ch == "i":
        if up != int(up):
            raise DSPFatal(
                "interpolating_upsampler requires len(w_out) to be an integer "
                "multiple of len(w_in) for mode 'i'"
            )
        src = np.zeros(m, dtype="int64")
        is_orig = np.zeros(m, dtype=bool)
        src[:: int(up)][:n] = np.arange(n)
        is_orig[:: int(up)][:n] = True
        out = torch.where(torch.from_numpy(is_orig).to(dev), w_in[..., idx(src)],
                          torch.zeros((), dtype=dtype, device=dev))
        return nanmask(bad, out)
    seg = _segments(ch, n, m)
    if ch in "nfc":
        return nanmask(bad, w_in[..., idx(seg)])

    t0 = torch.from_numpy(np.arange(m) / up - seg).to(dev, dtype)
    t1 = 1.0 - t0
    w_i = w_in[..., idx(seg)]
    w_i1 = w_in[..., idx(np.minimum(seg + 1, n - 1))]
    if ch == "l":
        out = w_i + t0 * (w_i1 - w_i)
    elif ch == "h":
        first = torch.from_numpy(seg == 0).to(dev)
        last_seg = torch.from_numpy(seg == n - 2).to(dev)
        m0 = torch.where(first, (w_in[..., 1] - w_in[..., 0])[..., None],
                         (w_i1 - w_in[..., idx(np.maximum(seg - 1, 0))]) / 2.0)
        m1 = torch.where(last_seg, (w_in[..., -1] - w_in[..., -2])[..., None],
                         (w_in[..., idx(np.minimum(seg + 2, n - 1))] - w_i) / 2.0)
        out = (
            (-2.0 * t1**3 + 3.0 * t1**2) * w_i
            + (-2.0 * t0**3 + 3.0 * t0**2) * w_i1
            - (t1**3 - t1**2) * m0
            + (t0**3 - t0**2) * m1
        )
    else:  # 's'
        w2 = natural_spline_w2(w_in)
        out = (
            t1 * w_i
            + t0 * w_i1
            + ((t1**3 - t1) * w2[..., idx(seg)]
               + (t0**3 - t0) * w2[..., idx(np.minimum(seg + 1, n - 1))]) / 6.0
        )
    return nanmask(bad, out.to(dtype))


# not tile-safe, as in the JAX package (upsampler.py:185): groups split
# around the upsamplers
