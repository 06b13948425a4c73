"""Upsampling by sample replication (reference
``dspeed/processors/upsampler.py:19``; JAX package
``dspeed_tpu/processors/upsampler.py:27``).

The reference writes the output in a sequential scatter loop. The ratio and
lengths are static, so the write pattern is inverted on the host into a
gather map (output slot -> source sample, the last write winning), and the
device work is one gather. ``interpolating_upsampler`` needs the natural
spline of ``_spline.py`` and is queued in ROADMAP (item 8).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..errors import DSPFatal
from ._helpers import isnan_any, nanmask, static_float
from ._kernel import kernel

__all__ = ["upsampler"]


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
