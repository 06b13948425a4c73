"""Sample-axis (sequence-parallel) convolution with halo exchange.

The port of ``dspeed_tpu/parallel/conv.py``. When a waveform's sample axis
is split over the ranks of a mesh axis, a 'same'-mode convolution needs
``m - 1`` samples of each neighbour's block: each rank swaps them with both
neighbours in one ``batch_isend_irecv`` (point-to-point, NVLink between
cards), convolves its extended block and keeps the centre (overlap-save).
The global edges see zeros, not wrap-around. The local convolution takes
the port's own route (``processors/convolutions.py``: shifted adds, the
banded kernel K4 for float32 rows on the card, or the FFT).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .mesh import axis_rank, axis_size, gather_samples

__all__ = ["sp_convolve_same", "sp_convolve_same_traced"]


def _halo_exchange(w: torch.Tensor, halo: int, mesh, axis: str):
    """``(from_left, from_right)``: the last ``halo`` samples of the
    previous rank's block and the first ``halo`` of the next rank's, zeros
    at the global edges."""
    shape = (*w.shape[:-1], halo)
    left = torch.zeros(shape, dtype=w.dtype, device=w.device)
    right = torch.zeros(shape, dtype=w.dtype, device=w.device)
    nsh = axis_size(mesh, axis)
    s = axis_rank(mesh, axis)
    if halo == 0 or nsh == 1:
        return left, right
    group = mesh.get_group(axis)
    ops = []
    if s > 0:
        peer = dist.get_global_rank(group, s - 1)
        ops += [dist.P2POp(dist.isend, w[..., :halo].contiguous(), peer, group),
                dist.P2POp(dist.irecv, left, peer, group)]
    if s < nsh - 1:
        peer = dist.get_global_rank(group, s + 1)
        ops += [dist.P2POp(dist.isend, w[..., -halo:].contiguous(), peer, group),
                dist.P2POp(dist.irecv, right, peer, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return left, right


def sp_convolve_same_traced(w, taps, mesh, axis: str = "sp", batch_axes: tuple = ()):
    """The core of :func:`sp_convolve_same` on this rank's block of samples
    ``w (..., n / shards)`` (a chain's sample-sharded plane): returns this
    rank's block of the 'same' convolution. ``batch_axes`` names the mesh
    axes the rows are already split over (the chain's); the rows are this
    rank's either way. Raises ``ValueError`` where the JAX package does."""
    from ..processors.convolutions import _convolve_window

    taps = np.asarray(taps)
    local = w.shape[-1]
    m = int(taps.shape[-1])
    halo = m - 1
    if halo > local:
        raise ValueError("kernel halo larger than one shard")
    left, right = _halo_exchange(w, halo, mesh, axis)
    ext = torch.cat([left, w, right], dim=-1)
    # full(ext)[k] is the global full convolution at s*local - halo + k
    # wherever the window lies in ext; 'same' output t of this block is
    # global full index s*local + t + (m-1)//2, i.e. k = t + (m-1)//2 + halo
    start = (m - 1) // 2 + halo
    out, _ = _convolve_window(ext, taps.astype(_np_dtype(w)), start, local)
    return out.to(w.dtype)


def _np_dtype(w: torch.Tensor):
    return np.float64 if w.dtype == torch.float64 else np.float32


def sp_convolve_same(w, taps, mesh, axis: str = "sp"):
    """'same'-mode convolution of ``w (..., n)`` with ``taps (m,)``, the
    sample axis split over mesh axis ``axis``: equivalent to
    ``numpy.convolve(row, taps, "same")`` per event. Every rank passes the
    whole ``w`` (a tensor, or an array put on the mesh's device type),
    convolves its block of samples and gets the whole result back."""
    dev = torch.device(mesh.device_type)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    w = torch.as_tensor(w).to(dev)
    n = w.shape[-1]
    nsh = axis_size(mesh, axis)
    if n % nsh:
        raise ValueError(f"sample axis {n} must divide into {nsh} shards")
    local = n // nsh
    s = axis_rank(mesh, axis)
    blk = w[..., s * local:(s + 1) * local].contiguous()
    out = sp_convolve_same_traced(blk, taps, mesh, axis)
    return gather_samples(out, mesh, axis)
