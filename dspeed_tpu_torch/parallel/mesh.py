"""Mesh construction and the collectives a sharded chain runs.

The port of ``dspeed_tpu/parallel/mesh.py``. The JAX package lays one
program over a ``jax.sharding.Mesh`` and lets GSPMD place the data; here
each card runs its own process (``torch.distributed``: NCCL between cards,
gloo on the CPU), and a
:class:`~torch.distributed.device_mesh.DeviceMesh` names the axes:
``"data"`` (events), ``"channel"`` (stacked channel tables) and ``"sp"``
(the sample axis, for the halo-exchange convolution of :mod:`.conv`).

A sharded chunk (``ProcessingChain.set_sharding``) is cut here: each rank
takes its contiguous block of the batch dims (:func:`batch_block`), runs the
chain on it, and the outputs are gathered back (:func:`gather_rows`, one
collective per output dtype plane and batch axis), so every rank sees the
whole chunk. Samples are gathered by :func:`gather_samples` where a step
needs a whole row.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from .. import config

__all__ = ["initialize_distributed", "make_mesh", "shard_chain"]


def initialize_distributed(device=None, **kwargs) -> None:
    """Join this process to its group: ``init_process_group`` with NCCL
    when ``device`` is CUDA (the default), gloo on the CPU; on the card the
    process takes the card ``LOCAL_RANK`` names (``torchrun`` sets it; 0
    without). ``kwargs`` go to ``init_process_group`` (``init_method``,
    ``rank``, ``world_size``, ``store``, ``timeout``); under ``torchrun`` none
    are needed. Call once per process before :func:`make_mesh`."""
    dev = config.resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    kwargs.setdefault("backend", "nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(**kwargs)


def make_mesh(shape: dict[str, int] | None = None, device=None):
    """A :class:`~torch.distributed.device_mesh.DeviceMesh` with named
    axes over the processes of the group (one card each).

    ``shape`` maps axis names to sizes, e.g. ``{"channel": 2, "data": 4}``;
    their product must be the world size. By default every process goes on
    a 1-D ``("data",)`` mesh. ``device`` is the device type of the mesh
    (CUDA by default, ``"cpu"`` for gloo)."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = config.resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh: torch.distributed is not initialized; call "
            "initialize_distributed() first"
        )
    world = dist.get_world_size()
    if shape is None:
        shape = {"data": world}
    sizes = tuple(int(s) for s in shape.values())
    if int(np.prod(sizes)) != world:
        raise ValueError(f"mesh {dict(shape)} needs {int(np.prod(sizes))} "
                         f"processes; the group has {world}")
    return init_device_mesh(dev.type, sizes, mesh_dim_names=tuple(shape))


def shard_chain(chain, mesh, batch_axes=("data",)):
    """Shard a :class:`~dspeed_tpu_torch.processing_chain.ProcessingChain`
    over ``mesh`` (events over ``"data"``, stacked channels over
    ``"channel"``)."""
    chain.set_sharding(mesh, batch_axes=batch_axes)
    return chain


# -- the pieces a sharded chain runs -------------------------------------------


def axis_size(mesh, name: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(name))


def axis_rank(mesh, name: str) -> int:
    """This process's coordinate along mesh axis ``name``."""
    return mesh.get_local_rank(name)


def _all_gather(t: torch.Tensor, group, size: int) -> torch.Tensor:
    """``(size, *t.shape)``: ``t`` of every member of ``group`` in the
    order of their coordinates along the axis."""
    if size == 1:
        return t.unsqueeze(0)
    parts = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.stack(parts)


def batch_block(mesh, batch_axes, lead: tuple) -> tuple[slice, ...]:
    """This rank's contiguous block of the batch dims ``lead`` (each
    divisible by its axis's size)."""
    out = []
    for name, d in zip(batch_axes, lead):
        p = axis_size(mesh, name)
        if d % p:
            raise ValueError(f"batch dim of {d} rows does not divide over "
                             f"mesh axis {name!r} of size {p}")
        loc = d // p
        c = axis_rank(mesh, name)
        out.append(slice(c * loc, (c + 1) * loc))
    return tuple(out)


def gather_rows(t: torch.Tensor, mesh, batch_axes, local_lead: tuple) -> torch.Tensor:
    """Gather a plane of this rank's rows ``(prod(local_lead), cols)`` over
    the batch axes into the chunk's ``(prod(lead), cols)``, rows in the
    row-major order of the global batch dims: one ``all_gather`` per batch
    axis of size > 1 (the last axis first)."""
    cols = t.shape[1:]
    cur = list(local_lead)  # current extents of the batch dims
    x = t.reshape(*cur, *cols)
    nb = len(local_lead)
    for i in range(nb - 1, -1, -1):
        name = batch_axes[i]
        p = axis_size(mesh, name)
        if p == 1:
            continue
        g = _all_gather(x, mesh.get_group(name), p)  # (p, *cur, *cols)
        # move the gathered axis in front of batch dim i and merge the two
        g = g.movedim(0, i)
        cur[i] *= p
        x = g.reshape(*cur, *cols)
    return x.reshape(-1, *cols)


def gather_samples(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """A sample-sharded plane ``(..., local)`` gathered along ``axis`` into
    the whole rows ``(..., local * shards)``."""
    p = axis_size(mesh, axis)
    if p == 1:
        return t
    g = _all_gather(t, mesh.get_group(axis), p)  # (p, ..., local)
    return g.movedim(0, -2).reshape(*t.shape[:-1], p * t.shape[-1])


def any_across(mask: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``mask`` OR-ed over the ranks of ``axis`` (a row's NaN flag from
    every block of its samples)."""
    if axis_size(mesh, axis) == 1:
        return mask
    m = mask.to(torch.int32)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=mesh.get_group(axis))
    return m.bool()
