"""Mesh and sharding utilities for runs over several cards (the port of
``dspeed_tpu/parallel``): one process per card under ``torch.distributed``,
a ``DeviceMesh`` with named axes, stacked multi-channel production and the
sample-axis halo-exchange convolution."""

from .bulk import build_dsp_stacked
from .conv import sp_convolve_same, sp_convolve_same_traced
from .mesh import make_mesh, shard_chain

__all__ = [
    "build_dsp_stacked",
    "make_mesh",
    "shard_chain",
    "sp_convolve_same",
    "sp_convolve_same_traced",
]
