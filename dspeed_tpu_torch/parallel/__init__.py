"""Mesh and sharding utilities for runs over several cards (the port of
``dspeed_tpu/parallel``): one process per card under ``torch.distributed``,
a ``DeviceMesh`` with named axes, stacked multi-channel production and the
sample-axis halo-exchange convolution. Beyond the reference's names it
exports ``initialize_distributed`` and the stacked chunk step that
``build_dsp_stacked`` runs (``stacked_chain``, ``stacked_dispatch``,
``stacked_results``, ``write_channels``), which takes tables in memory."""

from .bulk import (
    build_dsp_stacked,
    stacked_chain,
    stacked_dispatch,
    stacked_results,
    write_channels,
)
from .conv import sp_convolve_same, sp_convolve_same_traced
from .mesh import initialize_distributed, make_mesh, shard_chain

__all__ = [
    "build_dsp_stacked",
    "initialize_distributed",
    "make_mesh",
    "shard_chain",
    "sp_convolve_same",
    "sp_convolve_same_traced",
    "stacked_chain",
    "stacked_dispatch",
    "stacked_results",
    "write_channels",
]
