"""Stacked multi-channel bulk production.

The port of ``dspeed_tpu/parallel/bulk.py``. The reference processes one
channel table at a time and leaves cross-channel parallelism to external
batch systems. Here chunks of ``C`` channel tables that share the DSP
configuration, the waveform geometry and the database are *stacked* into
``(C, B, ...)`` arrays and run as one dispatch per chunk: the chain sees
``C * B`` rows, so each kernel launches once per stacked chunk
(BASELINE.md's multi-channel bulk-production configuration). With a mesh
(axes ``("channel", "data")``) each rank runs its block of the stack and
the outputs are gathered back (``ProcessingChain.set_sharding``).

The chunk step (:func:`stacked_dispatch`, :func:`stacked_results`,
:func:`write_channels`) takes tables in memory, so it can be driven without
LH5 files.
"""

from __future__ import annotations

import copy
import logging
from concurrent.futures import ThreadPoolExecutor
from typing import Collection, Mapping

import torch

from .. import lh5

log = logging.getLogger("dspeed_tpu_torch.parallel")

__all__ = [
    "build_dsp_stacked",
    "stacked_chain",
    "stacked_dispatch",
    "stacked_results",
    "write_channels",
]


def _bdsp():
    """The ``build_dsp`` module (the package attribute is the function)."""
    import sys

    import dspeed_tpu_torch

    return sys.modules[dspeed_tpu_torch.__getattr__("build_dsp").__module__]


def _stacked_cache_key(dsp_config, database, outputs, tb_in0, device, fuse, mesh):
    """Key into ``build_dsp``'s chain cache, so repeated stacked calls (same
    configuration, database, schema) reuse the built chain. The database is
    keyed by the port's rule (``build_dsp._chain_cache_key``: an array by
    its dtype, shape and a hash of its bytes; the JAX package's
    ``_stacked_cache_key`` takes its ``str()``, which elides the middle of a
    large array), the mesh by its layout."""
    key = _bdsp()._chain_cache_key(dsp_config, database, outputs, tb_in0,
                                     device, fuse, mesh)
    return None if key is None else ("stacked", *key)


def stacked_chain(dsp_config, tb_in0, database=None, outputs=None, device=None,
                  fuse=True, mesh=None):
    """The chain of a stack whose channels' chunks look like ``tb_in0``:
    from ``build_dsp``'s cache where it holds one, else built and cached;
    sharded over ``mesh`` (``("channel", "data")``), or not. Returns
    ``(chain, field_mask, tb_out)``."""
    from ..processing_chain import build_processing_chain

    bdsp = _bdsp()
    dsp_config = bdsp._load_mapping(dsp_config)
    device = bdsp.config.resolve_device(device)
    key = _stacked_cache_key(dsp_config, database, outputs, tb_in0, device,
                             fuse, mesh)
    cached = bdsp._CHAIN_CACHE.get(key) if key is not None else None
    if cached is not None:
        bdsp._CHAIN_CACHE[key] = bdsp._CHAIN_CACHE.pop(key)  # most recent
        log.debug("reusing the built chain for stacked production")
    else:
        cached = build_processing_chain(dsp_config, tb_in0, db_dict=database,
                                        outputs=outputs, device=device, fuse=fuse)
        if key is not None:
            bdsp._CHAIN_CACHE[key] = cached
            while len(bdsp._CHAIN_CACHE) > bdsp._CHAIN_CACHE_MAX:
                bdsp._CHAIN_CACHE.pop(next(iter(bdsp._CHAIN_CACHE)))
    chain = cached[0]
    chain.set_sharding(mesh, batch_axes=("channel", "data"))
    return cached


def stacked_dispatch(chain, tables, n: int):
    """Stack the first ``n`` events of each channel's chunk (``tables``,
    read through the chain's input managers) and dispatch the stack once.
    Returns ``(pending, n)``: ``n`` clipped to the shortest input."""
    channels = []
    for tb in tables:
        for varname in list(chain._input_managers):
            chain.link_input_buffer(varname, tb[varname])
        inputs, n_av = chain._gather_inputs(0, n)
        n = min(n, n_av)
        channels.append(inputs)
    return chain.dispatch(chain.stage_stacked(channels, n)), n


def stacked_results(chain, pending) -> list[dict]:
    """Fetch a stacked chunk and split it per channel: one result dict per
    channel, each output ``(n, ...)`` (values without the event axis, such
    as constants, shared)."""
    out = chain.fetch(pending)
    batched = {k for _, items in pending[1] for k, _ in items}
    n_chan = pending[3][0]
    return [{k: v[ci] if k in batched else v for k, v in out.items()}
            for ci in range(n_chan)]


def write_channels(chain, results: list[dict], tb_outs: list, n: int) -> None:
    """Write each channel's results through the chain's output managers
    into that channel's output table."""
    for res, tb_out in zip(results, tb_outs):
        for varname, man in chain._output_managers.items():
            man.set_buffer(tb_out[varname])
            man.write(res, 0, n)


def build_dsp_stacked(
    raw_in: str,
    dsp_out: str | None,
    dsp_config,
    lh5_tables: Collection[str],
    mesh=None,
    database: Mapping | None = None,
    outputs: Collection[str] | None = None,
    write_mode: str | None = None,
    buffer_len: int = 3200,
    distribute: bool = True,
    device=None,
    fuse: bool | str = True,
):
    """Process ``lh5_tables`` (same configuration and geometry) as stacked
    channels, one dispatch per chunk of ``C x buffer_len`` events.

    With ``mesh`` (axes ``("channel", "data")``) every rank of it takes the
    whole stack and runs its block of each chunk; without, one card runs it
    all. Writes ``<table>/dsp`` groups like
    :func:`~dspeed_tpu_torch.build_dsp` (under a mesh of several ranks,
    rank 0 writes), or returns a ``Struct`` when ``dsp_out`` is None.
    Without a mesh, under ``torch.distributed`` with more than one rank
    (``distribute``), each rank takes channels ``[rank::world]`` and writes
    its own ``.p<rank>`` file (``build_dsp.per_host_out_path``); a rank with
    no channel returns an empty ``Struct``, or None. ``device`` and ``fuse``
    are :func:`~dspeed_tpu_torch.build_dsp`'s (default CUDA).
    """
    from ..lh5 import LH5Iterator, LH5Store

    bdsp = _bdsp()
    lh5_tables = list(lh5_tables)
    ranked = (torch.distributed.is_available()
              and torch.distributed.is_initialized())
    if distribute and mesh is None and ranked and (
        torch.distributed.get_world_size() > 1
    ):
        pc = torch.distributed.get_world_size()
        pi = torch.distributed.get_rank()
        lh5_tables = lh5_tables[pi::pc]
        log.info("rank %d/%d: stacking %d channels", pi, pc, len(lh5_tables))
        if not lh5_tables:
            log.info("rank %d/%d: no channels assigned", pi, pc)
            return lh5.Struct() if dsp_out is None else None
        if isinstance(dsp_out, str):
            dsp_out = bdsp.per_host_out_path(dsp_out, pi)
    writes = not (mesh is not None and ranked and torch.distributed.get_rank() != 0)
    iterators = [LH5Iterator(raw_in, tb, buffer_len=buffer_len) for tb in lh5_tables]
    n_rows = min(len(it) for it in iterators)
    if any(len(it) != n_rows for it in iterators):
        log.warning("channel tables differ in length; clipping to %d", n_rows)

    tb_in0 = iterators[0].read(0)
    chain, field_mask, tb_out = stacked_chain(
        dsp_config, tb_in0, database=database, outputs=outputs, device=device,
        fuse=fuse, mesh=mesh)
    for it in iterators:
        it.reset_field_mask(field_mask)

    store = LH5Store(keep_open=True) if dsp_out and writes else None
    results_struct = lh5.Struct() if dsp_out is None else None
    # per-channel output tables share the chain's schema; the chain's output
    # managers rebind to each channel's buffers per write
    tb_outs = [copy.deepcopy(tb_out) for _ in lh5_tables]

    def _write_chunk(pending, i, n):
        """Fetch chunk ``(i, n)`` and write every channel, on the writer
        thread, so the device -> host copy and the writes overlap the next
        chunk's read and dispatch. Only this thread touches the output
        managers, ``tb_outs`` and the store."""
        write_channels(chain, stacked_results(chain, pending), tb_outs, n)
        for ci, tb in enumerate(lh5_tables):
            view = tb_outs[ci][0:n] if n != len(tb_outs[ci]) else tb_outs[ci]
            dsp_name = tb.replace("raw", "dsp")
            if store is not None:
                store.write(obj=view, name=dsp_name, lh5_file=dsp_out,
                            wo_mode="o" if write_mode == "u" else "a",
                            write_start=i, n_rows=n)
            elif results_struct is not None:
                *groups, name = [g for g in dsp_name.split("/") if g]
                node = results_struct
                for g in groups:
                    node = node.setdefault(g, lh5.Struct())
                if name not in node:
                    empty = copy.deepcopy(tb_outs[ci])
                    empty.resize(0)
                    node[name] = empty
                node[name].append(view)

    i = 0
    writer = ThreadPoolExecutor(1, thread_name_prefix="dsp-stacked-writer")
    prev_job = None
    try:
        while i < n_rows:
            n = min(buffer_len, n_rows - i)
            tables = [it.read(i, n) for it in iterators]
            pending, n = stacked_dispatch(chain, tables, n)
            if prev_job is not None:
                prev_job.result()  # at most two chunks in flight
            prev_job = writer.submit(_write_chunk, pending, i, n)
            i += n
        if prev_job is not None:
            prev_job.result()
    finally:
        writer.shutdown(wait=True)
        for it in iterators:
            it.close()
        if store is not None:
            store.close()
    if dsp_out is not None:
        return None
    return results_struct
