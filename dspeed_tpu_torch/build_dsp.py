"""Bulk-production driver: raw-tier LH5 in, dsp-tier LH5 out.

The port of ``dspeed_tpu/build_dsp.py::build_dsp`` (:238), which mirrors the
reference driver (``dspeed/build_dsp.py:27-452``): filename / Table /
LH5Iterator inputs, wildcard table discovery with nested ``raw`` groups,
per-channel ``chan_config`` matching (first ``fnmatch`` wins), per-channel
database slices, "friend" aux-input tables, block writes with
``write_start``, write modes ``None``/``'r'``/``'a'``/``'u'``, and an
in-memory ``Struct`` return when ``dsp_out`` is ``None``.

Production as in the JAX package: a process-wide cache of built chains
(keyed also by device and fusion mode), one chunk of read-ahead whose
host -> device copy is staged on a worker thread and a copy stream, each
chunk's fetch and write on a writer thread while the next one computes
(:func:`_process_chunks`), a timing split (``stats=``), multi-process
partitioning over ``torch.distributed`` (:func:`host_partition`) and
``buffer_len="auto"``.
"""

from __future__ import annotations

import contextlib
import logging
import os
import re
import time
from concurrent.futures import ThreadPoolExecutor
from copy import deepcopy
from fnmatch import fnmatch
from typing import Collection, Mapping, MutableMapping  # noqa: UP035

import numpy as np
import torch

from . import config, lh5
from .errors import DSPFatal, ProcessingChainError
from .lh5 import LGDO, LH5Iterator, LH5Store, Struct, Table
from .processing_chain import build_processing_chain

log = logging.getLogger("dspeed_tpu_torch")

__all__ = ["build_dsp", "host_partition", "per_host_out_path"]


def per_host_out_path(dsp_out: str, pi: int) -> str:
    """Per-process output file name: substitute a ``{process}``
    placeholder, or insert a ``.p<idx>`` suffix before the extension."""
    if "{process}" in dsp_out:
        return dsp_out.format(process=pi)
    root, ext = os.path.splitext(dsp_out)
    return f"{root}.p{pi}{ext}"


def host_partition(
    lh5_tables, i_start, n_entries, entry_list, entry_mask,
    total_rows_fn, pc: int, pi: int,
):
    """Partition bulk-production work across ``pc`` processes for process
    ``pi``.

    Multiple channel tables go round-robin (the reference leaves this
    fan-out to an external scheduler, one process per channel); a single
    table splits its entry range contiguously. ``total_rows_fn(tb)`` is
    called only when the range must be derived from the file. Returns
    ``(lh5_tables, i_start, n_entries, entry_list, entry_mask)``.
    """
    if pc <= 1:
        return lh5_tables, i_start, n_entries, entry_list, entry_mask
    if len(lh5_tables) > 1:
        mine = list(lh5_tables)[pi::pc]
        log.info(
            "process %d/%d: processing %d of %d tables", pi, pc, len(mine),
            len(lh5_tables),
        )
        return mine, i_start, n_entries, entry_list, entry_mask
    if entry_mask is not None:
        entry_list = np.flatnonzero(np.asarray(entry_mask))
        entry_mask = None
    if entry_list is not None:
        chunk = np.array_split(np.asarray(entry_list), pc)[pi]
        return lh5_tables, i_start, n_entries, chunk, None
    total = n_entries
    if total is None:
        total = max(0, int(total_rows_fn(lh5_tables[0])) - i_start)
    base, rem = divmod(total, pc)
    my_n = base + (1 if pi < rem else 0)
    my_start = i_start + pi * base + min(pi, rem)
    log.info(
        "process %d/%d: entries [%d, %d) of %d", pi, pc, my_start,
        my_start + my_n, total,
    )
    return lh5_tables, my_start, my_n, entry_list, entry_mask


# process-wide chain cache: repeated build_dsp calls with the same (config,
# db, outputs, input schema, chunk length, device, fusion mode) reuse the
# built chain (its device constants, K7 tapes and pinned buffers) instead of
# building it again per call (DSPEED_TPU_CHAIN_CACHE=0 disables it).
# LRU-bounded: insertion order doubles as recency
_CHAIN_CACHE: dict = {}
_CHAIN_CACHE_MAX = int(os.getenv("DSPEED_TPU_CHAIN_CACHE_MAX", "16"))


def _schema_fingerprint(tb) -> tuple:
    import json as _json

    fp = []
    for name, col in tb.items():
        entry = (name, type(col).__name__)
        if isinstance(col, Table):
            entry += (_schema_fingerprint(col),)
        elif hasattr(col, "nda"):
            entry += (str(col.dtype), col.nda.shape[1:],
                      _json.dumps(col.attrs, sort_keys=True, default=str))
        elif hasattr(col, "flattened_data"):
            entry += (str(col.dtype),)
        fp.append(entry)
    return tuple(fp)


def _mesh_key(mesh):
    """A mesh by its layout: axis names, the ranks on it and device type."""
    if mesh is None:
        return None
    return (tuple(mesh.mesh_dim_names or ()), tuple(mesh.mesh.flatten().tolist()),
            tuple(mesh.mesh.shape), mesh.device_type)


def _chain_cache_key(processors, db_dict, outputs, tb_in, device, fuse,
                     mesh=None):
    """The cache key of a chain, or None where the cache is off. Beside the
    JAX package's key (configuration, database, outputs, input schema and
    chunk length: a chain's output buffers are sized for it) it holds the
    resolved device and the fusion mode, which the JAX package reads from
    its environment, and the mesh the chain is sharded over (None for
    ``build_dsp``'s own chains): a chain built for one must not serve
    another. Checked mode is not in the key: a cached chain is toggled."""
    import hashlib
    import json as _json

    if os.getenv("DSPEED_TPU_CHAIN_CACHE", "1") in ("0", "false"):
        return None

    def value(v):
        # an array by its type, shape and bytes: its str() elides the middle
        # of a large array, so two databases whose weights differ there
        # would share a chain
        if isinstance(v, np.ndarray):
            return [v.dtype.str, list(v.shape),
                    hashlib.sha1(np.ascontiguousarray(v).tobytes()).hexdigest()]
        return str(v)

    try:
        return (
            _json.dumps(processors, sort_keys=True, default=value),
            _json.dumps(db_dict, sort_keys=True, default=value),
            tuple(outputs) if outputs is not None else None,
            _schema_fingerprint(tb_in),
            len(tb_in),
            str(device),
            fuse,
            _mesh_key(mesh),
        )
    except TypeError:
        return None


def _prefetched(iterable, chain=None):
    """Iterate with one chunk of read-ahead on a worker thread, overlapping
    host reads with the device's work.

    With ``chain``, the worker also gathers and starts the host -> device
    copy of each chunk (:meth:`ProcessingChain.stage_inputs`, on the
    device's copy stream), so chunk ``i+1``'s transfer overlaps chunk
    ``i``'s steps, fetch and write. Yields ``(tb, staged, i_entry)``.
    """
    it = iter(iterable)
    sentinel = object()

    def fetch():
        tb = next(it, sentinel)
        if tb is sentinel:
            return tb
        # the chunk's entry offset, taken on the worker: by the time the
        # consumer sees this chunk, read-ahead has moved the iterator's
        # current_i_entry on to the next one
        i_entry = getattr(iterable, "current_i_entry", 0)
        staged = chain.stage_inputs(tb) if chain is not None else None
        return (tb, staged, i_entry)

    with ThreadPoolExecutor(1, thread_name_prefix="dsp-read-ahead") as ex:
        fut = ex.submit(fetch)
        try:
            while True:
                item = fut.result()
                if item is sentinel:
                    return
                fut = ex.submit(fetch)
                yield item
        finally:
            # the consumer stopped early (a checked chunk's DSPFatal): let
            # the chunk read ahead finish staging and its copy end, so no
            # worker still links the chain's inputs, and no copy is in
            # flight, when the chain runs again
            try:
                item = fut.result()
            except Exception:  # noqa: BLE001 - already propagating
                item = None
            if isinstance(item, tuple) and item[1] is not None:
                event = item[1][1]
                if event is not None:
                    event.synchronize()


def _process_chunks(proc_chain, chunks, write, read_ahead: bool = True) -> dict:
    """The production loop of one table: run every chunk of ``chunks`` (an
    iterable of ``Table`` chunks; ``current_i_entry``, where it has one, is
    each chunk's first entry) through ``proc_chain`` into its linked output
    buffers, and call ``write(n, i_entry)`` for each chunk once its ``n``
    rows are there.

    Chunk ``i+1`` is dispatched to the device first; then chunk ``i``'s
    writer job (the device -> host fetch, the output managers and
    ``write``, on one FIFO writer thread) is joined, and chunk ``i+1``'s
    submitted. So the device computes chunk ``i+1`` while chunk ``i``
    drains, and the join before each submit keeps the output buffers
    single-buffered. With ``read_ahead`` each chunk is also read and staged
    one ahead on a worker thread (:func:`_prefetched`). Returns the seconds
    spent waiting for input (``loading_s``), dispatching and fetching
    (``processing_s``) and writing (``write_s``).
    """
    loading_time = processing_time = write_time = 0.0
    curr = time.time()
    chunk_iter = (
        _prefetched(chunks, chain=proc_chain)
        if read_ahead
        else ((tb, None, getattr(chunks, "current_i_entry", 0)) for tb in chunks)
    )

    def _drain(pending, n, i_entry):
        t0 = time.time()
        proc_chain.finish_chunk(pending, n)
        t1 = time.time()
        write(n, i_entry)
        return time.time() - t0, time.time() - t1

    def _join(in_flight):
        nonlocal processing_time, write_time
        fut, wf_range = in_flight
        try:
            drain_s, write_s = fut.result()
        except DSPFatal as e:
            if e.wf_range is not None:
                e.wf_range = (wf_range[0] + e.wf_range[0], wf_range[0] + e.wf_range[1])
            else:
                e.wf_range = wf_range
            raise e
        processing_time += drain_s - write_s
        write_time += write_s

    writer = ThreadPoolExecutor(1, thread_name_prefix="dsp-writer")
    in_flight = None  # (future, wf_range)
    pending = None
    try:
        for tb_in, staged, i_entry in chunk_iter:
            loading_time += time.time() - curr
            t_proc = time.time()
            try:
                pending, n = proc_chain.dispatch_chunk(tb_in, staged=staged)
            except DSPFatal as e:
                if e.wf_range is not None:
                    e.wf_range = (i_entry + e.wf_range[0], i_entry + e.wf_range[1])
                else:
                    e.wf_range = (i_entry, i_entry + len(tb_in))
                raise e
            processing_time += time.time() - t_proc
            if in_flight is not None:
                _join(in_flight)
                in_flight = None
            if pending is not None:
                in_flight = (
                    writer.submit(_drain, pending, n, i_entry),
                    (i_entry, i_entry + n),
                )
                pending = None
            curr = time.time()
        if in_flight is not None:
            _join(in_flight)
    finally:
        writer.shutdown(wait=True)
        if pending is not None and pending[2] is not None:
            pending[2].synchronize()  # dispatched, never joined: let it end
        if hasattr(chunk_iter, "close"):
            chunk_iter.close()
    return {"loading_s": loading_time, "processing_s": processing_time,
            "write_s": write_time}


_DB_PARSER = re.compile(r"(?![^\w_.])db\.[\w_.]+")


def _load_mapping(obj):
    if isinstance(obj, str):
        with open(os.path.expandvars(os.path.expanduser(obj))) as f:
            text = f.read()
        try:
            import json

            return json.loads(text)
        except ValueError:
            import yaml

            return yaml.safe_load(text)
    return obj


def _db_lookup(token: str, db_dict, what: str):
    try:
        node = db_dict
        for key in token.split(".")[1:]:
            node = node[key]
        log.debug("database lookup: found %s for %s", node, token)
        return node
    except (KeyError, TypeError):
        raise ProcessingChainError(f"did not find {token} in database ({what}).")


def _auto_buffer_len(
    device=None, candidates=(1024, 2048, 4096, 8192), default: int = 3200,
    rates: dict | None = None,
) -> int:
    """Probe the host -> device path at each candidate chunk size and return
    the one with the most events a second (the reference pins 3200,
    ``build_dsp.py:40``). On the CPU the reference default is kept: the
    probe measures a transfer the CPU does not make. On the card each
    candidate is a pinned copy of ``(n, 4096)`` int16 samples and a
    float32 row sum, fetched back; a CUDA error propagates. ``rates``, if
    given, receives events a second by candidate."""
    dev = config.resolve_device(device)
    if dev.type != "cuda":
        return default
    rng = np.random.default_rng(7)
    best_n, best_rate = default, 0.0
    with torch.cuda.device(dev):
        for n in candidates:
            payload = torch.from_numpy(
                rng.integers(0, 16000, (n, 4096), dtype=np.int16)
            ).pin_memory()

            def trivial():
                w = payload.to(dev, non_blocking=True)
                return w.to(torch.float32).sum(dim=1).cpu()

            trivial()  # warm the shape
            best = min(_wall(trivial) for _ in range(3))
            rate = n / best
            if rates is not None:
                rates[n] = rate
            if rate > best_rate:
                best_n, best_rate = n, rate
    log.debug("auto buffer_len picked %d", best_n)
    return best_n


def _wall(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def build_dsp(
    raw_in: str | LGDO,
    dsp_out: str | None = None,
    dsp_config: str | Mapping = None,
    lh5_tables: Collection[str] | str = None,
    base_group: str = None,
    database: str | Mapping = None,
    outputs: Collection[str] = None,
    write_mode: str = None,
    entry_list: Collection[int] = None,
    entry_mask: Collection[bool] = None,
    i_start: int = 0,
    n_entries: int | None = None,
    buffer_len: int | str = 3200,
    block_width: int = 16,
    chan_config: str | Mapping[str, str] = None,
    distribute: bool = True,
    stats: MutableMapping | None = None,
    device=None,
    fuse: bool | str = True,
    checked: bool = False,
):
    """Run a DSP recipe over raw waveform data; see the reference docstring
    (``build_dsp.py:27-126``) for parameter semantics, which are preserved.

    ``buffer_len`` is the number of events per chunk, i.e. per device pass;
    ``"auto"`` probes the host -> device path once and takes the fastest
    candidate (:func:`_auto_buffer_len`; 3200 on the CPU).

    ``stats``: an optional mutable mapping filled with the run's timing
    split, summed over all processed tables: ``loading_s`` (waiting for
    input read-ahead, the chain build included), ``processing_s``
    (dispatch, device work and the device -> host fetch), ``write_s``
    (output managers and writes, on the writer thread), ``total_s`` and
    ``rows``. Compute, fetch and write overlap across chunks, so the parts
    can sum past ``total_s``.

    ``distribute`` (default on): where ``torch.distributed`` is initialized
    with more than one process, each process takes its own share of the
    work (channel tables round-robin, or a contiguous entry range of a
    single table) and writes its own output file (``dsp_out`` gains a
    ``.p<rank>`` suffix, or substitute a ``{process}`` placeholder).

    ``device``: where the chains run (default CUDA; ``"cpu"`` on request).
    ``fuse``: the fusion pass of each chain: ``True`` (the hand patterns,
    then the generic pass), ``"generic"`` (the generic pass only, one K7
    launch per group) or ``False``
    (:func:`~dspeed_tpu_torch.processing_chain.build_processing_chain`).

    ``checked``: data-dependent ``DSPFatal`` parity with the reference (the
    JAX package's ``checked``, :256). Kernels whose reference bodies raise
    per event on bad data (``get`` index out of range, non-integral or
    out-of-range search starts, non-integral pick-off indices, filters that
    overflow into NaN) emit per-event flag columns, copied to the host with
    the outputs; after each chunk the flags are scanned and production
    halts with the reference's message, the processor string and the exact
    entry in ``wf_range``. Off by default: those events then become NaN.
    Fusion groups run member by member while checked (no K7 launch); a
    cached chain is toggled, not rebuilt.

    ``DSPEED_TPU_PROFILE=<dir>`` writes a ``torch.profiler`` trace (CPU,
    and CUDA on the card) of each table's chunk loop into ``<dir>``.
    """
    device = config.resolve_device(device)
    if buffer_len == "auto":
        buffer_len = _auto_buffer_len(device)
    if not isinstance(buffer_len, int):
        raise ValueError(f"buffer_len must be an int or 'auto', got {buffer_len!r}")
    if isinstance(lh5_tables, str):
        lh5_tables = [lh5_tables]

    if isinstance(raw_in, (Table, LH5Iterator)):
        base_group = base_group or ""
        lh5_tables = lh5_tables if lh5_tables is not None else [""]
        if len(lh5_tables) > 1:
            raise RuntimeError(
                "in-memory Table/LH5Iterator input allows a single lh5_tables "
                f"entry, got {len(lh5_tables)}"
            )
    elif isinstance(raw_in, str):
        if base_group is None:
            base_group = "raw" if lh5.ls(raw_in, "raw") else ""
        prefix = f"{base_group}/" if base_group else ""
        if lh5_tables is None:
            lh5_tables = lh5.ls(raw_in, f"{prefix}*")
        else:
            lh5_tables = [
                tab for tab_wc in lh5_tables for tab in lh5.ls(raw_in, f"{prefix}{tab_wc}")
            ]

        # a discovered channel group may hold a single nested 'raw' table
        # (e.g. ch024/raw): descend into it; drop names that resolve to
        # nothing in the file
        def _resolve_tb(name: str) -> str | None:
            if lh5.ls(raw_in, f"{name}/*") == [f"{name}/raw"]:
                return f"{name}/raw"
            return name if lh5.ls(raw_in, name) else None

        lh5_tables = [t for t in map(_resolve_tb, lh5_tables) if t]
        if len(lh5_tables) == 0:
            raise RuntimeError(f"could not find any valid LH5 table in {raw_in}")
    else:
        raise RuntimeError(
            f"unsupported raw_in type {type(raw_in).__name__!r}: expected a "
            "file name, Table, or LH5Iterator"
        )

    # multi-process partitioning: each process its own share and file
    pc, pi = 1, 0
    if distribute and torch.distributed.is_available() and (
        torch.distributed.is_initialized()
    ):
        pc, pi = torch.distributed.get_world_size(), torch.distributed.get_rank()
    write_base = 0
    if pc > 1:
        def _total_rows(tb):
            if isinstance(raw_in, str):
                return lh5.read_n_rows(tb or "raw", raw_in)
            return len(raw_in)

        orig_i_start = i_start
        lh5_tables, i_start, n_entries, entry_list, entry_mask = host_partition(
            lh5_tables, i_start, n_entries, entry_list, entry_mask,
            _total_rows, pc, pi,
        )
        # each process writes its own file: positions are local to its entry
        # range, not global (a new .p<idx> file written at the global offset
        # would carry a zero-filled prefix)
        write_base = i_start - orig_i_start
        if isinstance(dsp_out, str):
            dsp_out = per_host_out_path(dsp_out, pi)

    dsp_config = _load_mapping(dsp_config)
    chan_config = _load_mapping(chan_config) or {}
    chan_config = {
        chan: _load_mapping(cfg)
        for chan, cfg in chan_config.items()
    }
    database = _load_mapping(database)
    if database and not isinstance(database, Mapping):
        raise ValueError("input database is not a valid JSON or YAML file or dict")

    if dsp_out is None:
        dsp_st = Struct()
    else:
        if os.path.isfile(dsp_out):
            if write_mode is None:
                raise FileExistsError(
                    f"refusing to touch existing output {dsp_out}; pass "
                    "write_mode='r'/'a'/'u'"
                )
            if write_mode == "r":
                os.remove(dsp_out)
        dsp_st = LH5Store(keep_open=True)

    for tb in lh5_tables:
        # per-channel config selection: first matching chan_config wildcard
        # wins, else the shared dsp_config
        this_config = next(
            (cfg for pat, cfg in chan_config.items() if fnmatch(tb, pat)),
            dsp_config,
        )
        if this_config is None:
            log.info("no config for table %s; skipping", tb)
            continue

        # per-channel database slice (reference :247-253)
        db_dict = database
        if tb not in ("", "raw"):
            chan_name = next(k for k in tb.split("/") if k not in ("", "raw"))
            db_dict = (database or {}).get(chan_name)
            if db_dict is not None:
                log.info("Found database for %s", chan_name)

        # entry selection shared by the main iterator and every friend
        sel_kw = dict(
            entry_list=entry_list, entry_mask=entry_mask,
            i_start=i_start, n_entries=n_entries, buffer_len=buffer_len,
        )
        if isinstance(raw_in, str):
            lh5_in = LH5Iterator(raw_in, tb, **sel_kw)
        else:
            lh5_in = raw_in

        # "friend" aux inputs (reference :271-330)
        config_inputs = this_config.get("inputs", [])
        if isinstance(config_inputs, Mapping):
            config_inputs = [config_inputs]
        for ci in config_inputs:
            file, group = ci["file"], ci["group"]
            prefix_, suffix_ = ci.get("prefix", ""), ci.get("suffix", "")
            if _DB_PARSER.fullmatch(file):
                file = _db_lookup(file, db_dict, "friend file")
            if _DB_PARSER.fullmatch(group):
                group = _db_lookup(group, db_dict, "friend group")
            if isinstance(lh5_in, LH5Iterator):
                lh5_in.add_friend(
                    LH5Iterator(file, group, **sel_kw),
                    prefix=prefix_, suffix=suffix_,
                )
            else:
                lh5_in.join(
                    lh5.read(group, file, n_rows=len(lh5_in)),
                    prefix=prefix_,
                    suffix=suffix_,
                )

        processors = this_config["processors"]
        _outputs = this_config["outputs"] if outputs is None else outputs

        tot_n_rows = len(lh5_in)
        if n_entries is not None:
            tot_n_rows = min(n_entries, tot_n_rows)

        if isinstance(lh5_in, LH5Iterator):
            lh5_it = lh5_in
            lh5_it.n_entries = tot_n_rows
            tb_in = lh5_in.read(0)
        else:
            tb_in = lh5_in[i_start : i_start + tot_n_rows]
            lh5_it = [tb_in]

        log.info("Processing table %s with %d rows", tb, tot_n_rows)
        start = time.time()
        cache_key = _chain_cache_key(processors, db_dict, _outputs, tb_in,
                                     device, fuse)
        cached = _CHAIN_CACHE.get(cache_key) if cache_key is not None else None
        if cached is not None:
            proc_chain, field_mask, tb_out = cached
            _CHAIN_CACHE[cache_key] = _CHAIN_CACHE.pop(cache_key)  # most recent
            if proc_chain._checked != checked:  # the key holds no mode
                proc_chain.set_checked(checked)
            log.debug("reusing the built chain for table %s", tb)
        else:
            proc_chain, field_mask, tb_out = build_processing_chain(
                processors,
                tb_in,
                db_dict=db_dict,
                outputs=_outputs,
                block_width=block_width,
                device=device,
                fuse=fuse,
            )
            if checked:
                proc_chain.set_checked(True)
            if cache_key is not None:
                _CHAIN_CACHE[cache_key] = (proc_chain, field_mask, tb_out)
                while len(_CHAIN_CACHE) > _CHAIN_CACHE_MAX:
                    _CHAIN_CACHE.pop(next(iter(_CHAIN_CACHE)))
        if isinstance(lh5_it, LH5Iterator):
            lh5_it.reset_field_mask(field_mask)
        build_time = time.time() - start

        dsp_name = tb.replace("raw", "dsp")
        tb_fill = None
        if isinstance(dsp_st, Struct):
            tb_fill = deepcopy(tb_out)
            tb_fill.resize(0)
            if dsp_name == "":
                dsp_st = tb_fill
            else:
                *groups, tb_name = dsp_name.split("/")
                node = dsp_st
                for gr in groups:
                    node = node.setdefault(gr, Struct())
                node[tb_name] = tb_fill

        def write(n, i_entry):
            out_view = tb_out[0:n] if n != len(tb_out) else tb_out
            if isinstance(dsp_st, LH5Store):
                dsp_st.write(
                    obj=out_view,
                    name=dsp_name,
                    lh5_file=dsp_out,
                    wo_mode="o" if write_mode == "u" else "a",
                    write_start=i_start - write_base + i_entry,
                    n_rows=n,
                )
            else:
                tb_fill.append(out_view)

        profile_dir = os.getenv("DSPEED_TPU_PROFILE")
        profiler = contextlib.nullcontext()
        if profile_dir:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            profiler = torch.profiler.profile(activities=acts)
        with profiler:
            times = _process_chunks(proc_chain, lh5_it, write,
                                    read_ahead=isinstance(lh5_it, LH5Iterator))
        if profile_dir:
            os.makedirs(profile_dir, exist_ok=True)
            name = re.sub(r"\W+", "_", tb) or "table"
            trace = os.path.join(
                profile_dir,
                f"build_dsp_{name}_{os.getpid()}_{time.time_ns()}.pt.trace.json",
            )
            profiler.export_chrome_trace(trace)
            log.info("torch.profiler trace written to %s", trace)

        total_time = time.time() - start
        times["loading_s"] += build_time
        log.info("Table %s processed in %.2f seconds", tb, total_time)
        log.debug("Table %s loading time: %.2f seconds", tb, times["loading_s"])
        log.debug("Table %s write time: %.2f seconds", tb, times["write_s"])
        log.debug("Table %s processing time: %.2f seconds", tb,
                  times["processing_s"])
        if stats is not None:
            for k, v in times.items():
                stats[k] = stats.get(k, 0.0) + v
            stats["total_s"] = stats.get("total_s", 0.0) + total_time
            stats["rows"] = stats.get("rows", 0) + tot_n_rows
        if log.isEnabledFor(logging.DEBUG):
            log.debug("Processor timing info (execute_profiled only): ")
            for proc, t in sorted(proc_chain.get_timing().items(),
                                  key=lambda kv: kv[1], reverse=True):
                log.debug("%s: %.3f s", proc, t)

    # in lgdo, Table subclasses Struct; here they are distinct types
    if isinstance(dsp_st, (Struct, Table)):
        return dsp_st
    dsp_st.close()
