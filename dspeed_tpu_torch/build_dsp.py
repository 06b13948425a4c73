"""Bulk-production driver: raw-tier LH5 in, dsp-tier LH5 out.

The port of ``dspeed_tpu/build_dsp.py::build_dsp`` (:238), which mirrors the
reference driver (``dspeed/build_dsp.py:27-452``): filename / Table /
LH5Iterator inputs, wildcard table discovery with nested ``raw`` groups,
per-channel ``chan_config`` matching (first ``fnmatch`` wins), per-channel
database slices, "friend" aux-input tables, block writes with
``write_start``, write modes ``None``/``'r'``/``'a'``/``'u'``, and an
in-memory ``Struct`` return when ``dsp_out`` is ``None``.

Each chunk of ``buffer_len`` events is read, copied to the device, run
through the chain and written back in one synchronous loop. Not ported yet
(ROADMAP queue 1, item 6): the process-wide chain cache, read-ahead and
write-behind threads, multi-host partitioning and ``buffer_len="auto"``.
"""

from __future__ import annotations

import logging
import os
import re
import time
from copy import deepcopy
from fnmatch import fnmatch
from typing import Collection, Mapping  # noqa: UP035

from . import lh5
from .errors import DSPFatal, ProcessingChainError
from .lh5 import LGDO, LH5Iterator, LH5Store, Struct, Table
from .processing_chain import build_processing_chain

log = logging.getLogger("dspeed_tpu_torch")

__all__ = ["build_dsp"]

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
    buffer_len: int = 3200,
    block_width: int = 16,
    chan_config: str | Mapping[str, str] = None,
    device=None,
    fuse: bool | str = True,
):
    """Run a DSP recipe over raw waveform data; see the reference docstring
    (``build_dsp.py:27-126``) for parameter semantics, which are preserved.

    ``buffer_len`` is the number of events per chunk, i.e. per device pass.
    ``device``: where the chains run (default CUDA; ``"cpu"`` on request).
    ``fuse``: the fusion pass of each chain: ``True`` (the hand patterns,
    then the generic pass), ``"generic"`` (the generic pass only, one K7
    launch per group) or ``False``
    (:func:`~dspeed_tpu_torch.processing_chain.build_processing_chain`).
    """
    if not isinstance(buffer_len, int):
        raise ValueError(
            f"buffer_len must be an int, got {buffer_len!r} (automatic "
            "sizing is ROADMAP queue 1, item 6)"
        )
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
        proc_chain, field_mask, tb_out = build_processing_chain(
            processors,
            tb_in,
            db_dict=db_dict,
            outputs=_outputs,
            block_width=block_width,
            device=device,
            fuse=fuse,
        )
        if isinstance(lh5_it, LH5Iterator):
            lh5_it.reset_field_mask(field_mask)

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

        for tb_chunk in lh5_it:
            i_entry = getattr(lh5_it, "current_i_entry", 0)
            n = len(tb_chunk)
            try:
                proc_chain(tb_chunk, tb_out)
            except DSPFatal as e:
                if e.wf_range is not None:  # checked mode: exact entry
                    e.wf_range = (i_entry + e.wf_range[0], i_entry + e.wf_range[1])
                else:
                    e.wf_range = (i_entry, i_entry + n)
                raise e
            out_view = tb_out[0:n] if n != len(tb_out) else tb_out
            if isinstance(dsp_st, LH5Store):
                dsp_st.write(
                    obj=out_view,
                    name=dsp_name,
                    lh5_file=dsp_out,
                    wo_mode="o" if write_mode == "u" else "a",
                    write_start=i_start + i_entry,
                    n_rows=n,
                )
            else:
                tb_fill.append(out_view)

        log.info("Table %s processed in %.2f seconds", tb, time.time() - start)

    # in lgdo, Table subclasses Struct; here they are distinct types
    if isinstance(dsp_st, (Struct, Table)):
        return dsp_st
    dsp_st.close()
