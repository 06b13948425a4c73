#!/usr/bin/env python3
"""Where one ``build_dsp`` chunk of the PyTorch port spends its time on the
card.

    python3 tools/profile_torch_chain.py
        [--config flagship|flagship-l128|flagship-generic|timing|energy]
        [--events 16384] [--repeats 3] [--chunks 4] [--trace PATH]

Runs one of the configurations ``chip_smoke.py`` drives — the flagship
configuration (``configs/hpge-energy-timing.yaml``, all 34 outputs; the
default), the same with its A/E window at 128 upsampled samples
(``flagship-l128``: the current front on K6), the same in the generic fusion
mode (``flagship-generic``: ``fuse="generic"``, two K7 groups), the timing
configuration (without its three A/E columns, 31 outputs) or the energy
configuration (its 17 energy and baseline outputs) — through ``dspeed_tpu_torch.build_dsp`` Table ->
Table on 16384 synthetic 4096-sample events, and prints:

1. the first call in the process and the warm calls after it, each with
   whether it built its chain or took it from the chain cache;
2. the host-clock split of one warm chunk, a chain-cache hit and then a
   miss (the cache emptied first): chain build, input gather, the host ->
   device copy, the step loop (and each step), the device -> host copy,
   and the rest of ``build_dsp``; every phase ends in
   ``torch.cuda.synchronize()``;
3. a ``torch.profiler`` table of device time by kernel over one more warm
   chunk, and the device's busy share of that chunk's wall time (busy =
   the union of the device's kernel and copy intervals);
4. the production loop (``build_dsp``'s ``_process_chunks``, as
   ``chip_smoke.run_pipeline`` drives it) over ``--chunks`` chunks of
   distinct events: its wall and wf/s; the host time of each thread (the
   read-ahead worker's staging, the main thread's dispatch, the writer's
   fetch and write), unsynced, which overlap one another and are not parts
   of the wall; and, in a profiled pass, the device's busy share of the
   wall and of each chunk;
5. the staging copy alone: one chunk's waveform plane into a pinned
   buffer (``torch.Tensor.copy_``, as ``ProcessingChain._stage`` makes it)
   on the main thread, on a worker thread, and on a worker while the main
   thread dispatches a chunk; and the plane's copy straight from pageable
   memory to the card (``.to("cuda")``), for comparison;
6. the host operations that take the most time in the process's first
   ``build_dsp`` call (profiled, so slower than unprofiled).

With ``--trace PATH`` the profiler's Chrome trace is written there. Needs
CUDA; imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import threading
import time
from collections import defaultdict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _timed(fn, totals, key):
    import torch

    def wrap(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        totals[key] += time.perf_counter() - t0
        return out

    return wrap


def _busy_ms(events) -> float:
    """Union of the device intervals (kernels and copies) in ms."""
    spans = sorted(
        (e.time_range.start, e.time_range.end)
        for e in events
        if e.device_type.name == "CUDA" and e.time_range.end > e.time_range.start
    )
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e3


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="flagship",
                    choices=("flagship", "flagship-l128", "flagship-generic",
                             "timing", "energy"))
    ap.add_argument("--events", type=int, default=16384)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--chunks", type=int, default=4,
                    help="chunks of --events through the production loop")
    ap.add_argument("--trace", help="write the Chrome trace to this path")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_chain: no CUDA device", file=sys.stderr)
        return 2

    from chip_smoke import (
        TAU, card_line, config, counted_builds, distinct_chunks, energy_config,
        l128_config, make_hpge_waveforms, run_pipeline, timing_config,
    )
    from dspeed_tpu_torch import build_dsp, lh5
    from dspeed_tpu_torch import processing_chain as pc
    from dspeed_tpu_torch.processors import _cuda

    bd_mod = importlib.import_module("dspeed_tpu_torch.build_dsp")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    _cuda.build_all()
    wf, _amp, _t0, bl, _rt = make_hpge_waveforms(args.events)
    tb = lh5.Table({
        "waveform": lh5.WaveformTable(
            values=wf, t0=0.0, t0_units="ns", dt=16.0, dt_units="ns"
        ),
        "baseline": lh5.Array(bl.astype(np.float32)),
    })
    cfg = {"flagship": config, "flagship-l128": l128_config,
           "flagship-generic": config, "timing": timing_config,
           "energy": energy_config}[args.config]()
    fuse = "generic" if args.config == "flagship-generic" else True
    kw = dict(dsp_config=cfg, database={"pz": {"tau": TAU}},
              buffer_len=args.events, device="cuda", fuse=fuse)

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        build_dsp(tb, **kw)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def run_counted():
        with counted_builds(build_dsp) as builds:
            wall = run()
        return wall, "miss" if builds.n else "hit"

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as first:
        cold, cold_cache = run_counted()
    walls = [run_counted() for _ in range(args.repeats)]
    print(f"build_dsp Table -> Table, {args.config} configuration "
          f"({len(cfg['outputs'])} columns), {args.events} events: cold "
          f"{cold * 1e3:.3f} ms (chain cache {cold_cache}), warm "
          f"{[round(w * 1e3, 3) for w, _ in walls]} ms (chain cache "
          f"{[c for _, c in walls]}) on {card}", flush=True)

    # 1. host-clock split of one warm chunk: a chain-cache hit, then a miss
    # (the cache emptied first; not the process's first call)
    chain_cls = pc.ProcessingChain
    patches = {
        (bd_mod, "build_processing_chain"): "chain build",
        (chain_cls, "_gather_inputs"): "input gather",
        (chain_cls, "_stage"): "host -> device",
        (chain_cls, "_run_steps"): "step loop",
        (chain_cls, "_start_fetch"): "device -> host",
        (chain_cls, "fetch"): "device -> host",
    }
    step_classes = {type(s) for s in _steps_of(cfg, tb, kw)}

    def synced_split(label):
        totals: dict = defaultdict(float)
        saved = {k: getattr(*k) for k in patches}
        steps: dict = defaultdict(float)
        step_run = {}
        for cls in step_classes:
            step_run[cls] = cls.run

            def timed_run(self, env, _orig=cls.run):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _orig(self, env)
                torch.cuda.synchronize()
                steps[str(self).split("(")[0][:40]] += time.perf_counter() - t0

            cls.run = timed_run
        try:
            for (obj, name), key in patches.items():
                setattr(obj, name, _timed(saved[(obj, name)], totals, key))
            wall = run()
        finally:
            for (obj, name), fn in saved.items():
                setattr(obj, name, fn)
            for cls, fn in step_run.items():
                cls.run = fn
        split = {k: round(v * 1e3, 3) for k, v in totals.items()}
        split["rest of build_dsp"] = round((wall - sum(totals.values())) * 1e3, 3)
        print(f"host-clock split of one chunk, chain cache {label} "
              f"({wall * 1e3:.3f} ms with a sync after every phase): "
              f"{json.dumps(split)}", flush=True)
        print(f"step loop by step, chain cache {label} (ms, sync after each): "
              + json.dumps({k: round(v * 1e3, 3) for k, v in steps.items()}),
              flush=True)

    synced_split("hit")
    bd_mod._CHAIN_CACHE.clear()
    synced_split("miss")

    # 2. device time by kernel over one more warm chunk
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = run()
    busy = _busy_ms(prof.events())
    if busy == 0.0:
        raise RuntimeError("the profiler recorded no device activity")
    print(f"profiled chunk: wall {wall * 1e3:.3f} ms, device busy {busy:.3f} ms "
          f"({100 * busy / (wall * 1e3):.1f}% busy, "
          f"{100 - 100 * busy / (wall * 1e3):.1f}% idle)", flush=True)
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=15))

    # 4. the production loop over chunks of distinct events
    tables = distinct_chunks(lh5, wf, bl, args.chunks)
    total = args.events * args.chunks
    chain, _, tb_out = pc.build_processing_chain(
        cfg, tables[0], db_dict=kw["database"], device="cuda", fuse=fuse
    )
    run_pipeline(build_dsp, chain, tb_out, tables[:1])  # warm the chain
    threads: dict = defaultdict(float)
    loop_patches = {
        (chain_cls, "stage_inputs"): "staging",
        (chain_cls, "dispatch"): "dispatch",
        (chain_cls, "finish_chunk"): "fetch + output managers",
    }
    saved = {k: getattr(*k) for k in loop_patches}

    def on_thread(fn, key):
        def wrap(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            name = threading.current_thread().name.split("_")[0]
            threads[f"{key} [{name}]"] += time.perf_counter() - t0
            return out

        return wrap

    try:
        for (obj, name), key in loop_patches.items():
            setattr(obj, name, on_thread(saved[(obj, name)], key))
        torch.cuda.synchronize()
        _, split, wall = run_pipeline(build_dsp, chain, tb_out, tables)
        torch.cuda.synchronize()
    finally:
        for (obj, name), fn in saved.items():
            setattr(obj, name, fn)
    print(f"production loop, {args.chunks} chunks x {args.events} events: wall "
          f"{wall * 1e3:.3f} ms ({total / wall:.0f} wf/s, {wall * 1e3 / args.chunks:.3f} "
          f"ms a chunk); _process_chunks split (s) {json.dumps(split)}", flush=True)
    print("host time by thread, unsynced, overlapped (ms; not parts of the wall): "
          + json.dumps({k: round(v * 1e3, 3) for k, v in sorted(threads.items())}),
          flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as lprof:
        torch.cuda.synchronize()
        _, _, lwall = run_pipeline(build_dsp, chain, tb_out, tables)
        torch.cuda.synchronize()
    lbusy = _busy_ms(lprof.events())
    print(f"profiled production loop: wall {lwall * 1e3:.3f} ms, device busy "
          f"{lbusy:.3f} ms ({100 * lbusy / (lwall * 1e3):.1f}% busy; a chunk: wall "
          f"{lwall * 1e3 / args.chunks:.3f} ms, busy {lbusy / args.chunks:.3f} ms)",
          flush=True)

    # 5. the staging copy alone
    from concurrent.futures import ThreadPoolExecutor

    plane = torch.from_numpy(wf)
    pinned = torch.empty(plane.shape, dtype=plane.dtype, pin_memory=True)

    def copy_ms():
        t0 = time.perf_counter()
        pinned.copy_(plane)
        return (time.perf_counter() - t0) * 1e3

    def pageable_ms():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plane.to("cuda")
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    copy_ms()
    main_ms = [round(copy_ms(), 3) for _ in range(3)]
    with ThreadPoolExecutor(1) as ex:
        worker_ms = [round(ex.submit(copy_ms).result(), 3) for _ in range(3)]
        busy_ms = []
        for _ in range(3):
            staged = chain.stage_inputs(tables[0])
            fut = ex.submit(copy_ms)
            chain.fetch(chain.dispatch(staged))
            busy_ms.append(round(fut.result(), 3))
    paged = [round(pageable_ms(), 3) for _ in range(3)]
    mb = plane.numel() * plane.element_size() / 1e6
    print(f"staging copy of one {tuple(plane.shape)} float32 plane ({mb:.0f} MB) "
          f"into pinned memory, ms: main thread {main_ms}, worker thread "
          f"{worker_ms}, worker while the main thread dispatches a chunk "
          f"{busy_ms}; pageable -> card .to('cuda') {paged}; "
          f"torch.get_num_threads() {torch.get_num_threads()}, "
          f"os.cpu_count() {os.cpu_count()}", flush=True)

    # 6. where the first call's host time goes
    print(f"first call in the process (profiled): {cold * 1e3:.3f} ms; host "
          "operations by self CPU time:")
    print(first.key_averages().table(sort_by="self_cpu_time_total", row_limit=12))
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
        prof.export_chrome_trace(args.trace)
    return 0


def _steps_of(cfg, tb, kw):
    """The step objects of the chain ``build_dsp`` builds for ``tb``."""
    from dspeed_tpu_torch.processing_chain import build_processing_chain

    chain, _, _ = build_processing_chain(
        cfg, tb[0:2], db_dict=kw["database"], device="cpu", fuse=kw["fuse"]
    )
    return chain._steps


if __name__ == "__main__":
    sys.exit(main())
