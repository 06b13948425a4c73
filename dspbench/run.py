#!/usr/bin/env python3
"""The benchmark of dspeed_tpu_torch: one cell, one run.

    python3 dspbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cell (``BENCHMARK.json``'s entry)
names a configuration (``dspbench/configs/<name>.json``: its DSP chain, its
records, its generator and its comparison) and a traffic mix
(``dspbench/traffic/<name>.json``: chunk length, events a file). Set-up
makes a pool of events (a file's worth plus one chunk) on the card from the
seed, copies it to host memory and runs one warm-up file. The window then
calls ``dspeed_tpu_torch.build_dsp.build_dsp`` once a file, files back to
back, until ``--seconds`` have passed, and ends at the next file boundary.
After it, every output column of every file completed in the window is held
against the configuration's plain reference (``dspbench/reference/``) over
the pool (``check.py``).

The last line of standard output is one JSON object: ``correct``,
``attempted`` (events of the completed files), ``failed`` (those the
comparison found wrong), ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics, each read by ``dspbench/metrics/<name>.py``),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
compared number with its limit.
"""

import time

T_PROCESS = time.time_ns() * 1e-9  # set-up is timed from here

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "dspeed_tpu")
PEAK_BYTES_S = 3.35e12  # H100 SXM HBM3, NVIDIA's data sheet
POOL_BLOCK_ELEMS = 1 << 26  # samples a block of the pool and the reference
# on the CPU (the tests), where conv1d unfolds its input, the reference's
# blocks are kept to a few hundred MB
CPU_REF_BLOCK_ELEMS = 1 << 18


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN (whole names:
    ``dspeed_tpu_torch`` is not ``dspeed_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def cell_spec(name: str) -> tuple:
    """(BENCHMARK.json, the cell's entry, its configuration, its traffic)."""
    bench = load_json(ROOT, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[name]
    cfg = load_json(HERE, "configs", f"{cell['config']}.json")
    traffic = load_json(HERE, "traffic", f"{cell['traffic']}.json")
    return bench, cell, cfg, traffic


def make_pool(cfg: dict, n: int, seed: int, device):
    """The pool's columns as host numpy arrays, made on ``device`` from the
    seed in blocks and copied straight into pageable host memory."""
    import numpy as np
    import torch

    gen = load_module(os.path.join(HERE, "generators", f"{cfg['generator']}.py"),
                      f"dspbench_gen_{cfg['generator']}")
    samples = cfg["record"]["samples"]
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    pool = {}
    block = max(1, POOL_BLOCK_ELEMS // samples)
    for lo in range(0, n, block):
        hi = min(n, lo + block)
        cols = gen.make(hi - lo, samples, cfg["generator_params"], g, device)
        for k, v in cols.items():
            if k not in pool:
                pool[k] = np.empty((n, *v.shape[1:]), dtype=np.float32)
            torch.from_numpy(pool[k][lo:hi]).copy_(v)
    return pool


def reference(cfg: dict, pool: dict, device, precision: str | None = None) -> dict:
    """The configuration's plain reference over the pool, block by block on
    ``device``: column name -> numpy array over the pool's events."""
    import numpy as np
    import torch

    ref = load_module(os.path.join(HERE, "reference", f"{cfg['reference']}.py"),
                      f"dspbench_ref_{cfg['name']}")
    names = list(cfg["columns"])
    n = len(pool[names[0]])
    elems = POOL_BLOCK_ELEMS if str(device).startswith("cuda") else CPU_REF_BLOCK_ELEMS
    block = max(1, elems // cfg["record"]["samples"])
    parts = []
    for lo in range(0, n, block):
        args = [torch.from_numpy(pool[k][lo:lo + block]).to(device) for k in names]
        kw = {} if precision is None else {"precision": precision}
        parts.append(ref.compute(*args, **kw))
        del args
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


class Cell:
    """One run's set-up, window and comparison (``device`` "cuda" on the
    card; "cpu" only for the tests, which shrink ``traffic``)."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device: str = "cuda"):
        self.cfg = cfg
        self.traffic = traffic
        self.seed = seed
        self.device = device
        self.bl = traffic["buffer_len"]
        self.n_file = traffic["events_per_file"]

    def offset(self, k: int) -> int:
        return (k * self.traffic["file_offset_step"]) % self.bl

    def source(self, k: int, on_handover=None):
        from source import PoolSource

        return PoolSource(self.pool, self.cfg["columns"], self.cfg["record"]["dt_ns"],
                          self.offset(k), self.n_file, self.bl, on_handover)

    def run_file(self, k: int, stats=None, on_handover=None):
        from dspeed_tpu_torch.build_dsp import build_dsp

        return build_dsp(self.source(k, on_handover), dsp_out=None,
                         dsp_config=self.cfg["dsp_config"], buffer_len=self.bl,
                         device=self.device, stats=stats)

    def setup(self) -> None:
        import torch

        t0 = time.time_ns() * 1e-9
        self.pool = make_pool(self.cfg, self.n_file + self.bl, self.seed, self.device)
        self.pool_s = time.time_ns() * 1e-9 - t0
        t0 = time.time_ns() * 1e-9
        self.run_file(0)  # the warm-up file: chain build, lazy loading, every shape
        if self.device == "cuda":
            torch.cuda.synchronize()
        self.first_call_s = time.time_ns() * 1e-9 - t0

    def window(self, seconds: float, spans=None, files: int | None = None) -> None:
        """Files back to back from file 1 until ``seconds`` have passed, to
        the next file boundary (or ``files`` files); keeps each file's output
        and its bounds."""
        self.outputs, self.files, self.stats = [], [], {}
        hand = spans.on_handover if spans is not None else None
        self.t_lo = time.time_ns() * 1e-9
        k = 1
        while True:
            t0 = time.time_ns() * 1e-9
            out = self.run_file(k, stats=self.stats, on_handover=hand)
            t1 = time.time_ns() * 1e-9
            self.outputs.append((self.offset(k), out))
            self.files.append((t0, t1))
            k += 1
            if (t1 - self.t_lo >= seconds) if files is None else k > files:
                break
        self.t_hi = t1

    def compare(self, ref: dict | None = None) -> dict:
        """Hold every completed file against the reference over the pool
        (``ref``; without it, free the program's chains and run the
        reference first); returns the numbers."""
        import torch

        from check import Comparison
        from dspeed_tpu_torch import build_dsp as driver

        if ref is None:
            driver._CHAIN_CACHE.clear()
            gc.collect()
            if self.device == "cuda":
                torch.cuda.empty_cache()
            ref = reference(self.cfg, self.pool, self.device)
        cmp = Comparison(ref, self.cfg["check"], self.bl)
        for offset, out in self.outputs:
            cmp.add_file(out, offset)
        self.comparison = cmp
        return cmp.numbers()


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): each number at or under its
    limit; a number without a limit fails."""
    checks = {}
    ok = True
    for k, v in numbers.items():
        lim = limits.get(k)
        checks[k] = {"value": v, "limit": lim}
        if lim is None or not v <= lim:
            ok = False
    return ok, checks


def read_metrics(names: list, record: dict, units: dict) -> dict:
    out = {}
    for name in names:
        mod = load_module(os.path.join(HERE, "metrics", f"{name}.py"), f"dspbench_m_{name}")
        v = mod.read(record)
        if v is not None:
            out[name] = {"value": v, "unit": units[name]}
    return out


def measure(bench: dict, cell: dict, cfg: dict, traffic: dict, seed: int,
            seconds: float, trace: bool, device: str = "cuda") -> dict | None:
    """Everything of a run after the look for a card: set-up, the window,
    the metrics and the comparison. Returns the result's object, or None
    where the process loaded a forbidden module. ``device`` "cpu" (the
    tests, untraced) reads no device numbers."""
    import torch

    on_card = device == "cuda"
    run = Cell(cfg, traffic, seed, device)
    run.setup()
    print(f"set-up: {time.time_ns() * 1e-9 - T_PROCESS:.3f} s, of which the pool "
          f"{run.pool_s:.3f} s and the warm-up file {run.first_call_s:.3f} s",
          file=sys.stderr)
    record = {}
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    cpu0 = resource.getrusage(resource.RUSAGE_SELF)
    if trace:
        from tracing import Spans, device_events

        spans = Spans()
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        with spans:
            prof.start()
            torch.cuda.synchronize()
            run.window(seconds, spans)
            torch.cuda.synchronize()
            prof.stop()
        dev = device_events(prof, run.t_lo, run.t_hi)
        record.update(spans=spans.spans, handover=spans.handover, device=dev)
    else:
        run.window(seconds)
    cpu1 = resource.getrusage(resource.RUSAGE_SELF)
    print(f"this process's CPU time in the window: user {cpu1.ru_utime - cpu0.ru_utime:.2f} s, "
          f"system {cpu1.ru_stime - cpu0.ru_stime:.2f} s, over {run.t_hi - run.t_lo:.2f} s",
          file=sys.stderr)
    print("build_dsp's stats over the window: " + ", ".join(
        f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}" for k, v in run.stats.items()),
        file=sys.stderr)
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    window_s = run.t_hi - run.t_lo
    events = len(run.outputs) * run.n_file
    chunks = len(run.outputs) * -(-run.n_file // run.bl)
    if _report_forbidden():
        return None

    numbers = run.compare()
    correct, checks = judge(numbers, cfg["check"]["limits"])
    record.update(events=events, chunks=chunks, files=run.files, window_s=window_s,
                  setup_s=run.t_lo - T_PROCESS, first_call_s=run.first_call_s,
                  stats=run.stats, bytes_per_event=cfg["bytes_per_event"],
                  peak_bytes_s=PEAK_BYTES_S)
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    names = [m["name"] for m in bench["per_layer" if trace else "end_to_end"]
             if cell["name"] in m.get("workloads", [cell["name"]])]
    metrics = read_metrics(names, record, units)
    dev_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0) if on_card else "",
                "count": cell["chips"], "memory_peak_bytes": int(memory_peak)}
    result = {"correct": correct, "attempted": events, "failed": run.comparison.bad,
              "metrics": metrics, "device": dev_info}
    if trace:
        from tracing import breakdown, union_s

        dev_info["busy_s"] = union_s([(s, e) for s, e, _ in dev["kernels"] + dev["copies"]])
        dev_info["window_s"] = window_s
        result["breakdown"] = breakdown(dev, spans.spans, run.files, run.t_lo, run.t_hi)
        print(f"chunks in the window: {chunks} ({len(run.outputs)} files); kernels "
              f"traced: {len(dev['kernels'])}; copies: {len(dev['copies'])}",
              file=sys.stderr)
    if _report_forbidden():
        return None
    result["checks"] = checks
    cmp = run.comparison
    durations = sorted(e - s for s, e in run.files)
    print(f"files completed: {len(run.outputs)} in {window_s:.3f} s (a file: "
          f"{durations[0]:.4f} to {durations[-1]:.4f} s, median "
          f"{durations[len(durations) // 2]:.4f}); events compared: {events}; events "
          f"found wrong: {cmp.bad}", file=sys.stderr)
    if cmp.column_bad:
        print(f"events found wrong by column: {cmp.column_bad}; e.g. (column, pool row, "
              f"program, reference): {cmp.examples}", file=sys.stderr)
    print("largest |program - reference| / tolerance by column: " + ", ".join(
        f"{k} {v:.3g}" for k, v in cmp.worst.items()), file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    return result


def _report_forbidden() -> bool:
    found = forbidden_modules()
    if found:
        print(f"the process loaded {found}: the benchmark must not import them",
              file=sys.stderr)
    return bool(found)


def fix_cache_dirs() -> None:
    """Every build and kernel cache a run could fill, at fixed paths inside
    the checkout (the port builds its kernels under
    ``dspeed_tpu_torch/_build/`` itself)."""
    base = os.path.join(ROOT, ".dspbench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(base, sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench, cell, cfg, traffic = cell_spec(args.workload)
    fix_cache_dirs()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"card: {card_line()}; devices: {torch.cuda.device_count()}; cell uses "
          f"{cell['chips']}", file=sys.stderr)
    result = measure(bench, cell, cfg, traffic, args.seed, args.seconds,
                     bool(args.trace))
    if result is None:
        return 3
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main())
