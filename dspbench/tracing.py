"""Spans of the traced run, recorded from outside the program, and the
reduction of the profiler's device events.

``Spans`` wraps three ``ProcessingChain`` methods for the length of the
window, as ``chip_smoke.counted_builds`` wraps the chain build: each call's
host interval is kept in memory (``stage_inputs`` on the read-ahead worker,
``dispatch_chunk`` on the main thread, ``finish_chunk`` on the writer
thread), with the time each chunk was handed over by the source. Times are
``time.time_ns()`` seconds, the clock of the profiler's events.
"""

import time

import numpy as np

from dspeed_tpu_torch.processing_chain import ProcessingChain

NAME_CHARS = 160  # a kernel's name in the breakdown, cut (templates run long)
WRAPPED = {"stage": "stage_inputs", "dispatch": "dispatch_chunk", "fetch": "finish_chunk"}


def now() -> float:
    return time.time_ns() * 1e-9


class Spans:
    def __init__(self):
        self.spans = {k: [] for k in WRAPPED}
        self.handover = []
        self._orig = {}

    def on_handover(self) -> None:
        self.handover.append(now())

    def __enter__(self):
        for key, meth in WRAPPED.items():
            orig = getattr(ProcessingChain, meth)
            self._orig[meth] = orig
            setattr(ProcessingChain, meth, self._wrap(orig, self.spans[key]))
        return self

    def __exit__(self, *exc):
        for meth, orig in self._orig.items():
            setattr(ProcessingChain, meth, orig)

    @staticmethod
    def _wrap(orig, into):
        def call(*a, **k):
            t0 = now()
            try:
                return orig(*a, **k)
            finally:
                into.append((t0, now()))
        return call


def union_s(intervals) -> float:
    """Seconds covered by the union of ``(start, end)`` intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def gaps(intervals, lo: float, hi: float):
    """The complement of the intervals' union inside ``[lo, hi]``."""
    out, cur = [], lo
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(s, e) for s, e in out if e > s]


def device_events(prof, lo: float, hi: float) -> dict:
    """The device's kernels and copies in the profiler's trace, clipped to
    the window ``[lo, hi]``: ``{"kernels": [(start, end, name)], "copies":
    [(start, end, name)]}``."""
    kernels, copies = [], []
    for ev in prof.profiler.kineto_results.events():
        if str(ev.device_type()).split(".")[-1] != "CUDA":
            continue
        s, e = ev.start_ns() * 1e-9, ev.end_ns() * 1e-9
        if e <= lo or s >= hi:
            continue
        item = (max(s, lo), min(e, hi), ev.name())
        name = item[2].lower()
        (copies if name.startswith(("memcpy", "memset")) else kernels).append(item)
    return {"kernels": kernels, "copies": copies}


def _inside(intervals, t):
    """For each time of ``t``, whether it falls in one of the intervals
    (which do not overlap: one thread's calls)."""
    if not intervals:
        return np.zeros(len(t), dtype=bool)
    iv = np.asarray(sorted(intervals))
    k = np.searchsorted(iv[:, 0], t, side="right") - 1
    return (k >= 0) & (t <= iv[np.maximum(k, 0), 1])


def host_states(spans: dict, files: list, t) -> list:
    """What the host was doing at each time of ``t``: the name of a wrapped
    call running then (the main thread's dispatch first), else whether a
    file was open."""
    t = np.asarray(t, dtype=np.float64)
    labels = np.full(len(t), "between build_dsp calls", dtype=object)
    order = (("build_dsp, no wrapped call (waits, chain lookup, output append)", files),
             ("finish_chunk (writer thread)", spans["fetch"]),
             ("stage_inputs (read-ahead worker)", spans["stage"]),
             ("dispatch_chunk (main thread)", spans["dispatch"]))
    for label, iv in order:
        labels[_inside(iv, t)] = label
    return list(labels)


def breakdown(dev: dict, spans: dict, files: list, lo: float, hi: float) -> dict:
    """The device operations that took most time, and the device's idle time
    by what the host was doing meanwhile, ten of each."""
    by_name = {}
    for s, e, name in dev["kernels"] + dev["copies"]:
        name = name[:NAME_CHARS]
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = {}
    busy = [(s, e) for s, e, _ in dev["kernels"] + dev["copies"]]
    idle_iv = gaps(busy, lo, hi)
    labels = host_states(spans, files, [0.5 * (s + e) for s, e in idle_iv])
    for (s, e), label in zip(idle_iv, labels):
        idle[label] = idle.get(label, 0.0) + (e - s)
    gaps_out = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in gaps_out]}
