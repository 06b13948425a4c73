"""Time two sweeps, ``csrc/peakdet_scan.cu`` and ``csrc/bilevel_scan.cu``, for
several builds in turns in one process, so that a change to either kernel's
source is held against its parent on one card at once, its outputs bit for
bit.

    python3 tools/scan_variants.py parent=_dev/parent/dspeed_tpu_torch/csrc \\
        change=dspeed_tpu_torch/csrc [--rounds 2] [--events 16384]

Each ``label=dir`` names a directory holding both sources (a ``git
archive`` of an earlier commit, or this tree's ``csrc``). Each source is
built as ``processors/_cuda.py`` builds it (the same ``nvcc`` flags, with
``-Xptxas -v``) into this tree's build directory and bound by
``_cuda._bind``, so the builds share this tree's wrappers and must share
their interface. The sweeps run at the main paths' shapes: the peak
finder on the SiPM group's ``curr`` (``chip_smoke.sipm_group`` on
``sipm_edge_rows``, float64, 16384 x 1019; the chain's parameters, 20 + 20
slots, right to left) and on the same rows in float32; the bi-level trigger
on ``chip_smoke.bilevel_rows`` (the flagship extras' ``rc_cr2`` rows,
float32, 16384 x 4096, 8 slots) and on the same rows widened to float64.
Each round times every case on every build, the builds in the order given
and then reversed (parent, change, change, parent), on the device alone
(``chip_smoke.device_ms``) and through the wrapper (``chip_smoke.time_ms``),
and holds every build's outputs bit for bit against the first build's. The
last line is one JSON object: the card, each build's ``ptxas`` lines, each
case's byte bound and its milliseconds by build, one value a turn.
"""

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

KERNELS = {"peakdet_scan": ("peakdet_scan.cu", "peakdet_scan_kernel"),
           "bilevel_scan": ("bilevel_scan.cu", "bilevel_scan_kernel")}


def build(_cuda, label, csrc):
    """``{kernel: (library, ptxas lines)}`` of the two sources in ``csrc``."""
    import chip_smoke as cs

    os.makedirs(_cuda._BUILD, exist_ok=True)
    out = {}
    for name, (src, fn) in KERNELS.items():
        so = os.path.join(_cuda._BUILD, f"libdspeed_{name}_{label}.so")
        cmd = [_cuda._nvcc(), "-Xptxas", "-v", "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", so,
               os.path.join(csrc, src)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode:
            raise SystemExit(f"nvcc failed for {csrc}/{src}:\n{res.stdout}{res.stderr}")
        out[name] = (_cuda._bind(name, so), cs.scan_ptxas(res.stdout + res.stderr, fn))
    return out


def cases(cs, _cuda, n, dev):
    """``{case: (kernel, call, bound ms)}`` at the main paths' shapes."""
    from dspeed_tpu_torch import build_processing_chain, lh5
    from dspeed_tpu_torch.processors._tile_program import lower

    swf, _ = cs.make_sipm_waveforms(n)
    step, vals, _ = cs.sipm_group(build_processing_chain, lh5, cs.sipm_edge_rows(swf), dev)
    curr = _cuda.generic_rows(lower(step.members, vals, step.escapes), vals)[step.escapes[0]]
    amax = cs.sipm_amax(curr)
    amax[cs.FULL_SLOT_ROW] = 0.0
    m = cs.SIPM_SLOTS
    c32, a32 = curr.float(), amax.float()
    wf, _amp, _t0, bl, _rt = cs.make_hpge_waveforms(n)
    rc, pos, neg, gate, start = cs.bilevel_rows(wf, bl, dev)
    rc64, pos64, neg64 = rc.double(), pos.double(), neg.double()
    B, k = rc.shape
    mb = cs.EXTRAS_SLOTS

    def pk(c, a):
        return lambda: _cuda.peakdet_scan(c, cs.SIPM_DMAX, cs.SIPM_DMIN, a, 0.0, m, m, True)

    def bls(r, p, q):
        return lambda: _cuda.bilevel_scan(r, p, q, gate, start, mb)

    return {
        "peakdet_scan float64": ("peakdet_scan", pk(curr, amax), cs.scan_bound(curr, m, m)),
        "peakdet_scan float32": ("peakdet_scan", pk(c32, a32), cs.scan_bound(c32, m, m)),
        "bilevel_scan float32": ("bilevel_scan", bls(rc, pos, neg), cs.bilevel_bound(B, k, mb)),
        "bilevel_scan float64": ("bilevel_scan", bls(rc64, pos64, neg64),
                                 cs.bilevel_bound(B, k, mb, itemsize=8)),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sources", nargs="+", help="label=dir holding both sources")
    ap.add_argument("--events", type=int, default=16384)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    import torch

    import chip_smoke as cs
    from dspeed_tpu_torch.processors import _cuda

    dev = torch.device("cuda")
    card = cs.card_line()
    print(card, flush=True)
    builds = {}
    for item in args.sources:
        label, csrc = item.split("=", 1)
        builds[label] = build(_cuda, label, os.path.abspath(csrc))
        print(f"{label}: " + "; ".join(f"{k} {v[1]}" for k, v in builds[label].items()),
              flush=True)
    order = list(builds) + list(builds)[::-1]
    runs = cases(cs, _cuda, args.events, dev)
    times: dict = {}
    with torch.no_grad():
        for case, (kernel, call, bound) in runs.items():
            want = None
            for _round in range(args.rounds):
                for b in order:
                    _cuda._LIBS[kernel] = builds[b][kernel][0]
                    got = call()
                    if want is None:
                        want = got
                    elif not all(cs.same_bits(g, w) for g, w in zip(got, want)):
                        raise AssertionError(f"{case}: {b} differs from {order[0]}")
                    t = times.setdefault(case, {"bound_ms": bound, "device_ms": {},
                                                "wrapper_ms": {}})
                    t["device_ms"].setdefault(b, []).append(cs.device_ms(call))
                    t["wrapper_ms"].setdefault(b, []).append(cs.time_ms(call, 20))
            t = times[case]
            print(f"{case} (bound {bound:.4f} ms): " + "; ".join(
                f"{b} {' / '.join(f'{x:.4f}' for x in ts)} ms on the device alone "
                f"({bound / min(ts):.1%} of the bound at best), through the wrapper "
                f"{' / '.join(f'{x:.4f}' for x in t['wrapper_ms'][b])}"
                for b, ts in t["device_ms"].items()) + f"; {card}", flush=True)
    print(json.dumps({"card": card,
                      "ptxas": {b: {k: v[1] for k, v in kb.items()}
                                for b, kb in builds.items()},
                      "ms": times}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
