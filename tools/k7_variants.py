"""Time K7's generic groups for several builds of ``csrc/generic_rows.cu``
in turns in one process, so that a change to the kernel's source is held
against its parent on one card at once, its outputs bit for bit.

    python3 tools/k7_variants.py parent=_dev/parent/dspeed_tpu_torch/csrc/generic_rows.cu \\
        change=dspeed_tpu_torch/csrc/generic_rows.cu [--paths f64extras ...] [--rounds 3]

Each source is built as ``processors/_cuda.py`` builds K7 (the same ``nvcc``
flags, with ``-Xptxas -v``; the headers from the source's own directory,
else this tree's ``csrc``)
into this tree's build directory and bound by ``_cuda._bind``; this tree's
lowering makes every tape, so the sources must share its tape layout. A
path's groups are those of its ``chip_smoke`` config on ``chip_smoke``'s
events (``sipm`` and ``f64sipm``: the SiPM chain on ``sipm_edge_rows``, in
float32 and widened to float64), formed with ``fuse="generic"`` (a group
whose lowering is refused runs as its parts, ``chip_smoke.k7_parts``). Each
round times every group on every build on the device alone
(``chip_smoke.device_ms``), the builds in the order given and then reversed
(parent, change, change, parent), and
holds every build's outputs bit for bit against the first build's. The last
line is one JSON object: the card, each build's ``ptxas`` report, and each
group's milliseconds by build, one value a turn.
"""

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

# path -> (chip_smoke's config maker and its argument, rows in float64, the
# generator of its rows: the flagship's, the DPZ's or the SiPM chain's, with
# chip_smoke.sipm_edge_rows)
PATHS = {"flagship": ("config", None, False, "hpge"),
         "f64": ("flagship_config", "float64", True, "hpge"),
         "f64dpz": ("dpz_config", "float64", True, "dpz"),
         "f64extras": ("extras_config", "float64", True, "hpge"),
         "f64plane": ("plane_config", "float64", True, "hpge"),
         "sipm": ("sipm_config", None, False, "sipm"),
         "f64sipm": ("sipm_config", None, True, "sipm")}


def build(_cuda, label, src):
    """``(library, ptxas report)`` of ``src`` built as K7's library."""
    os.makedirs(_cuda._BUILD, exist_ok=True)
    so = os.path.join(_cuda._BUILD, f"libdspeed_generic_rows_{label}.so")
    cmd = [_cuda._nvcc(), "-Xptxas", "-v", "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", f"-I{_cuda._CSRC}",
           "-o", so, src]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode:
        raise SystemExit(f"nvcc failed for {src}:\n{res.stdout}{res.stderr}")
    import chip_smoke as cs

    return _cuda._bind("generic_rows", so), cs.k7_ptxas(res.stdout + res.stderr)


def groups(cs, path, n, dev):
    """``[(label, program, vals)]``: the launches of ``path``'s groups on
    ``n`` events on ``dev``, each group's inputs from the steps before it."""
    import numpy as np
    import torch

    from dspeed_tpu_torch import lh5
    from dspeed_tpu_torch.processing_chain import GroupStep, build_processing_chain
    from dspeed_tpu_torch.processors import _cuda

    make, arg, f64, rows = PATHS[path]
    cfg = getattr(cs, make)(*([arg] if arg else []))
    if rows == "sipm":
        wf = cs.sipm_edge_rows(cs.make_sipm_waveforms(n)[0])
        tb = cs.sipm_table(lh5, wf.astype(np.float64) if f64 else wf)
    else:
        gen = cs.make_hpge_dpz_waveforms if rows == "dpz" else cs.make_hpge_waveforms
        wf, _amp, _t0, bl, _rt = gen(n)
        tb = cs.hpge_table(lh5, wf.astype(np.float64) if f64 else wf, bl)
    chain, _, _ = build_processing_chain(cfg, tb, db_dict={"pz": {"tau": cs.TAU}},
                                         device="cpu", fuse="generic")
    inputs, _ = chain._gather_inputs(0, n)
    env = {k: v.to(dev) for k, v in chain._to_device(inputs).items()}
    env.update({k: v.to(dev) if isinstance(v, torch.Tensor) else v
                for k, v in chain._const_env().items()})
    out = []
    n_groups = 0
    with torch.no_grad():
        for step in chain._steps:
            if not isinstance(step, GroupStep):
                step.run(env)
                continue
            group = "ABCDEFGH"[n_groups]
            n_groups += 1
            refusals: list = []
            for q, (_members, vals, prog) in enumerate(cs.k7_parts(step, env, refusals)):
                out.append((group + (str(q + 1) if refusals else ""), prog, vals))
                env.update(_cuda.generic_rows(prog, vals))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sources", nargs="+", help="label=path of a generic_rows.cu")
    ap.add_argument("--paths", nargs="+", default=["flagship", "f64", "f64dpz",
                                                   "f64extras"], choices=sorted(PATHS))
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
        label, src = item.split("=", 1)
        builds[label] = build(_cuda, label, os.path.abspath(src))
        print(f"{label}: {builds[label][1]}", flush=True)
    order = list(builds) + list(builds)[::-1]
    times: dict = {}
    for path in args.paths:
        _cuda._LIBS["generic_rows"] = builds[order[0]][0]
        launches = groups(cs, path, args.events, dev)
        for label, prog, vals in launches:
            want = None
            for _round in range(args.rounds):
                for b in order:
                    _cuda._LIBS["generic_rows"] = builds[b][0]
                    got = _cuda.generic_rows(prog, vals)
                    if want is None:
                        want = got
                    elif not all(cs.same_bits(got[k], want[k]) for k in want):
                        raise AssertionError(f"{path} {label}: {b} differs from {order[0]}")
                    ms = cs.device_ms(lambda: _cuda.generic_rows(prog, vals))
                    times.setdefault(path, {}).setdefault(label, {}).setdefault(
                        b, []).append(ms)
            print(f"{path} group {label} ({len(prog.ops)} ops): " + "; ".join(
                f"{b} {' / '.join(f'{t:.4f}' for t in ts)} ms"
                for b, ts in times[path][label].items()) + f" on the device alone, {card}",
                flush=True)
    print(json.dumps({"card": card, "ptxas": {b: v[1] for b, v in builds.items()},
                      "ms": times}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
