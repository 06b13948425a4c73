"""Time a path's generic groups and its warm ``build_dsp`` for one tree of
the port, so that a tree whose K7 runs each group as one launch and one
whose groups split around members K7 has no op for can be held side by
side in one call.

``--path`` names the path: ``plane`` (``chip_smoke.plane_config``,
``build_dsp`` with ``fuse="generic"``), ``f64`` (the float64 flagship,
``chip_smoke.flagship_config("float64")`` on the events in float64, its
groups from ``fuse="generic"`` and ``build_dsp`` in the default mode, which
forms the same groups on the card: no hand kernel takes a float64 plane) or
``f64plane`` (the float64 plane path, ``chip_smoke.plane_config("float64")``
on the events in float64, ``build_dsp`` with ``fuse="generic"``).
``--root DIR`` is the tree whose ``dspeed_tpu_torch`` is imported (default:
the tree this script sits in); the configuration and the events are always
this tree's (``chip_smoke``, ``make_hpge_waveforms``), so an older tree
runs the same columns. ``--max-members N`` refuses the lowering of any run
of more than N members (the group then bisects as a refused lowering does),
to time a group run in smaller launches on one tree.

For each generic group it prints the time of the group's own step on the
device (every launch and plain step it makes, with CUDA events around
``iters`` runs back to back) and its K7 launches a run; then ``build_dsp``
(Table -> Table) four times, the last three warm, each call's events a
second, K7 launches a call and the generic-group splits. The last line is
one JSON object of these figures. On the card, from the root of a tree:

    python3 tools/k7_plane_split.py --label change [--path f64]
    python3 tools/k7_plane_split.py --root _dev/parent --label parent [--path f64]
"""

import argparse
import importlib.util
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_smoke():
    """This tree's ``chip_smoke`` by its path, whatever tree's package is
    imported."""
    spec = importlib.util.spec_from_file_location("plane_smoke",
                                                  os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--label", default="")
    ap.add_argument("--path", choices=("plane", "f64", "f64plane"), default="plane")
    ap.add_argument("--events", type=int, default=16384)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--max-members", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np
    import torch

    import dspeed_tpu_torch as dsp
    from dspeed_tpu_torch import lh5
    from dspeed_tpu_torch.processing_chain import GroupStep, build_processing_chain
    from dspeed_tpu_torch.processors import _cuda, _tile_program

    if os.path.dirname(os.path.abspath(dsp.__file__)) != os.path.join(
            os.path.abspath(args.root), "dspeed_tpu_torch"):
        raise SystemExit(f"imported {dsp.__file__}, not the tree at {args.root}")
    cs = load_smoke()
    if args.max_members:
        lower = _tile_program.lower

        def refusing(members, vals, escapes):
            if len(members) > args.max_members:
                raise _tile_program.LoweringError(
                    f"more than {args.max_members} members (--max-members)")
            return lower(members, vals, escapes)

        _tile_program.lower = refusing
    dev = torch.device(args.device)
    card = cs.card_line() if dev.type == "cuda" else "cpu"
    clock = "CUDA events" if dev.type == "cuda" else "host clock"
    print(card, flush=True)
    f64 = args.path != "plane"
    cfg = {"plane": cs.plane_config, "f64": lambda: cs.flagship_config("float64"),
           "f64plane": lambda: cs.plane_config("float64")}[args.path]()
    fuse = {} if args.path == "f64" else {"fuse": "generic"}  # build_dsp's mode
    column = "trapEmax" if args.path == "f64" else "tf_max"
    db = {"pz": {"tau": cs.TAU}}
    wf, _amp, _t0, bl, _rt = cs.make_hpge_waveforms(args.events)
    tb = cs.hpge_table(lh5, wf.astype(np.float64) if f64 else wf, bl)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def ms_of(fn, iters):
        for _ in range(2):
            fn()
        sync()
        t = time.perf_counter()
        if dev.type == "cuda":
            start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
        for _ in range(iters):
            fn()
        if dev.type != "cuda":
            return (time.perf_counter() - t) * 1e3 / iters
        stop.record()
        sync()
        return start.elapsed_time(stop) / iters

    chain, _, _ = build_processing_chain(cfg, tb, db_dict=db, device="cpu",
                                         fuse="generic")
    inputs, _ = chain._gather_inputs(0, len(wf))
    env = {k: v.to(dev) for k, v in chain._to_device(inputs).items()}
    env.update({k: v.to(dev) if isinstance(v, torch.Tensor) else v
                for k, v in chain._const_env().items()})
    groups = []
    with torch.no_grad():
        for step in chain._steps:
            if isinstance(step, GroupStep):
                _tile_program.reset_splits()
                before = _cuda.LAUNCHES["generic_rows"]
                step.run(dict(env))
                sync()
                k7 = _cuda.LAUNCHES["generic_rows"] - before
                splits = sum(_tile_program.SPLITS.values())
                ms = ms_of(lambda: step.run(dict(env)), args.iters)
                label = "ABCDEFGH"[len(groups)]
                print(f"[{args.label}] {args.path} group {label}: {len(step.members)} members, "
                      f"{k7} K7 launches and {splits} splits a run, {ms:.4f} ms a run "
                      f"({args.events} events, {clock}) on {card}",
                      flush=True)
                groups.append(dict(members=len(step.members), k7_launches=k7,
                                   splits=splits, ms=ms))
            step.run(env)
    del env
    rates = []
    for q in range(4):
        _tile_program.reset_splits()
        before = _cuda.LAUNCHES["generic_rows"]
        sync()
        t = time.perf_counter()
        out = dsp.build_dsp(tb, dsp_config=cfg, database=db, device=args.device, **fuse)
        sync()
        s = time.perf_counter() - t
        k7 = _cuda.LAUNCHES["generic_rows"] - before
        col = np.asarray(out[column].nda)
        if col.shape != (args.events,) or not np.isfinite(col).mean() > 0.9:
            raise AssertionError(f"build_dsp: {column} of shape {col.shape}")
        print(f"[{args.label}] build_dsp [{args.path}] call {q + 1}: {s:.4f} s "
              f"({args.events / s:.0f} wf/s), {k7} K7 launches, splits "
              f"{sum(_tile_program.SPLITS.values())} on {card}", flush=True)
        if q:
            rates.append(args.events / s)
    print(json.dumps({"label": args.label, "path": args.path, "card": card,
                      "groups": groups, "warm_wf_s": rates,
                      "max_members": args.max_members}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
