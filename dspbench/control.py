#!/usr/bin/env python3
"""The readings that the comparison's limits are set from, on the card.

    python3 dspbench/control.py --workload <name> --seeds <n> [<n> ...] [--faulted N] [--files K]

For each seed it sets the cell up as a run does (the event pool from the
seed, the warm-up file) and computes the plain reference over the pool once.
Then it runs the cell's timed path (``run.Cell.window``, what a run's window
runs) over files 1 .. K of the cell's traffic and holds them against the
reference as a run does (``check.py``):

- ``sound``: the program as it is;
- each fault of ``faults.py`` planted in the program (the first N seeds);
- ``control``: the reference computed in the nearest precision below the
  configuration's (``check.control``: TF32 convolutions on float32 rows for
  a float32 chain, float32 for a float64 one), put in the program's place
  (the first N seeds);
- ``control_one_chunk``: the float64 reference in the program's place, with
  the control's rows in the middle chunk of each file (the first N seeds).

Prints one JSON line a seed: each reading's compared numbers, its events
found wrong by column, and each column's largest ``|program - reference| /
tolerance``. The benchmark's runs do not run this.
"""

import argparse
import json
import sys

import numpy as np

import run


def as_table(cols: dict, spec: dict, lo: int, n: int) -> dict:
    """Rows ``lo .. lo + n`` of reference-shaped columns as the program's
    output objects (an ``Array`` a column, a ``VectorOfVectors`` where the
    reference pads one)."""
    from dspeed_tpu_torch.lh5 import Array, VectorOfVectors

    out = {}
    for name in spec["tolerance"]:
        v = cols[name][lo:lo + n]
        if v.ndim == 2:
            lens = cols["n"][lo:lo + n].astype(np.int64)
            keep = np.arange(v.shape[1])[None, :] < lens[:, None]
            out[name] = VectorOfVectors(flattened_data=v[keep],
                                        cumulative_length=np.cumsum(lens).astype(np.uint32))
        else:
            out[name] = Array(v)
    return out


def one_chunk(ref: dict, ctl: dict, lo: int, n: int, bl: int) -> dict:
    """Rows ``lo .. lo + n`` of ``ref`` (a file), with its middle chunk's
    rows taken from ``ctl``."""
    s = (-(-n // bl) // 2) * bl
    e = min(s + bl, n)
    cols = {}
    for name, v in ref.items():
        cols[name] = v[lo:lo + n].copy()
        cols[name][s:e] = ctl[name][lo + s:lo + e]
    return cols


def reading(cmp) -> dict:
    return {**cmp.numbers(), "column_bad": cmp.column_bad,
            "worst": {k: v for k, v in cmp.worst.items() if v > 0}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faulted", type=int, default=3,
                    help="the first N seeds also read the faults and the control")
    ap.add_argument("--files", type=int, default=8)
    args = ap.parse_args(argv)
    import torch

    import faults
    from check import Comparison

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    _, _, cfg, traffic = run.cell_spec(args.workload)
    spec = cfg["check"]
    for i, seed in enumerate(args.seeds):
        c = run.Cell(cfg, traffic, seed)
        c.setup()
        ref = run.reference(cfg, c.pool, "cuda")
        per_file = -(-c.n_file // c.bl)
        out = {"workload": args.workload, "seed": seed}
        for kind in ["sound"] + (faults.kinds(spec) if i < args.faulted else []):
            if kind == "sound":
                c.window(0.0, files=args.files)
            else:
                with faults.planted(kind, spec, per_file):
                    c.window(0.0, files=args.files)
            c.compare(ref)
            out[kind] = reading(c.comparison)
        if i < args.faulted:
            ctl = run.reference(cfg, c.pool, "cuda", precision=spec["control"])
            for kind in ("control", "control_one_chunk"):
                cmp = Comparison(ref, spec, c.bl)
                for k in range(1, args.files + 1):
                    lo = c.offset(k)
                    if kind == "control":
                        out_k = as_table(ctl, spec, lo, c.n_file)
                    else:
                        out_k = as_table(one_chunk(ref, ctl, lo, c.n_file, c.bl), spec, 0,
                                         c.n_file)
                    cmp.add_file(out_k, lo)
                out[kind] = reading(cmp)
            del ctl
        print(json.dumps(out), flush=True)
        del c, ref
    return 0


if __name__ == "__main__":
    sys.path.insert(0, run.ROOT)
    sys.exit(main())
