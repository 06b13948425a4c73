"""Run K6 (the up-domain kernel of ``dspeed_tpu_torch/csrc/fused_current.cu``)
on the CPU, one thread per CUDA thread, and hold its four outputs bit for bit
against a reference kernel of the same arithmetic in the reference order.

The kernel's source, up to its host-side launch code, is turned into host
C++ by ``tools/k7_emu``'s text rewrite and compiled with ``g++`` and that
directory's shims of the CUDA built-ins (``cuda_runtime.h``). ``k6_main.cpp``
runs it beside the reference: the whole row in shared memory, the
replication, ``mw_cascade.cuh``'s block scan and stages, and
``block_reduce.cuh``'s first-occurrence extrema over the unchanged headers.
The builds, as for K7:

- ``tsan``: ``-fsanitize=thread``; the block and warp barriers are pthread
  barriers, so a shared-memory access not ordered by a barrier (the warp
  totals, the ramps' end samples or the prefix taken again too early) is a
  reported race.
- ``asan``: ``-fsanitize=address``, each block given exactly the bytes that
  ``dspeed_fused_current_smem_bytes`` reports, so a read or write past the
  launch's shared memory fails.
- ``sites``: every thread of a block barrier, and every lane of a warp
  collective, must arrive by one call path.

Each case is one geometry and one ``need``, at full width, on rows made
from a seed (``ROWS``): ordinary currents, rows whose samples span more
binary orders than any exactness shortcut allows, constant rows (exact
ties: index 0), extrema at both ends, denormal and large samples, NaN at
either end, and the five infinite rows of ``chip_smoke.with_infinite_rows``
(NaN on all four outputs where a moving-window stage runs and the upsampled
row reads the infinity; finite where it does not, and with no stage, where
the infinity is the extremum). Every output is also held against the plain
version by ``chip_smoke.check_current``'s rule. ``--div N`` checks
``k6_div`` against the division on N numerators for every window length.

    python3 tools/k6_emu/run_k6_emu.py [--mode tsan|asan|sites] [--div N]
        [--build DIR] [case ...]
"""

import argparse
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
for p in (REPO, os.path.join(REPO, "tools", "k7_emu")):
    if p not in sys.path:
        sys.path.insert(0, p)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from run_k7_emu import FLAGS, build  # noqa: E402

SRC = os.path.join(REPO, "dspeed_tpu_torch", "csrc", "fused_current.cu")
CUTS = ('extern "C" int dspeed_fused_current(const',)
ALL = (True,) * 4
MAX_SIDE = (False, True, False, True)  # the flagship chain's
# case: (n_curr, ratio, n_up, L, num, mtype, need)
CASES = {
    "flagship": (300, 16, 4784, 48, 3, 0, MAX_SIDE),
    "flagship_all": (300, 16, 4784, 48, 3, 0, ALL),
    "L128": (301, 16, 4788, 128, 3, 0, ALL),
    "chain_L128": (300, 16, 4784, 128, 3, 0, MAX_SIDE),
    "all_right": (300, 16, 4700, 32, 3, 2, (True, False, False, False)),
    "all_left": (300, 16, 4700, 32, 2, 1, (False, False, True, True)),
    "no_stage": (300, 16, 4784, 32, 0, 0, ALL),
    "generic_L128": (320, 16, 5100, 128, 3, 0, MAX_SIDE),
    "L3": (300, 16, 4784, 3, 3, 0, ALL),
    "generic": (400, 16, 6392, 100, 3, 0, ALL),
    "generic_short": (100, 8, 790, 32, 2, 0, ALL),
    "short": (20, 4, 77, 5, 2, 0, ALL),
    "L1_ratio1": (500, 1, 500, 1, 3, 0, ALL),
}
ROWS = ("normal", "wide", "zero", "seven", "max_first", "max_last", "tiny",
        "large", "nan_first", "nan_last", "inf_first", "inf_last", "inf_mid",
        "inf_mid1", "inf_two")


def rows(n_curr, seed=7):
    """One current row of each kind of ``ROWS``."""
    rng = np.random.default_rng(seed)
    c = rng.normal(0, 30, (len(ROWS), n_curr)).astype(np.float32)
    c[:, n_curr // 3] += 500
    r = {k: i for i, k in enumerate(ROWS)}
    # samples over 2^-60 .. 2^60: far more binary orders than 53 - 24 - 13
    c[r["wide"]] = (rng.choice([-1, 1], n_curr)
                    * np.exp2(rng.uniform(-60, 60, n_curr))).astype(np.float32)
    c[r["zero"]] = 0.0
    c[r["seven"]] = 7.0
    c[r["max_first"], 0] += 4000
    c[r["max_first"], n_curr - 1] -= 4000
    c[r["max_last"], 0] -= 4000
    c[r["max_last"], n_curr - 1] += 4000
    c[r["tiny"]] = (c[r["tiny"]].astype(np.float64) * 1e-43).astype(np.float32)
    c[r["large"]] *= np.float32(1e30)
    c[r["nan_first"], 0] = np.nan
    c[r["nan_last"], n_curr - 1] = np.nan
    # chip_smoke.with_infinite_rows' five rows
    c[r["inf_first"], 0] = np.inf
    c[r["inf_last"], n_curr - 1] = -np.inf
    c[r["inf_mid"], n_curr // 2] = np.inf
    c[r["inf_mid1"], n_curr // 2 + 1] = -np.inf
    c[r["inf_two"], 100 % n_curr], c[r["inf_two"], 200 % n_curr] = np.inf, -np.inf
    return c


def run(exe, c, geometry, need, build_dir, tag):
    """The kernel's and the reference's four outputs on the rows ``c``."""
    n_curr, ratio, n_up, L, num, mtype = geometry
    inp = os.path.join(build_dir, f"{tag}.in")
    out = os.path.join(build_dir, f"{tag}.out")
    B = c.shape[0]
    with open(inp, "wb") as f:
        hdr = [B, n_curr, ratio, ratio // 2, n_up, L, num, mtype,
               *(int(x) for x in need), 0x7F]
        f.write(np.asarray(hdr, np.int32).tobytes())
        f.write(np.ascontiguousarray(c, np.float32).tobytes())
    env = dict(os.environ, TSAN_OPTIONS="halt_on_error=1 report_signal_unsafe=0",
               ASAN_OPTIONS="detect_leaks=0")
    r = subprocess.run([exe, inp, out], capture_output=True, text=True, env=env)
    if r.returncode:
        raise RuntimeError(f"{tag}: the emulated kernels failed ({r.returncode}):\n"
                           f"{r.stdout[-2000:]}{r.stderr[-6000:]}")
    o = np.fromfile(out, np.float32).reshape(2, 4, B)
    return o[0], o[1], r.stdout.strip()


def check(label, c, geometry, need, got, ref) -> str:
    """``got`` bit for bit against ``ref``, both against the plain version
    (``chip_smoke.check_current``'s rule, its K6 tolerance), and the rows'
    own rules; raises AssertionError, or returns a summary."""
    import chip_smoke as cs
    from dspeed_tpu_torch.processors import _cuda

    n_curr, ratio, n_up, L, num, mtype = geometry
    diff = got.view(np.uint32) != ref.view(np.uint32)
    if diff.any():
        q, b = np.argwhere(diff)[0]
        raise AssertionError(
            f"{label}: output {q} of row {ROWS[b]} differs from the reference "
            f"({got[q, b]!r} against {ref[q, b]!r}; {int(diff.sum())} outputs)")
    ct = torch.from_numpy(c)
    plain = _cuda.fused_current_plain(ct, ratio, ratio // 2, n_up, L, num, mtype)
    gt = tuple(torch.from_numpy(got[q]) for q in range(4))
    geom = (ratio, ratio // 2, n_up, L, num, mtype)
    # the outputs the kernel fills: an amplitude beside its needed index too
    filled = (need[0], need[1], need[0] or need[2], need[1] or need[3])
    err, excused = cs.check_current(label, gt, plain, ct, geom, cs.K6_REL, filled)
    read = np.zeros(n_curr, bool)
    read[ratio // 2 // ratio : (n_up - 1 + ratio // 2) // ratio + 1] = True
    # with no stage, no prefix difference turns an infinity into NaN
    bad = np.isnan(c).any(1) | ((np.isinf(c) & read).any(1) & (num > 0))
    assert (np.isnan(got) == bad).all(), f"{label}: NaN rows"
    for kind in ("zero", "seven"):
        b = ROWS.index(kind)
        for q in range(2):
            assert got[q, b] == 0, f"{label}: {kind} row's index {q}"
    return (f"bit for bit equal to the reference on {c.shape[0]} rows; "
            f"vs plain max err {err:.3e}, {excused} index rows excused; "
            f"{int(bad.sum())} NaN rows")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=sorted(FLAGS), default="tsan")
    ap.add_argument("--div", type=int, default=0,
                    help="numerators per window length for the k6_div check")
    ap.add_argument("--build", default=os.path.join(HERE, "build"))
    ap.add_argument("cases", nargs="*", default=list(CASES))
    args = ap.parse_args(argv)
    exe = build(SRC, args.mode, args.build, "k6",
                main=os.path.join(HERE, "k6_main.cpp"), cuts=CUTS)
    bad = 0
    if args.div:
        r = subprocess.run([exe, "--div", str(args.div)], capture_output=True,
                           text=True)
        print(r.stdout.strip(), r.stderr.strip(), flush=True)
        bad += r.returncode != 0
    for label in args.cases:
        *geometry, need = CASES[label]
        c = rows(geometry[0])
        try:
            got, ref, info = run(exe, c, geometry, need, args.build, label)
            msg = f"{info}; " + check(label, c, geometry, need, got, ref)
        except (AssertionError, RuntimeError) as e:
            bad += 1
            msg = f"FAILED: {e}"
        print(f"{label} {tuple(geometry)} need {need} [{args.mode}]: {msg}",
              flush=True)
    print("FAILED" if bad else "OK")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
