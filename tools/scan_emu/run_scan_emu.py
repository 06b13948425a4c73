"""Run the two sweep kernels (``dspeed_tpu_torch/csrc/peakdet_scan.cu`` and
``csrc/bilevel_scan.cu``) on the CPU, one host thread per CUDA thread, and
hold every output bit for bit against their plain versions
(``_cuda.peakdet_scan_plain``, ``_cuda.bilevel_scan_plain``).

Each source, up to its host-side launch code, is turned into host C++ by
``tools/k7_emu``'s text rewrite and compiled with ``g++`` and that
directory's shims of the CUDA built-ins (``cuda_runtime.h``) into one binary
with ``scan_main.cpp``. Neither kernel has a block barrier or shared
memory, so the builds are:

- ``asan``: ``-fsanitize=address``; every buffer (the rows, the parameters,
  the slots and counts) is allocated at exactly its size, and each block
  gets exactly its launch's shared bytes (none), so a read or write past
  one fails;
- ``sites``: every lane of a warp collective (shuffle, ballot) must arrive
  by one call path.

Each case runs float32 and float64 rows at full width on the rows of
``chip_smoke.peakdet_edge_rows`` (1019 samples, 20 + 20 slots: contiguous
in both directions, and from an offset of 1 at a stride of 1024 right to
left) or ``chip_smoke.bilevel_edge_rows`` (4096 samples and a ragged 4093,
contiguous and aligned, and from an offset of 3 samples at a stride of 2n,
with 8, 40 and 1 slots). The slots and counts start filled with 0x7f bytes,
so a slot no lane wrote differs from the plain version's NaN.

    python3 tools/scan_emu/run_scan_emu.py [--mode asan|sites] [--build DIR] [case ...]
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

import run_k7_emu  # noqa: E402

CSRC = os.path.join(REPO, "dspeed_tpu_torch", "csrc")
SOURCES = {"PKSRC": ("peakdet_scan.cu", "template <typename T>\nstatic cudaError_t pk_launch"),
           "BLSRC": ("bilevel_scan.cu", "template <typename T>\nstatic cudaError_t bl_launch")}
MODES = ("asan", "sites")
FILL = 0x7F
PEAK_N, PEAK_SLOTS = 1019, 20
# the peak finder's runs: (stride, offset, reverse)
PEAK_LAYOUTS = ((PEAK_N, 0, 0), (PEAK_N, 0, 1), (PEAK_N + 5, 1, 1))
# layouts of the bi-level rows: (n, stride, offset, slots)
BILEVEL_LAYOUTS = ((4096, 4096, 0, 8), (4096, 8192, 3, 40), (4093, 4096, 0, 1))
CASES = ("peakdet_f32", "peakdet_f64", "bilevel_f32", "bilevel_f64")


def build(mode: str, build_dir: str, srcs=None) -> str:
    """Both sources (``srcs``: {macro: path}, this tree's by default) and
    ``scan_main.cpp`` built for ``mode``; returns the executable."""
    os.makedirs(build_dir, exist_ok=True)
    defs = []
    for macro, (name, cut) in SOURCES.items():
        src = (srcs or {}).get(macro, os.path.join(CSRC, name))
        inc = run_k7_emu.host_source(src, os.path.join(build_dir, f"{name}.inc"), (cut,))
        defs.append(f'-D{macro}="{inc}"')
    exe = os.path.join(build_dir, f"scan_{mode}")
    cmd = ["g++", "-std=c++17", "-g", "-ffp-contract=off", "-pthread",
           *run_k7_emu.FLAGS[mode], f"-I{run_k7_emu.HERE}", *defs, "-o", exe,
           os.path.join(HERE, "scan_main.cpp")]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"g++ failed ({mode}):\n{r.stderr[-4000:]}")
    return exe


def run(exe, build_dir, tag, kind, w, stride, off, ints, pars, outs):
    """The kernel's outputs on the rows ``w`` (laid out at ``stride`` from
    ``off``): ``pars`` the per-row arrays in the input's order, ``outs``
    the outputs' (numpy type, count) in the output's order."""
    B, n = w.shape
    dt = w.dtype
    flat = np.full(off + (B - 1) * stride + n, np.nan, dt)
    for r in range(B):
        flat[off + r * stride: off + r * stride + n] = w[r]
    inp, out = (os.path.join(build_dir, f"{tag}.{x}") for x in ("in", "out"))
    with open(inp, "wb") as f:
        hdr = [kind, int(dt == np.float64), B, n, stride, off, *ints, FILL]
        f.write(np.asarray(hdr, np.int32).tobytes())
        f.write(flat.tobytes())
        for p in pars:
            f.write(np.ascontiguousarray(p).tobytes())
    env = dict(os.environ, ASAN_OPTIONS="detect_leaks=0")
    r = subprocess.run([exe, inp, out], capture_output=True, text=True, env=env)
    if r.returncode:
        raise RuntimeError(f"{tag}: the emulated kernel failed ({r.returncode}):\n"
                           f"{r.stdout[-2000:]}{r.stderr[-6000:]}")
    raw = open(out, "rb").read()
    got, at = [], 0
    for t, cnt in outs:
        size = np.dtype(t).itemsize * cnt
        got.append(np.frombuffer(raw[at:at + size], t))
        at += size
    if at != len(raw):
        raise RuntimeError(f"{tag}: {len(raw)} output bytes, not {at}")
    return got, r.stdout.strip()


def same(tag, names, got, want, shapes) -> None:
    """Each output of ``got`` (numpy) bit for bit against ``want`` (torch)."""
    for name, g, w, shape in zip(names, got, want, shapes):
        w = w.numpy()
        g = g.reshape(shape)
        if g.dtype != w.dtype or g.tobytes() != w.tobytes():
            at = np.argwhere(g.view(f"u{g.itemsize}") != w.view(f"u{w.itemsize}"))
            first = tuple(at[0]) if len(at) else ()
            raise AssertionError(f"{tag} {name}: not the plain version's bits (first "
                                 f"at {first}: {g[first]!r} against {w[first]!r}; "
                                 f"{len(at)} values)")


def peakdet_case(exe, build_dir, dt) -> str:
    import chip_smoke as cs
    from dspeed_tpu_torch.processors import _cuda

    w, pars = cs.peakdet_edge_rows(PEAK_N)
    w = w.astype(dt)
    pars = [p.astype(dt) for p in pars]
    B, m = len(w), PEAK_SLOTS
    counts = []
    for stride, off, reverse in PEAK_LAYOUTS:
        tag = f"peakdet_{np.dtype(dt).name}_{stride}_{reverse}"
        got, _ = run(exe, build_dir, tag, 0, w, stride, off, [m, m, reverse], pars,
                     [(dt, B * m), (dt, B * m), (np.int32, B), (np.int32, B)])
        want = _cuda.peakdet_scan_plain(torch.from_numpy(w), *map(torch.from_numpy, pars),
                                        m, m, bool(reverse))
        same(tag, ("vt_max", "vt_min", "n_max", "n_min"), got, want,
             ((B, m), (B, m), (B,), (B,)))
        counts.append(int(got[2].sum() + got[3].sum()))
    return (f"{B} rows x {PEAK_N}, both directions, at strides {PEAK_N} and "
            f"{PEAK_N + 5}: bit for bit ({counts} extrema declared)")


def bilevel_case(exe, build_dir, dt) -> str:
    import chip_smoke as cs
    from dspeed_tpu_torch.processors import _cuda

    w0, (pos, neg), (gate, start) = cs.bilevel_edge_rows(BILEVEL_LAYOUTS[0][0])
    pos, neg = pos.astype(dt), neg.astype(dt)
    B = len(w0)
    plain = {}  # by width, at the most slots (the first m of them are m's)
    out = []
    for n, stride, off, m in BILEVEL_LAYOUTS:
        w = w0[:, :n].astype(dt)
        tag = f"bilevel_{np.dtype(dt).name}_{n}_{stride}_{off}"
        got, info = run(exe, build_dir, tag, 1, w, stride, off, [m, 0, 0],
                        [pos, neg, gate, start],
                        [(np.int32, B), (dt, B * m), (dt, B * m)])
        if n not in plain:
            plain[n] = _cuda.bilevel_scan_plain(
                torch.from_numpy(w), torch.from_numpy(pos), torch.from_numpy(neg),
                torch.from_numpy(gate), torch.from_numpy(start),
                max(q[3] for q in BILEVEL_LAYOUTS))
        nc, pol, trig = plain[n]
        same(tag, ("n_crossings", "polarity", "trigger"), got,
             (nc, pol[:, :m].contiguous(), trig[:, :m].contiguous()), ((B,), (B, m), (B, m)))
        out.append(f"n {n} stride {stride} offset {off} m {m} ({info}, "
                   f"{int(got[0].sum())} triggers, {int((got[0] > m).sum())} rows past "
                   f"their slots)")
    return f"{B} rows: bit for bit at " + "; ".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=MODES, default="asan")
    ap.add_argument("--build", default=os.path.join(HERE, "build"))
    ap.add_argument("cases", nargs="*", default=list(CASES))
    args = ap.parse_args(argv)
    exe = build(args.mode, args.build)
    bad = 0
    for label in args.cases:
        kernel, dt = label.split("_")
        try:
            fn = peakdet_case if kernel == "peakdet" else bilevel_case
            msg = fn(exe, args.build, np.float32 if dt == "f32" else np.float64)
        except (AssertionError, RuntimeError) as e:
            bad += 1
            msg = f"FAILED: {e}"
        print(f"{label} [{args.mode}]: {msg}", flush=True)
    print("FAILED" if bad else "OK")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
