"""Run K7 (``dspeed_tpu_torch/csrc/generic_rows.cu``) on the CPU, one thread
per CUDA thread, and hold every output against the plain walk.

The kernel's source is turned into host C++ by text (the dynamic shared
array into the block's buffer, the ``cp.async`` asm into copies that land
at the wait), compiled with ``g++`` and the shims of ``cuda_runtime.h``, and
run by ``k7_main.cpp`` on programs lowered from small chains. Three
builds, each a check the card cannot make:

- ``tsan``: ``-fsanitize=thread``. Block and warp barriers are pthread
  barriers, so two threads' accesses to shared memory with no barrier
  between them (a barrier the host's plan left out, a reduction buffer
  reused too early) are a reported race.
- ``asan``: ``-fsanitize=address``, each block given exactly the launch's
  dynamic shared bytes, so a plan that sizes a plane, the scratch or the
  tape too small fails.
- ``sites``: every thread of a block barrier, and every lane of a warp
  collective, must arrive by one call path (a collective reached from two
  branches hangs the card).

Every escape of the ``full`` lowering (every key the group writes) is held
against ``_cuda.generic_rows_plain`` by ``chip_smoke.check_generic``'s rule,
on the rows without an infinite sample, the convolution within its
tolerance (the CPU's plain convolution does not sum in ``conv_row.cuh``'s
order). ``--parent SRC`` also emulates another ``generic_rows.cu`` of the
same tape layout (a ``git archive`` of an earlier commit) and holds every
escape bit for bit against it.

    python3 tools/k7_emu/run_k7_emu.py [--mode tsan|asan|sites] [--rows N]
        [--parent SRC] [--build DIR] [case ...]

Cases: ``reductions`` (reductions back to back), ``ops256`` and ``ops1001``
(the small op chain at 256 and 1001 samples, rows 4 bytes off 16-byte
alignment included), ``flagship`` (the generic flagship's two groups),
``sipm`` (the SiPM chain's group, ``reflected_convolve_wf`` and
``avg_current`` in float64, on ``chip_smoke.sipm_edge_rows``: every escape
bit for bit against the plain walk, the row with an infinite sample too).
"""

import argparse
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
for p in (REPO, os.path.join(REPO, "tests")):
    if p not in sys.path:
        sys.path.insert(0, p)

import numpy as np  # noqa: E402
import torch  # noqa: E402

SRC = os.path.join(REPO, "dspeed_tpu_torch", "csrc", "generic_rows.cu")
CASES = ("reductions", "ops256", "ops1001", "flagship", "sipm")
FLAGS = {
    "tsan": ["-fsanitize=thread", "-O1"],
    "asan": ["-fsanitize=address", "-O1"],
    "sites": ["-O0", "-fno-omit-frame-pointer", "-DEMU_SITES"],
}


K7_CUTS = ("static cudaError_t gen_launch", 'extern "C" int dspeed_generic_rows')


def host_source(src: str, out: str, cuts=K7_CUTS) -> str:
    """``src`` as host C++ up to its host-side launch code (the first of
    ``cuts`` found), into ``out``."""
    text = open(src).read()
    text = re.sub(
        r"extern __shared__\s+(?:__align__\(\d+\)\s+)?(\w+)\s+(\w+)\[\];",
        r"\n#define \2 ((\1*)emu_blk->smem)\n", text)
    text = re.sub(
        r'const unsigned d = \(unsigned\)__cvta_generic_to_shared\(dst\);\s*'
        r'asm volatile\("cp\.async\.c[ga]\.shared\.global \[%0\], \[%1\], '
        r'(\d+);\\n" ::"r"\(d\),\s*"l"\(src\)\s*: "memory"\);',
        r"emu_cp_async(dst, src, \1);", text)
    text = text.replace('asm volatile("cp.async.wait_all;\\n" ::: "memory");',
                        "emu_cp_wait_all();")
    if "asm" in text:
        raise SystemExit(f"{src}: an asm statement the emulation does not rewrite")
    cut = min(i for i in (text.find(c) for c in cuts) if i >= 0)
    with open(out, "w") as f:
        f.write(text[:cut])
    return out


def build(src: str, mode: str, build_dir: str, tag: str = "k7",
          main: str = os.path.join(HERE, "k7_main.cpp"), cuts=K7_CUTS) -> str:
    """The emulation of ``src`` built for ``mode`` with the host program
    ``main``; returns the executable."""
    os.makedirs(build_dir, exist_ok=True)
    exe = os.path.join(build_dir, f"{tag}_{mode}")
    inc = host_source(src, os.path.join(build_dir, f"{tag}.inc"), cuts)
    cmd = ["g++", "-std=c++17", "-g", "-ffp-contract=off", "-pthread",
           *FLAGS[mode], f"-I{HERE}", f"-I{os.path.dirname(src)}",
           f'-DKSRC="{inc}"', "-o", exe, main]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"g++ failed for {src} ({mode}):\n{r.stderr[-4000:]}")
    return exe


def write_input(path, prog, vals, misalign=0) -> None:
    """The tape, its plan, the inputs (each row ``misalign`` floats past
    16-byte alignment) and the escapes' sizes, as ``k7_main.cpp`` reads
    them. Shared memory starts filled with 0x7f bytes (each float a NaN), so
    that a read of what no thread wrote shows in the outputs."""
    fill = 0x7F
    ints, dbls, taps = prog.encode()
    B = int(vals[prog.ext_keys[0]].shape[0])
    with open(path, "wb") as f:
        hdr = [len(ints), len(dbls), len(taps), B, len(prog.ops),
               len(prog.slots), prog.n_scal, prog.scratch_dbl,
               prog.arena_floats, prog.smem_bytes, len(prog.ext_keys),
               len(prog.esc_roots), fill, prog.tape_dbl]
        f.write(np.asarray(hdr, np.int32).tobytes())
        f.write(ints.astype(np.int32).tobytes())
        f.write(dbls.astype(np.float64).tobytes())
        f.write(taps.astype(np.float32).tobytes())
        for key in prog.ext_keys:
            v = vals[key]
            if v.ndim == 2:
                stride = v.stride(0)
                data = np.zeros(B * stride, np.float32)
                a = v.numpy()
                for r in range(B):
                    data[r * stride : r * stride + a.shape[1]] = a[r]
                kind = 0
            else:
                stride = 1
                f64 = v.dtype == torch.float64
                kind = 2 if f64 else 1
                data = v.numpy().astype(np.float64 if f64 else np.float32)
            f.write(np.asarray([kind, misalign], np.int32).tobytes())
            f.write(np.asarray([data.size, stride], np.int64).tobytes())
            f.write(data.tobytes())
        for sid in prog.esc_roots:
            s = prog.slots[sid]
            n = B * (s.length if s.kind == "plane" else 1)
            f.write(np.asarray([s.dtype.itemsize], np.int32).tobytes())
            f.write(np.asarray([n], np.int64).tobytes())


def read_output(path, prog, B) -> dict:
    raw = open(path, "rb").read()
    pos, roots = 0, {}
    for sid in prog.esc_roots:
        s = prog.slots[sid]
        n = B * (s.length if s.kind == "plane" else 1)
        dt = np.float64 if s.dtype == torch.float64 else np.float32
        a = np.frombuffer(raw, dt, n, pos).copy()
        pos += n * a.itemsize
        roots[sid] = torch.from_numpy(a.reshape(B, -1) if s.kind == "plane" else a)
    return roots


def run(exe, prog, vals, build_dir, tag, misalign=0) -> dict:
    """The emulated kernel's escapes (env key -> tensor) on ``vals``."""
    from dspeed_tpu_torch.processors import _cuda

    inp = os.path.join(build_dir, f"{tag}.in")
    out = os.path.join(build_dir, f"{tag}.out")
    write_input(inp, prog, vals, misalign)
    env = dict(os.environ, TSAN_OPTIONS="halt_on_error=1 report_signal_unsafe=0",
               ASAN_OPTIONS="detect_leaks=0")
    r = subprocess.run([exe, inp, out], capture_output=True, text=True, env=env)
    if r.returncode:
        raise RuntimeError(f"{tag}: the emulated kernel failed ({r.returncode}):\n"
                           f"{r.stdout[-2000:]}{r.stderr[-6000:]}")
    B = int(vals[prog.ext_keys[0]].shape[0])
    roots = read_output(out, prog, B)
    roots.update({prog.by_key[k]: vals[k] for k in prog.ext_keys})
    return _cuda._escape_values(prog, roots)


def chain_groups(cfg, wf, bl, db=None, fuse="generic") -> list:
    """``[(program, full program, vals)]`` for each generic group of
    ``cfg`` on ``(wf, bl)`` (no baseline column where ``bl`` is None);
    ``full`` stores every key the group writes."""
    from dspeed_tpu_torch import lh5
    from dspeed_tpu_torch.processing_chain import GroupStep, build_processing_chain
    from dspeed_tpu_torch.processors import _cuda
    from dspeed_tpu_torch.processors._tile_program import lower

    cols = {"waveform": lh5.WaveformTable(values=wf, t0=0.0, t0_units="ns",
                                          dt=16.0, dt_units="ns")}
    if bl is not None:
        cols["baseline"] = lh5.Array(bl.astype(np.float32))
    chain, _, _ = build_processing_chain(cfg, lh5.Table(cols), db_dict=db,
                                         device="cpu", fuse=fuse)
    inputs, _ = chain._gather_inputs(0, len(wf))
    env = chain._to_device(inputs)
    env.update(chain._const_env())
    out = []
    for step in chain._steps:
        if not isinstance(step, GroupStep):
            step.run(env)
            continue
        vals = {k: env[k] for k in step.ext_in}
        prog = lower(step.members, vals, step.escapes)
        every = sorted(s.key for s in prog.slots if not s.ext)
        out.append((prog, lower(step.members, vals, every), vals))
        env.update(_cuda.generic_rows_plain(prog, vals))
    return out


def cases(names, rows=6):
    """``(label, program, full program, vals)`` for each case of ``names``."""
    import chip_smoke as cs
    from test_torch_generic import OPS_CONFIG, RED_CONFIG, _events

    if "reductions" in names:
        wf, bl = _events(n=max(rows, 8), nsamp=256, seed=3)
        for prog, full, vals in chain_groups(RED_CONFIG, wf[:rows], bl[:rows]):
            yield "reductions", prog, full, vals
    for nsamp in (256, 1001):
        if f"ops{nsamp}" not in names:
            continue
        wf, bl = _events(n=max(rows, 8), nsamp=nsamp, seed=5)
        wf[min(6, rows - 1), nsamp * 3 // 4 :] = wf[min(6, rows - 1), nsamp * 3 // 4 - 1]
        wf[0, 0] = np.nan
        wf[1 % rows, -1] = np.nan
        for prog, full, vals in chain_groups(OPS_CONFIG, wf[:rows], bl[:rows]):
            yield f"ops{nsamp}", prog, full, vals
    if "flagship" in names:
        wf, _amp, _t0, bl, _rt = cs.make_hpge_waveforms(rows)
        wf[3 % rows, 500] = np.nan
        bl[min(5, rows - 1)] = np.nan
        if rows > 4:
            wf[4, 2000] = np.inf
            wf[2, :] = wf[2, 0]  # flat: the searches find nothing
        groups = chain_groups(cs.config(), wf, bl, {"pz": {"tau": cs.TAU}})
        for lab, (prog, full, vals) in zip("AB", groups):
            yield f"flagship {lab}", prog, full, vals
    if "sipm" in names:
        wf, _ = cs.make_sipm_waveforms(max(rows, 3))
        # the SiPM chain's default mode forms its group
        for prog, full, vals in chain_groups(cs.sipm_config(),
                                             cs.sipm_edge_rows(wf)[:rows],
                                             None, fuse=True):
            yield "sipm", prog, full, vals


def _same(a, b):
    return (a == b) | (torch.isnan(a) & torch.isnan(b))


def check(label, prog, vals, got, parent=None) -> str:
    """``got`` (the ``full`` program's escapes) against the plain walk on
    the rows without an infinite sample, and bit for bit against
    ``parent`` where given; raises AssertionError, or returns a summary."""
    import chip_smoke as cs
    from dspeed_tpu_torch.processors import _cuda

    B = int(vals[prog.ext_keys[0]].shape[0])
    fin = torch.ones(B, dtype=torch.bool)
    for v in vals.values():
        if v.ndim == 2:
            fin &= ~torch.isinf(v).any(1)
    sub = {k: v[fin] for k, v in vals.items()}
    plain = _cuda.generic_rows_plain(prog, sub)
    err, rel, excused, _ = cs.check_generic(
        prog, sub, {k: v[fin] for k, v in got.items()}, plain, label)
    msg = f"vs plain: max err {err:.3e} ({rel:.2e} of scale), {excused} rows excused"
    if label == "sipm":
        # unfused products and sums in the plain walk's order: every row
        # bit for bit, the row with an infinite sample included
        plain = _cuda.generic_rows_plain(prog, vals)
        diff = [k for k in plain if not bool(_same(got[k], plain[k]).all())]
        assert not diff, f"{label}: differs from the plain walk in {diff}"
        msg += "; every row bit for bit"
    if parent is not None:
        diff = [k for k in parent if not bool(_same(got[k], parent[k]).all())]
        assert not diff, f"{label}: differs from the parent kernel in {diff}"
        msg += "; equal to the parent kernel's bit for bit"
    return msg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=sorted(FLAGS), default="tsan")
    ap.add_argument("--rows", type=int, default=6)
    ap.add_argument("--parent", help="another generic_rows.cu to hold bit for bit")
    ap.add_argument("--build", default=os.path.join(HERE, "build"))
    ap.add_argument("cases", nargs="*", default=list(CASES[:3]))
    args = ap.parse_args(argv)
    exe = build(SRC, args.mode, args.build)
    par = build(args.parent, args.mode, args.build, "parent") if args.parent else None
    bad = 0
    for label, prog, full, vals in cases(args.cases, args.rows):
        for mis in (0, 1):
            tag = f"{label.replace(' ', '_')}_{mis}"
            try:
                run(exe, prog, vals, args.build, tag + "_chain", mis)
                got = run(exe, full, vals, args.build, tag + "_full", mis)
                want = run(par, full, vals, args.build, tag + "_parent", mis) if par else None
                msg = check(label, full, vals, got, want)
            except (AssertionError, RuntimeError) as e:
                bad += 1
                msg = f"FAILED: {e}"
            print(f"{label} [{args.mode}, rows {mis} floats off alignment] "
                  f"{len(full.ops)} ops, {sum(o.plan for o in full.ops)} planned "
                  f"barriers: {msg}", flush=True)
    print("FAILED" if bad else "OK")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
