#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's hand-written CUDA kernels from ``dspeed_tpu_torch/csrc``
(K1 energy front, K2 rise-time cascade, K3 t0 front with its absorbed A/E
current, K4 convolution bank, K5 and K6 the A/E current front's polyphase
and up-domain routes, K7 the generic fusion groups' row-tape interpreter,
and the SiPM peak finder's sweep, which replaces a ``lax.scan``),
holds each against its plain PyTorch version on the card at the main
path's shapes (16384 events x 4096 samples, the 16384 x 300 current, and
the generic flagship's two groups, NaN rows included), times kernel, plain
version and a library yardstick with CUDA events, then drives the main
paths: ``build_dsp`` over 16384 synthetic HPGe events with the **flagship
configuration** (``configs/hpge-energy-timing.yaml``, all 34 outputs) fused
by the hand patterns, the same with its A/E window at 128 upsampled samples
(**flagship L128**: no polyphase plan, so the current front runs K6) and in
the **generic mode** (``fuse="generic"``: two K7 launches and the CUSP/ZAC
K4 route), the **timing configuration** (without
its three A/E columns, 31 outputs) and the **energy configuration** (its 17
energy and baseline columns), file -> file where ``h5py`` is installed,
else Table -> Table, each twice: the second call must take its chain from
the chain cache. It checks the physics
(``trapEmax`` against the injected amplitudes, ``tp_0_est`` against the
injected start, the order of the cascade, ``A_max`` against amplitude over
rise time and ``tp_aoe_samp`` inside the rise), the first 256 events
against the port's own CPU run, and that every kernel of each path was
launched on it. Then the **flagship pipeline**: four chunks of 16384
distinct events through ``build_dsp``'s production loop (read-ahead,
staging on the copy stream, write-behind), every output of every chunk
held bit for bit against the synchronous call of the same chain, with the
host waits one pipelined chunk makes; and ``buffer_len="auto"``'s pick.
Then the **SiPM path** (``configs/sipm-pulse-finding.yaml``, 16384 events x
1024 samples, VectorOfVectors outputs): K7 on its group and the sweep on
its current, each bit for bit against its plain version, ``build_dsp``
twice (a chain-cache hit) with the pulse count held against the JAX
package's, the first 256 events against the port's CPU run, and two chunks
through the production loop against the synchronous calls.

Prints the card's name and power limit, one JSON line of kernel figures
(``{"kernels": [...]}``), and as the last line
``{"ok": true, "device": {...}}``. Any failed check exits non-zero. Needs
CUDA; imports nothing of the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, "configs", "hpge-energy-timing.yaml")
ENERGY_OUTPUTS = [
    "tp_min", "tp_max", "wf_min", "wf_max", "bl_mean", "bl_std", "bl_slope",
    "bl_intercept", "pz_mean", "pz_std", "pz_slope", "trapTmax", "trapEmax",
    "cuspEmax", "cuspEftp", "zacEmax", "zacEftp",
]
AOE_OUTPUTS = ("A_max", "tp_aoe_max", "tp_aoe_samp")
CASCADE = ["tp_100", "tp_99", "tp_95", "tp_90", "tp_80", "tp_50", "tp_20",
           "tp_10", "tp_01"]
# the flagship's cascade (tp_chain links): thresholds factor * trapTmax,
# walk forward (1) or back (0), start from tp_0_est (-1) or an earlier link
CASCADE_FACTORS = [1, 0.99, 0.95, 0.9, 0.8, 0.5, 0.2, 0.1, 0.01]
CASCADE_DIRS = [1, 1, 0, 0, 0, 0, 0, 0, 0]
CASCADE_STARTS = [-1, -1, 1, 2, 3, 4, 5, 6, 7]
# columns that read tp_0_est: excused on an event whose tp_0_est moved by
# one sample because two f32 convolutions rounded differently
READS_TP0 = ("trapEftp", "QDrift", "dt_eff", "tp_0_atrap", *CASCADE, *AOE_OUTPUTS)
# the flagship's A/E branch: wf_le = windower(wf_pz, tp_0_est, 301), curr =
# avg_current(wf_le, 1) of 300 samples, upsampled x16 to 4784 samples and
# averaged by 3 alternating 48-sample windows
CURR_SPEC = (301, 1, 300)
AOE_GEOMETRY = (16, 8, 4784, 48, 3, 0)  # ratio, half, n_up, L, num, mtype
AOE_NEED = (False, True, False, True)  # the chain reads tp_aoe_max, A_max
# the same front with a 128-sample (128 ns) A/E smoothing window, which the
# polyphase plan rejects (L >= W / 2): the flagship L128 path takes K6
AOE_L128_GEOMETRY = (16, 8, 4784, 128, 3, 0)
# no moving-window stage: the curve is the upsampled current itself
NO_STAGE_GEOMETRY = (16, 8, 4784, 48, 0, 0)
PIPELINE_CHUNKS = 4  # chunks of N_EVENTS through the production loop
# median A_max * rt / amp on events with amp / rt > 50 (aoe_checks): the JAX
# package's value on this generator, x64 on a CPU (L = 48: 1.010; L = 128:
# 1.0037 over 8192 events, 1.0038 over 2048), held within 2%
AOE_RATIO = {48: 1.010, 128: 1.0037}
# the current front's tolerances, of the column scale: the polyphase kernel
# against its plain formulation and against the up-domain plain version
# (test_pallas.py:333), the up-domain kernel against its plain version
K5_REL, K5_UP_REL, K6_REL = 1e-5, 2e-5, 1e-6
TAU = 27460.5
DT = 16.0  # ns per sample
N_EVENTS = 16384
N_SAMPLES = 4096
REL_TOL = 1e-5  # |kernel - plain| <= REL_TOL * max|plain| per output column
NAN_SAMPLE_ROW = 3  # end-to-end input: this event holds a NaN sample
NAN_BASELINE_ROW = 5  # and this one a NaN baseline
ATRAP = ("asym", 8, 4, 125)  # the flagship's wf_atrap (128 ns, 4, 2 us)
# H100 SXM peaks (NVIDIA data sheet): HBM3, f32 and f64 outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
PEAK_F64_S = 34e12
DEVICE = "cuda"
SIPM_CONFIG = os.path.join(REPO, "configs", "sipm-pulse-finding.yaml")
SIPM_SAMPLES = 1024  # the SiPM chain's record length (bench.py:73)
FULL_SLOT_ROW, NAN_FWHM_ROW = 3, 4  # rows the SiPM sweep's checks set apart


def make_hpge_waveforms(n, nsamp=N_SAMPLES, seed=11, dt=16.0):
    """Synthetic HPGe pulses: flat baseline, linear rise over ``rt`` samples
    at ``t0``, then exponential decay with tau=27460.5 samples (the
    generator ``make_hpge_waveforms`` of ``tests/test_build_dsp.py``).
    Returns ``(wf, amp, t0, bl, rt)``."""
    rng = np.random.default_rng(seed)
    amp = rng.uniform(500, 30000, n)
    t0 = rng.integers(950, 1050, n)
    rt = rng.integers(40, 150, n)
    bl = rng.uniform(14000, 16000, n)
    t = np.arange(nsamp)[None, :]
    rise = np.clip((t - t0[:, None]) / rt[:, None], 0, 1)
    decay = np.where(
        t > t0[:, None] + rt[:, None],
        np.exp(-(t - t0[:, None] - rt[:, None]) / TAU),
        1.0,
    )
    wf = bl[:, None] + amp[:, None] * rise * decay
    wf += rng.normal(0, 3, (n, nsamp))
    return wf.astype("float32"), amp, t0, bl, rt


def make_sipm_waveforms(n, nsamp=SIPM_SAMPLES, seed=3):
    """Synthetic SiPM events: unit noise plus Poisson(2) fast pulses of
    amplitude U(20, 200) (the generator ``_build_sipm_inputs`` of
    ``bench.py``). Returns ``(wf, n_pulses)``."""
    rng = np.random.default_rng(seed)
    t = np.arange(nsamp)[None, :]
    wf = rng.normal(0.0, 1.0, (n, nsamp))
    n_pulse = rng.poisson(2.0, n)
    for i in range(n):
        for t0 in rng.uniform(50, nsamp - 50, n_pulse[i]):
            a = rng.uniform(20, 200)
            wf[i] += a * np.exp(-np.abs(t[0] - t0) / np.where(t[0] > t0, 80, 3))
    return wf.astype("float32"), n_pulse


def sipm_edge_rows(wf):
    """``wf`` with its first rows made into the SiPM group's edge cases: a
    NaN sample (row 0), an infinite sample (row 1), the row's maximum and
    minimum in the samples the reflected pad copies (row 2: samples 1 and
    n - 2), and a sine of period 40 samples (row ``FULL_SLOT_ROW``: more
    maxima than the peak finder's 20 slots)."""
    wf = wf.copy()
    wf[0, 300] = np.nan
    wf[1, 700] = np.inf
    hi, lo = np.abs(wf[2]).max() + 50, -np.abs(wf[2]).max() - 50
    wf[2, 1], wf[2, -2] = hi, lo
    i = np.arange(wf.shape[1])
    wf[FULL_SLOT_ROW] += (100 * np.sin(2 * np.pi * i / 40)).astype(np.float32)
    return wf


def sipm_config() -> dict:
    import yaml

    with open(SIPM_CONFIG) as f:
        return yaml.safe_load(f)


def config(outputs=None) -> dict:
    """The flagship YAML, with its outputs cut to ``outputs`` if given."""
    import yaml

    with open(CONFIG) as f:
        cfg = yaml.safe_load(f)
    if outputs is not None:
        cfg["outputs"] = list(outputs)
    return cfg


def l128_config() -> dict:
    """The flagship with its A/E smoothing window (``curr_av``) at 128
    upsampled samples instead of 48; the YAML file is not changed."""
    cfg = config()
    cfg["processors"]["curr_av"]["args"][1] = "128"
    return cfg


def timing_config() -> dict:
    """Every column of the flagship but the A/E ones."""
    return config([o for o in config()["outputs"] if o not in AOE_OUTPUTS])


def energy_config() -> dict:
    return config(ENERGY_OUTPUTS)


def is_index(col: str) -> bool:
    return col.startswith("tp_")


class Chunks:
    """An in-memory source of ``Table`` chunks, read as an ``LH5Iterator``
    is: while a chunk is consumed, ``current_i_entry`` holds its first
    entry."""

    def __init__(self, tables):
        self.tables = tables
        self.current_i_entry = 0

    def __iter__(self):
        i = 0
        for tb in self.tables:
            self.current_i_entry = i
            yield tb
            i += len(tb)


def distinct_chunks(lh5, wf, bl, n_chunks, offset=1237):
    """``n_chunks`` tables of all the events of ``wf`` and ``bl`` (no
    baseline column where ``bl`` is None), chunk k
    rolled by ``k * offset`` rows: no two chunks hold the same event at the
    same row, so a chunk written at the wrong place, or a pinned staging
    buffer refilled too early, shows in the outputs."""
    tables = []
    for k in range(n_chunks):
        w = np.ascontiguousarray(np.roll(wf, -k * offset, axis=0))
        cols = {"waveform": lh5.WaveformTable(
            values=w, t0=0.0, t0_units="ns", dt=DT, dt_units="ns")}
        if bl is not None:
            cols["baseline"] = lh5.Array(np.roll(bl, -k * offset).astype(np.float32))
        tables.append(lh5.Table(cols))
    return tables


def run_pipeline(build_dsp, chain, tb_out, tables):
    """Every chunk of ``tables`` through ``build_dsp``'s production loop
    (``_process_chunks``: read-ahead and staging on a worker thread and the
    device's copy stream, each chunk's fetch and write on the writer thread
    while the next one computes). Returns each chunk's outputs, copied from
    ``tb_out`` as the writer saw them (by first entry), the loop's timing
    split and its wall seconds."""
    driver = sys.modules[build_dsp.__module__]
    got = {}

    def write(n, i_entry):
        got[i_entry] = {k: column_arrays(col, n) for k, col in tb_out.items()}

    t_0 = time.time()
    split = driver._process_chunks(chain, Chunks(tables), write, read_ahead=True)
    return got, split, time.time() - t_0


class counted_builds:
    """Counts the chains ``build_dsp`` builds while the block runs (the
    driver's ``build_processing_chain``, wrapped): 0 on a chain-cache hit."""

    def __init__(self, build_dsp):
        self.driver = sys.modules[build_dsp.__module__]
        self.n = 0

    def __enter__(self):
        self.orig = self.driver.build_processing_chain

        def build(*a, **k):
            self.n += 1
            return self.orig(*a, **k)

        self.driver.build_processing_chain = build
        return self

    def __exit__(self, *exc):
        self.driver.build_processing_chain = self.orig


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call from CUDA events around ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_ms(fn, iters: int = 40, cover_cycles: int = 60_000_000) -> float:
    """Mean device milliseconds per call from CUDA events around ``iters``
    calls that run back to back: a sleep kernel holds the stream while the
    host enqueues them, so a call whose host side is slower than its kernel
    is timed by its kernel, not by its enqueue."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(cover_cycles)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def compare(name, got, want, exact=False) -> float:
    """Max |got - want| over one output, after checking NaN positions agree
    and the difference is within REL_TOL of the column scale (exact for
    index outputs). Returns the max absolute error."""
    import torch

    g = got.double()
    w = want.double()
    gn, wn = torch.isnan(g), torch.isnan(w)
    if not torch.equal(gn, wn):
        raise AssertionError(
            f"{name}: NaN positions differ ({int((gn ^ wn).sum())} entries)"
        )
    ok = ~wn
    err = float((g[ok] - w[ok]).abs().max()) if ok.any() else 0.0
    scale = float(w[ok].abs().max()) if ok.any() else 0.0
    limit = 0.0 if exact else REL_TOL * scale
    if err > limit:
        raise AssertionError(
            f"{name}: max |kernel - plain| = {err:.3e} > {limit:.3e}"
        )
    return err


def check_masks(name, got, want, trap, a) -> None:
    """Crossing-mask bits must agree wherever the trap sits more than
    REL_TOL * scale from the threshold at the sample and its neighbours."""
    import torch

    tol = REL_TOL * float(trap[~torch.isnan(trap)].abs().max())
    near = (trap - a[:, None]).abs() <= tol
    near = near | torch.roll(near, 1, dims=1) | torch.roll(near, -1, dims=1)
    bad = (got != want) & ~near
    if bad.any():
        raise AssertionError(f"{name}: {int(bad.sum())} mask bytes differ")


def k1_phase(_cuda, w, bl, label, trap_specs, emax_for, slope_specs,
             mask_specs, emit_blsub, emit_minmax):
    """K1 against its plain version on the card; returns its figures."""
    import torch

    kw = dict(
        trap_specs=trap_specs, emax_for=emax_for, emit_blsub=emit_blsub,
        emit_minmax=emit_minmax, slope_specs=slope_specs,
        mask_specs=mask_specs,
    )
    got = _cuda.fused_energy(w, bl, TAU, **kw)
    want = _cuda.fused_energy_plain(w, bl, TAU, **kw)
    torch.cuda.synchronize()
    names = (
        ["pz"] + [f"trap{i}" for i in range(len(trap_specs))]
        + [f"emax{i}" for i in range(len(emax_for))]
        + [f"slope{s}.{q}" for s in range(len(slope_specs)) for q in range(4)]
        + (["t_min", "t_max", "a_min", "a_max"] if emit_minmax else [])
        + (["blsub"] if emit_blsub else [])
        + [f"mask{i}" for i in range(len(mask_specs))]
    )
    flat_got = [got[0], *got[1], *got[2], *got[3:]]
    flat_want = [want[0], *want[1], *want[2], *want[3:]]
    nm = len(mask_specs)
    errs = {}
    for i, (nme, g, wv) in enumerate(zip(names, flat_got, flat_want)):
        if i >= len(names) - nm:
            sp, si, oi, _, _ = mask_specs[i - (len(names) - nm)]
            if sp in trap_specs:
                trap = flat_want[1 + list(trap_specs).index(sp)]
            else:  # a mask-only trap: the plain trapezoid of the plain pz
                from dspeed_tpu_torch.processors import asym_trap_filter

                (trap,) = asym_trap_filter(flat_want[0], *sp[1:])
            a = flat_want[1 + len(trap_specs) + len(emax_for) + 4 * si + oi]
            check_masks(f"K1 {label} {nme}", g, wv, trap, a)
            continue
        errs[nme] = compare(f"K1 {label} {nme}", g, wv,
                            exact=nme in ("t_min", "t_max"))
    max_err = max(errs.values())
    print(f"K1 [{label}] max |kernel - plain| per output: "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + (f"; {nm} mask plane(s) agree off the threshold" if nm else ""),
          flush=True)
    ms = time_ms(lambda: _cuda.fused_energy(w, bl, TAU, **kw), 20)
    plain_ms = time_ms(lambda: _cuda.fused_energy_plain(w, bl, TAU, **kw), 3, 1)
    B, n = w.shape
    planes = 1 + len(trap_specs) + emit_blsub
    scalars = len(emax_for) + 4 * len(slope_specs) + 4 * emit_minmax
    nbytes = 4 * B * n + 4 * B + 4 * B * n * planes + 4 * B * scalars + B * n * nm
    # f64: two prefix adds per sample and 4 per trap sample (a mask's trap
    # too, once per sample); f32: subtract and pole-zero multiply-add
    f64_ops = B * n * (2 + 4 * (len(trap_specs) + nm))
    f32_ops = B * n * 3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = (f64_ops / PEAK_F64_S + f32_ops / PEAK_F32_S) * 1e3
    launch = _cuda.fused_energy_launch(n)
    print(
        f"K1 fused_energy [{label}] {B}x{n}: max_abs_err {max_err:.3e}, "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{max(t_bytes, t_ops):.4f} ms ({'bytes' if t_bytes >= t_ops else 'operations'}); "
        f"{nbytes / ms / 1e6:.1f} GB/s, {t_bytes / ms:.1%} of {PEAK_BYTES_S / 1e12:.2f} TB/s; "
        f"{launch['registers']} registers and {launch['local_bytes']} local bytes a "
        f"thread, {launch['threads']} threads and {launch['smem_bytes']} bytes of "
        f"shared memory a block, {launch['blocks_per_sm']} blocks per SM; on "
        f"{card_line()}",
        flush=True,
    )
    return dict(
        max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
        bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        byte_share=t_bytes / ms, launch=launch,
    )


def ptxas_report(log: str, kernel: str) -> dict:
    """``ptxas -v``'s lines per instance of ``kernel`` (by its mangled
    name): registers, spill stores and loads, static shared memory."""
    report, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            name = line.split("'")[1] if "'" in line else line.split()[-1]
            if kernel not in name:
                name = None
        elif name is not None and ("spill" in line or "registers" in line):
            report.setdefault(name, []).append(line.split(":", 1)[-1].strip())
    return {k: "; ".join(v) for k, v in report.items()}


def k4_phase(_cuda, w, kerns, lo, p, n_in, label, ptxas_log):
    """K4 against its plain version and torch's conv1d on the card."""
    import torch
    import torch.nn.functional as F

    got = _cuda.banded_conv_multi(w, kerns, lo, p, n_in=n_in)
    want = _cuda.banded_conv_plain(w, kerns, lo, p, n_in=n_in)
    torch.cuda.synchronize()
    max_err = max(
        compare(f"K4 {label} out{j}", g, wv)
        for j, (g, wv) in enumerate(zip(got, want))
    )
    # both against an f64 evaluation of the same sums, for the record
    ref = _cuda.banded_conv_plain(w.double(), kerns, lo, p, n_in=n_in)
    for j, r in enumerate(ref):
        ok = ~torch.isnan(r)
        print(
            f"K4 {label} out{j}: max |kernel - f64| "
            f"{float((got[j].double() - r)[ok].abs().max()):.3e}, max |plain - "
            f"f64| {float((want[j].double() - r)[ok].abs().max()):.3e}, max|f64| "
            f"{float(r[ok].abs().max()):.3e}",
            flush=True,
        )
    m = kerns[0].shape[-1]
    n = w.shape[-1] if n_in is None else n_in
    ms = time_ms(lambda: _cuda.banded_conv_multi(w, kerns, lo, p, n_in=n_in), 20)
    plain_ms = time_ms(
        lambda: _cuda.banded_conv_plain(w, kerns, lo, p, n_in=n_in), 5
    )
    # yardstick: one cuDNN call (TF32 off) computing the same windows as a
    # cross-correlation with the flipped taps
    weight = torch.from_numpy(
        np.ascontiguousarray(np.stack(kerns)[:, None, ::-1].astype(np.float32))
    ).to(w.device)
    x = w[:, None, :n]
    pad = max(0, m - 1 - lo)

    def lib():
        out = F.conv1d(x, weight, padding=pad)
        return out[..., lo - (m - 1) + pad : lo - (m - 1) + pad + p]

    lib_out = lib()
    lib_err = max(
        float((lib_out[:, j] - want[j]).abs().nan_to_num(0.0).max())
        / float(want[j].abs().nan_to_num(0.0).max())
        for j in range(len(kerns))
    )
    library_ms = time_ms(lib, 5)
    B = w.shape[0]
    nk = len(kerns)
    nbytes = 4 * B * n + 4 * nk * m + 4 * B * nk * p
    ops = 2 * nk * p * m * B
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_F32_S * 1e3
    bound = max(t_bytes, t_ops)
    launch = _cuda.banded_conv_launch(B, m, nk, p)
    instance = f"banded_conv_kernelILi{nk}E"
    ptxas = list(ptxas_report(ptxas_log, instance).values())
    if not ptxas:
        raise AssertionError(f"K4 [{label}]: no ptxas report for {instance}")
    print(
        f"K4 banded_conv_multi [{label}] {B}x{n} nk={nk} m={m} p={p} "
        f"lo={lo}: max_abs_err {max_err:.3e}, kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, conv1d {library_ms:.4f} ms (max |conv1d - "
        f"plain| / max|plain| {lib_err:.3e}), bound {bound:.4f} ms "
        f"({'bytes' if t_bytes >= t_ops else 'operations'}), {bound / ms:.1%} "
        f"of the bound; {launch['outputs_per_thread']} outputs a thread, "
        f"{launch['threads']} threads, {launch['rows_per_block']} row(s), "
        f"{launch['segments']} segment(s) a row and {launch['smem_bytes']} "
        f"bytes of shared memory a block, {launch['blocks_per_sm']} blocks "
        f"per SM, {launch['blocks']} blocks, {launch['registers']} registers and "
        f"{launch['local_bytes']} local bytes a thread; ptxas for {instance}: "
        f"{' | '.join(ptxas)}; on {card_line()}",
        flush=True,
    )
    return dict(
        max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=library_ms, bound_share=bound / ms, launch=launch,
        ptxas=ptxas,
    )


def index_mismatches(name, got, want, near) -> int:
    """Rows where an index output differs between kernel and plain version
    (NaN against a value counts as a difference); each must be excused by
    ``near(row, got_value, want_value)``. Returns the number excused."""
    g = got.double().cpu().numpy()
    w = want.double().cpu().numpy()
    diff = np.flatnonzero(~((g == w) | (np.isnan(g) & np.isnan(w))))
    bad = [int(r) for r in diff if not near(int(r), g[r], w[r])]
    if bad:
        raise AssertionError(
            f"{name}: {len(bad)} rows differ off a tie or threshold, e.g. "
            f"row {bad[0]}: kernel {g[bad[0]]}, plain {w[bad[0]]}"
        )
    return len(diff)


def near_crossing(plane, a, idxs) -> bool:
    """True when the plane sits within REL_TOL of its row's scale from the
    threshold ``a`` at a sample next to one of the crossing indices
    ``idxs`` (check_masks' rule for a search)."""
    row = plane[np.isfinite(plane)]
    if not np.isfinite(a) or row.size == 0:
        return False
    tol = REL_TOL * np.abs(row).max()
    for i in idxs:
        if not np.isfinite(i):
            continue
        lo, hi = max(int(i) - 1, 0), min(int(i) + 2, plane.size)
        if (np.abs(plane[lo:hi] - a) <= tol).any():
            return True
    return False


def k3_phase(_cuda, w, taps, a, label, ptxas_log, atrap_spec=None,
             curr_spec=None):
    """K3 against its plain version on the card (rows of ``w`` with a NaN
    and a NaN threshold included); with ``curr_spec`` the absorbed current
    must equal the plain version's bit for bit, NaN positions included, on
    every row where tp_0 agrees. Returns K3's outputs and its figures, with
    its launch and ``ptxas -v``'s report for ``fused_t0_kernel``."""
    import torch

    from dspeed_tpu_torch.processors.trap_filters import asym_trap_filter

    kw = dict(atrap_spec=atrap_spec, curr_spec=curr_spec)
    outs = _cuda.fused_t0(w, taps, a, **kw)
    want = list(_cuda.fused_t0_plain(w, taps, a, **kw))
    torch.cuda.synchronize()
    got = list(outs)
    if curr_spec is not None:
        curr_got, curr_want = got.pop(5), want.pop(5)
    B, n = w.shape
    m = taps.shape[-1]
    # the filtered rows, for the tie and threshold rule (K4's 's' window,
    # the plain version's own convolution on the card)
    c = _cuda.banded_conv_multi(w, [taps], (m - 1) // 2, n)[0].cpu().numpy()
    av = a.cpu().numpy()
    tol_c = REL_TOL * np.nanmax(np.abs(c))
    errs = {q: compare(f"K3 {label} {q}", got[i], want[i])
            for i, q in ((2, "a_min"), (3, "a_max"))}

    def tie(r, gi, wi):
        return (np.isfinite(gi) and np.isfinite(wi)
                and abs(c[r, int(gi)] - c[r, int(wi)]) <= tol_c)

    ex_min = index_mismatches(f"K3 {label} t_min", got[0], want[0], tie)
    ex_max = set()

    def tie_max(r, gi, wi):
        ok = tie(r, gi, wi)
        if ok:
            ex_max.add(r)
        return ok

    index_mismatches(f"K3 {label} t_max", got[1], want[1], tie_max)
    ex = ex_min + len(ex_max)
    ex += index_mismatches(
        f"K3 {label} tp_0", got[4], want[4],
        lambda r, gi, wi: r in ex_max or near_crossing(c[r], av[r], (gi, wi)),
    )
    if atrap_spec is not None:
        (trap,) = asym_trap_filter(w, *atrap_spec[1:])
        trap = trap.cpu().numpy()
        ex += index_mismatches(
            f"K3 {label} tp_atrap", got[5], want[5],
            lambda r, gi, wi: r in ex_max
            or near_crossing(trap[r], av[r], (gi, wi)),
        )
    if curr_spec is not None:
        rows = (got[4] == want[4]) | (torch.isnan(got[4]) & torch.isnan(want[4]))
        same = (curr_got == curr_want) | (torch.isnan(curr_got) & torch.isnan(curr_want))
        if not bool(same[rows].all()):
            raise AssertionError(
                f"K3 {label} curr: {int((~same[rows]).any(1).sum())} rows differ "
                f"from the plain version where tp_0 agrees"
            )
        live = int(torch.isfinite(curr_got).any(1).sum())
        print(f"K3 [{label}] curr {tuple(curr_got.shape)}: bit-identical to the "
              f"plain version on the {int(rows.sum())} rows where tp_0 agrees "
              f"(NaN included); {live} rows hold a current, {B - live} are NaN",
              flush=True)
    # a_max against an f64 evaluation of the same rows, for the record
    ref = _cuda.fused_t0_plain(w.double(), taps, a.double())[3]
    ok = ~torch.isnan(ref)
    print(
        f"K3 [{label}] a_max: max |kernel - f64| "
        f"{float((got[3].double() - ref)[ok].abs().max()):.3e}, max |plain - "
        f"f64| {float((want[3].double() - ref)[ok].abs().max()):.3e}, max|f64| "
        f"{float(ref[ok].abs().max()):.3e}; index rows excused near a tie or "
        f"the threshold: {ex}; tp_0 NaN (nothing found or NaN row) on "
        f"{int(torch.isnan(got[4]).sum())} of {B} rows",
        flush=True,
    )
    ms = time_ms(lambda: _cuda.fused_t0(w, taps, a, **kw), 20)
    plain_ms = time_ms(lambda: _cuda.fused_t0_plain(w, taps, a, **kw), 3, 1)
    nout = 5 + (atrap_spec is not None)
    n_curr = curr_spec[2] if curr_spec is not None else 0
    nbytes = 4 * B * n + 4 * B + 4 * m + 4 * B * nout + 4 * B * n_curr
    f32_ops = 2 * m * n * B
    if curr_spec is not None:  # a subtract and a divide per current sample
        f32_ops += 2 * B * min(n_curr, curr_spec[0] - curr_spec[1])
    # the absorbed trap: one f64 prefix add, the short rise window summed
    # directly, the fall window differenced, two divides and a subtract
    f64_ops = B * n * (atrap_spec[1] + 5) if atrap_spec is not None else 0
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = (f32_ops / PEAK_F32_S + f64_ops / PEAK_F64_S) * 1e3
    max_err = max(errs.values())
    bound = max(t_bytes, t_ops)
    launch = _cuda.fused_t0_launch(n, m, atrap_spec is not None)
    ptxas = list(ptxas_report(ptxas_log, "fused_t0_kernel").values())
    if not ptxas:
        raise AssertionError(f"K3 [{label}]: no ptxas report for fused_t0_kernel")
    print(
        f"K3 fused_t0 [{label}] {B}x{n} m={m}: max_abs_err {max_err:.3e}, "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.4f} ms "
        f"({'bytes' if t_bytes >= t_ops else 'operations'}), {bound / ms:.1%} "
        f"of the bound; {launch['outputs_per_thread']} outputs a thread, "
        f"{launch['threads']} threads and {launch['smem_bytes']} bytes of "
        f"shared memory a block, {launch['blocks_per_sm']} blocks per SM, "
        f"{launch['registers']} registers and {launch['local_bytes']} local "
        f"bytes a thread; ptxas for fused_t0_kernel: {' | '.join(ptxas)}; on "
        f"{card_line()}",
        flush=True,
    )
    return outs, dict(
        max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        bound_share=bound / ms, launch=launch, ptxas=ptxas,
    )


def current_curve(c, geometry):
    """The plain version's upsampled, averaged rows of the current ``c``:
    the curve whose extrema the current front reports."""
    from dspeed_tpu_torch.processors import moving_window_multi, upsampler

    ratio, _half, n_up, L, num, mtype = geometry
    (up,) = upsampler(c, float(ratio), dims={"m": n_up})
    (av,) = moving_window_multi(up, float(L), float(num), np.int32(mtype))
    return av


def check_current(name, got, want, c, geometry, rel, need=(True,) * 4):
    """The current front's rule: the needed amplitudes within ``rel`` of
    their scale, NaN positions equal; a needed index equal, except on a
    near-tie: a row where the plain curve at both indices lies within that
    tolerance of its extremum. Returns (max abs amplitude error, excused
    rows)."""
    import torch

    for q in range(4):
        if need[q] and not torch.equal(torch.isnan(got[q]), torch.isnan(want[q])):
            raise AssertionError(f"{name} output {q}: NaN positions differ")
    ok = ~torch.isnan(want[3] if need[3] or need[1] else want[2])
    amps = [q for q in (2, 3) if need[q]]
    # the scale of the finite amplitudes; an infinite one (no stage) must
    # be equal, so that its difference counts 0, never inf - inf = NaN
    scale = max(
        float(want[q][ok & torch.isfinite(want[q])].abs().max()) for q in amps
    )
    tol = rel * scale
    err = max(
        float(torch.where(got[q][ok] == want[q][ok], 0.0,
                          (got[q][ok] - want[q][ok]).abs()).max())
        for q in amps
    )
    if not err <= tol:
        raise AssertionError(f"{name}: max |amplitude diff| {err:.3e} > {tol:.3e}")
    excused = 0
    for q, is_max in ((0, False), (1, True)):
        if not need[q]:
            continue
        rows = torch.nonzero(ok & (got[q] != want[q])).flatten()
        if rows.numel() == 0:
            continue
        curve = current_curve(c[rows], geometry).double()
        ext = curve.amax(1) if is_max else curve.amin(1)
        for idx in (got[q][rows], want[q][rows]):
            v = curve.gather(1, idx.long()[:, None])[:, 0]
            far = ~(((v - ext).abs() <= tol) | (v == ext))
            if bool(far.any()):
                r = int(rows[torch.nonzero(far)[0, 0]])
                raise AssertionError(
                    f"{name} {('t_min', 't_max')[q]}: row {r} differs "
                    f"({float(got[q][r])} against {float(want[q][r])}) off a near-tie"
                )
        excused += rows.numel()
    return err, excused


def current_bound(B, n_curr, n_up, L, num, need, poly_plan=None):
    """The least time for the current front on B rows: each row of the
    current read once, four scalars written; the operations its data needs.
    Float64, per cascade stage and sample: a prefix add, a difference and a
    quotient, plus a product and a sum on the L ramp samples. Float32: the
    interior's multiply-adds (polyphase route) and one comparison per
    sample for each extremum reduced."""
    sides = int(need[0] or need[2]) + int(need[1] or need[3])
    if poly_plan is None:
        f64 = num * (3 * n_up + 2 * L)
        f32 = sides * n_up
    else:
        from dspeed_tpu_torch.processors._poly_plan import W

        interior = n_up - poly_plan["EL"] - poly_plan["ERW"]
        f64 = 2 * num * (3 * W + 2 * L)
        f32 = 2 * poly_plan["nq"] * interior + sides * n_up
    t_bytes = (4 * B * n_curr + 16 * B) / PEAK_BYTES_S * 1e3
    t_ops = B * (f64 / PEAK_F64_S + f32 / PEAK_F32_S) * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def k5_phase(_cuda, c, ptxas_log):
    """K5 on the card's own current (K3's ``curr`` plane, NaN rows
    included) at the flagship geometry, against its polyphase plain
    formulation and the up-domain plain version; returns its figures, with
    its launch and ``ptxas -v``'s report for ``fused_current_poly_kernel``
    (one instance per tap bound and extrema asked for)."""
    import torch

    from dspeed_tpu_torch.processors._poly_plan import poly_plan

    g = AOE_GEOMETRY
    B, n_curr = c.shape
    plan = poly_plan(n_curr, *g)
    if plan is None:
        raise AssertionError("the flagship geometry has no polyphase plan")
    plain = _cuda.fused_current_plain(c, *g)
    ref = _cuda.fused_current_plain(c.double(), *g)  # float64 throughout
    torch.cuda.synchronize()
    figs = {}
    for need, label in ((AOE_NEED, "chain"), ((True,) * 4, "all four")):
        got = _cuda.fused_current(c, *g, need=need)
        poly = _cuda.fused_current_poly_plain(c, *g, need=need)
        torch.cuda.synchronize()
        e_poly, x_poly = check_current(f"K5 [{label}] vs polyphase plain", got,
                                       poly, c, g, K5_REL, need)
        e_up, x_up = check_current(f"K5 [{label}] vs plain", got, plain, c, g,
                                   K5_UP_REL, need)
        ok = ~torch.isnan(ref[3])
        print(
            f"K5 [{label}] need {need}: max |a_max diff| vs polyphase plain "
            f"{e_poly:.3e} ({x_poly} index rows excused as near-ties), vs "
            f"plain {e_up:.3e} ({x_up} excused); a_max max |kernel - f64| "
            f"{float((got[3].double() - ref[3])[ok].abs().max()):.3e}, max "
            f"|plain - f64| {float((plain[3].double() - ref[3])[ok].abs().max()):.3e}, "
            f"max|f64| {float(ref[3][ok].abs().max()):.3e}; NaN rows "
            f"{int((~ok).sum())}",
            flush=True,
        )
        ms = time_ms(lambda: _cuda.fused_current(c, *g, need=need), 20)
        dev_ms = device_ms(lambda: _cuda.fused_current(c, *g, need=need))
        poly_ms = time_ms(
            lambda: _cuda.fused_current_poly_plain(c, *g, need=need), 5
        )
        bound, by = current_bound(B, n_curr, g[2], g[3], g[4], need, plan)
        figs[label] = dict(ms=ms, dev_ms=dev_ms, poly_ms=poly_ms,
                           bound=bound, by=by, err=max(e_poly, e_up))
    plain_ms = time_ms(lambda: _cuda.fused_current_plain(c, *g), 5)
    launch = _cuda.fused_current_poly_launch(n_curr, g[0], g[2], plan["nq"],
                                             AOE_NEED)
    ptxas = list(ptxas_report(ptxas_log, "fused_current_poly_kernel").values())
    if not ptxas:
        raise AssertionError("K5: no ptxas report for fused_current_poly_kernel")
    for label, f in figs.items():
        print(
            f"K5 fused_current_poly [{label}] {B}x{n_curr} -> {g[2]}: kernel "
            f"{f['ms']:.4f} ms ({f['dev_ms']:.4f} ms on the device alone), "
            f"polyphase plain {f['poly_ms']:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {f['bound']:.4f} ms ({f['by']}), "
            f"{f['bound'] / f['ms']:.1%} of the bound "
            f"({f['bound'] / f['dev_ms']:.1%} on the device alone)",
            flush=True,
        )
    print(
        f"K5 launch (the chain's need): {launch['events_per_block']} events "
        f"and {launch['threads']} threads a block, {launch['smem_bytes']} bytes "
        f"of shared memory a block, {launch['blocks_per_sm']} blocks per SM, "
        f"{launch['registers']} registers and {launch['local_bytes']} local "
        f"bytes a thread; ptxas for fused_current_poly_kernel: "
        f"{' | '.join(ptxas)}; on {card_line()}",
        flush=True,
    )
    chain = figs["chain"]
    err0 = no_stage_phase("K5", _cuda.fused_current, _cuda, c,
                          "fused_current_poly", K5_UP_REL)
    return dict(
        max_abs_err=max(err0, *(f["err"] for f in figs.values())), ms=chain["ms"],
        plain_ms=plain_ms, bound_ms=chain["bound"], bound_by=chain["by"],
        polyphase_plain_ms=chain["poly_ms"], all_four_ms=figs["all four"]["ms"],
        device_ms=chain["dev_ms"], all_four_device_ms=figs["all four"]["dev_ms"],
        bound_share=chain["bound"] / chain["ms"],
        device_bound_share=chain["bound"] / chain["dev_ms"], launch=launch,
        ptxas=ptxas,
    )


def with_infinite_rows(c):
    """A copy of the current ``c`` whose rows 30 to 34 hold infinite
    samples: at the first and the last sample, inside, of both signs."""
    c = c.clone()
    n = c.shape[1]
    c[30, 0] = float("inf")
    c[31, n - 1] = float("-inf")
    c[32, n // 2] = float("inf")
    c[33, n // 2 + 1] = float("-inf")
    c[34, 100], c[34, 200] = float("inf"), float("-inf")
    return c


def check_infinite_rows(name, got, want):
    """Rows 30 to 34 (``with_infinite_rows``) are NaN on all four outputs,
    in the kernel as in the plain version."""
    import torch

    for q in range(4):
        for o, who in ((got[q], "kernel"), (want[q], "plain")):
            if not bool(torch.isnan(o[30:35]).all()):
                raise AssertionError(
                    f"{name}: output {q} of the {who} is not NaN on a row with "
                    f"an infinite sample"
                )


def no_stage_phase(name, front, _cuda, c, counter, rel):
    """The current front ``front`` at ``NO_STAGE_GEOMETRY`` on
    ``with_infinite_rows(c)``: with no stage an infinity the upsampled row
    reads is the curve's extremum, as the plain composition gives it, and
    only a NaN poisons a row; held by ``check_current``'s rule. The kernel
    ``counter`` of ``_cuda.LAUNCHES`` must launch once. Returns the max
    amplitude error."""
    import torch

    g = NO_STAGE_GEOMETRY
    c = with_infinite_rows(c)
    before = _cuda.LAUNCHES[counter]
    got = front(c, *g)
    if _cuda.LAUNCHES[counter] != before + 1:
        raise AssertionError(f"{name}: {counter} was not launched")
    want = _cuda.fused_current_plain(c, *g)
    torch.cuda.synchronize()
    nan_rows = torch.isnan(c).any(1)
    for q in range(4):
        for o, who in ((got[q], "kernel"), (want[q], "plain")):
            if not torch.equal(torch.isnan(o), nan_rows):
                raise AssertionError(f"{name}: output {q} of the {who} is NaN "
                                     "on other rows than those holding a NaN")
    if not bool(torch.isinf(want[3][[30, 32, 34]]).all()):
        raise AssertionError(f"{name}: the plain a_max is not the infinity")
    err, ex = check_current(name, got, want, c, g, rel)
    print(f"{name} {tuple(c.shape)}, no stage: rows 30-34 with infinite samples "
          f"equal to the plain version (a_max {want[3][30:35].tolist()}), "
          f"max |amplitude diff| {err:.3e} ({ex} index rows excused), NaN rows "
          f"{int(nan_rows.sum())}", flush=True)
    return err


def k6_phase(_cuda, c, ptxas_log):
    """K6 at the flagship geometry, called directly, and as the front's
    route at geometries the polyphase plan rejects (L = 128: n_up 4788 and
    n_curr 301, and the flagship L128 path's 4784 and 300); each against
    the plain version, with five rows of infinite samples (NaN on all four
    outputs). Times each through the wrapper (``time_ms``) and on the
    device alone (``device_ms``); returns its figures, with its launch and
    ``ptxas -v``'s report for ``fused_current_kernel``."""
    import torch

    from dspeed_tpu_torch.processors._poly_plan import poly_plan

    g = AOE_GEOMETRY
    c = with_infinite_rows(c)
    B, n_curr = c.shape
    got = _cuda.fused_current_updomain(c, *g)
    want = _cuda.fused_current_plain(c, *g)
    torch.cuda.synchronize()
    check_infinite_rows("K6 flagship", got, want)
    err, ex = check_current("K6 flagship vs plain", got, want, c, g, K6_REL)
    ms = time_ms(lambda: _cuda.fused_current_updomain(c, *g), 20)
    dev_ms = device_ms(lambda: _cuda.fused_current_updomain(c, *g))
    plain_ms = time_ms(lambda: _cuda.fused_current_plain(c, *g), 5)
    bound, by = current_bound(B, n_curr, g[2], g[3], g[4], (True,) * 4)
    print(
        f"K6 fused_current [flagship, direct] {B}x{n_curr} -> {g[2]}: max "
        f"|amplitude diff| {err:.3e} ({ex} index rows excused as near-ties), "
        f"kernel {ms:.4f} ms ({dev_ms:.4f} ms on the device alone), plain "
        f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({by}), {bound / ms:.1%} of "
        f"the bound ({bound / dev_ms:.1%} on the device alone)",
        flush=True,
    )
    g2 = (16, 8, 4788, 128, 3, 0)
    c2 = torch.cat([c, c[:, -1:]], dim=1).contiguous()
    if poly_plan(c2.shape[-1], *g2) is not None:
        raise AssertionError("the L = 128 geometry must have no polyphase plan")
    before = dict(_cuda.LAUNCHES)
    got2 = _cuda.fused_current(c2, *g2)
    if (_cuda.LAUNCHES["fused_current"] != before["fused_current"] + 1
            or _cuda.LAUNCHES["fused_current_poly"] != before["fused_current_poly"]):
        raise AssertionError("fused_current did not take K6 for the L = 128 geometry")
    want2 = _cuda.fused_current_plain(c2, *g2)
    torch.cuda.synchronize()
    check_infinite_rows("K6 L=128", got2, want2)
    err2, ex2 = check_current("K6 L=128 vs plain", got2, want2, c2, g2, K6_REL)
    ms2 = time_ms(lambda: _cuda.fused_current(c2, *g2), 20)
    dev2 = device_ms(lambda: _cuda.fused_current(c2, *g2))
    plain2 = time_ms(lambda: _cuda.fused_current_plain(c2, *g2), 5)
    bound2, by2 = current_bound(B, c2.shape[-1], g2[2], g2[3], g2[4], (True,) * 4)
    print(
        f"K6 fused_current [L=128, n_up 4788, n_curr 301] {B} rows: max "
        f"|amplitude diff| {err2:.3e} ({ex2} excused), kernel {ms2:.4f} ms "
        f"({dev2:.4f} ms on the device alone), plain {plain2:.4f} ms, bound "
        f"{bound2:.4f} ms ({by2})",
        flush=True,
    )
    # the flagship L128 path's launch: n_curr 300, n_up 4784, its need
    g3 = AOE_L128_GEOMETRY
    if poly_plan(n_curr, *g3) is not None:
        raise AssertionError("the flagship L128 geometry must have no polyphase plan")
    got3 = _cuda.fused_current(c, *g3, need=AOE_NEED)
    want3 = _cuda.fused_current_plain(c, *g3)
    torch.cuda.synchronize()
    err3, ex3 = check_current("K6 flagship L128 vs plain", got3, want3, c, g3,
                              K6_REL, AOE_NEED)
    ms3 = time_ms(lambda: _cuda.fused_current(c, *g3, need=AOE_NEED), 20)
    dev3 = device_ms(lambda: _cuda.fused_current(c, *g3, need=AOE_NEED))
    bound3, by3 = current_bound(B, n_curr, g3[2], g3[3], g3[4], AOE_NEED)
    launch = _cuda.fused_current_launch(g3[2], AOE_NEED)
    ptxas = list(ptxas_report(ptxas_log, "fused_current_kernel").values())
    if not ptxas:
        raise AssertionError("K6: no ptxas report for fused_current_kernel")
    print(
        f"K6 fused_current [flagship L128 launch, need {AOE_NEED}] {B}x{n_curr} "
        f"-> {g3[2]}: max |a_max diff| {err3:.3e} ({ex3} excused), kernel "
        f"{ms3:.4f} ms ({dev3:.4f} ms on the device alone), bound "
        f"{bound3:.4f} ms ({by3}); launch: {launch['threads']} threads and "
        f"{launch['rows_per_block']} row a block, {launch['smem_bytes']} bytes "
        f"of shared memory a block, {launch['blocks_per_sm']} blocks per SM, "
        f"{launch['registers']} registers and {launch['local_bytes']} local "
        f"bytes a thread; ptxas for fused_current_kernel: {' | '.join(ptxas)}; "
        f"on {card_line()}",
        flush=True,
    )
    err0 = no_stage_phase("K6", _cuda.fused_current_updomain, _cuda, c,
                          "fused_current", K6_REL)
    return dict(
        max_abs_err=max(err, err2, err3, err0), ms=ms, plain_ms=plain_ms,
        bound_ms=bound, bound_by=by, device_ms=dev_ms,
        bound_share=bound / ms, device_bound_share=bound / dev_ms,
        l128_ms=ms2, l128_device_ms=dev2, l128_plain_ms=plain2,
        l128_bound_ms=bound2, chain_l128_ms=ms3, chain_l128_device_ms=dev3,
        chain_l128_bound_ms=bound3, launch=launch, ptxas=ptxas,
    )


def k2_phase(_cuda, w, base, t_start, ptxas_log):
    """K2 against its plain version on the card, bit for bit, with rows of
    a NaN base and of NaN, non-integral, negative and out-of-range starts
    added; returns its figures, with its time on the device alone, its
    launch and ``ptxas -v``'s report for ``cascade_tp_kernel``."""
    import torch

    base = base.clone()
    t = t_start.clone()
    B, n = w.shape
    base[20] = float("nan")
    t[21] = float("nan")
    t[22] = t[22] + 0.5 if torch.isfinite(t[22]) else 100.5
    t[23] = float(n)
    t[24] = -1.0
    args = (w, base, t, CASCADE_FACTORS, CASCADE_DIRS, CASCADE_STARTS)
    got = _cuda.cascade_tp(*args)
    want = _cuda.cascade_tp_plain(*args)
    torch.cuda.synchronize()
    for k, (g, wv) in enumerate(zip(got, want)):
        same = (g == wv) | (torch.isnan(g) & torch.isnan(wv))
        if not bool(same.all()):
            raise AssertionError(
                f"K2 link {k}: {int((~same).sum())} rows differ from the plain "
                f"version"
            )
        if not bool(torch.isnan(g[20:25]).all()):
            raise AssertionError(f"K2 link {k}: a bad start or base is not NaN")
    found = [int(torch.isfinite(g).sum()) for g in got]
    # operations this run's data needs: four compares per sample each link
    # walks from its start to its crossing
    walked = 0
    for k, r in enumerate(want):
        s0 = t if CASCADE_STARTS[k] < 0 else want[CASCADE_STARTS[k]]
        d = (r - s0).abs()
        walked += int(d[torch.isfinite(d)].sum()) + int(torch.isfinite(d).sum())
    ms = time_ms(lambda: _cuda.cascade_tp(*args), 20)
    dev_ms = device_ms(lambda: _cuda.cascade_tp(*args))
    plain_ms = time_ms(lambda: _cuda.cascade_tp_plain(*args), 3, 1)
    m = len(CASCADE_FACTORS)
    # the function's own inputs and outputs: w, base, t and the m time
    # points (the parent kernel's wrapper also wrote and read a (B, m)
    # threshold plane, about 0.2% of these bytes; not counted)
    nbytes = 4 * B * n + 4 * B + 4 * B + 4 * B * m
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = 4 * walked / PEAK_F32_S * 1e3
    bound = max(t_bytes, t_ops)
    launch = _cuda.cascade_tp_launch(n)
    ptxas = list(ptxas_report(ptxas_log, "cascade_tp_kernel").values())
    if not ptxas:
        raise AssertionError("K2: no ptxas report for cascade_tp_kernel")
    print(
        f"K2 cascade_tp {B}x{n}, {m} links: bit-identical to the plain version "
        f"(found per link {found}; samples walked {walked}), kernel {ms:.4f} ms "
        f"({dev_ms:.4f} ms on the device alone), plain {plain_ms:.4f} ms, "
        f"bound {bound:.4f} ms ({'bytes' if t_bytes >= t_ops else 'operations'}), "
        f"{bound / ms:.1%} of the bound ({bound / dev_ms:.1%} on the device "
        f"alone)",
        flush=True,
    )
    print(
        f"K2 launch: {launch['rows_per_block']} rows (one a warp) and "
        f"{launch['threads']} threads a block, {launch['smem_bytes']} bytes of "
        f"shared memory a block, {launch['blocks_per_sm']} blocks per SM, "
        f"{launch['registers']} registers and {launch['local_bytes']} local "
        f"bytes a thread; ptxas for cascade_tp_kernel: {' | '.join(ptxas)}; "
        f"on {card_line()}",
        flush=True,
    )
    return dict(
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound,
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        device_ms=dev_ms, bound_share=bound / ms,
        device_bound_share=bound / dev_ms, launch=launch, ptxas=ptxas,
    )


def check_generic(program, vals, got, want, label) -> tuple[float, float, int, int]:
    """K7's outputs ``got`` against the plain walk's ``want`` (every key
    ``program`` writes; its inputs ``vals``), op by op in tape order. Float
    outputs: NaN positions equal, within REL_TOL of their scale. Index outputs (a search's time
    point, min_max's t_min and t_max): exact, except on a near-tie of the
    plain version's plane (``near_crossing``'s rule for a search, two
    samples within REL_TOL of the scale for an extremum). A row excused in
    one output is excused in every output computed from it. The
    convolution's plane must equal the plain version's bit for bit on every
    row whose input plane does, on the card, where the plain walk reaches
    K4 (on the CPU it sums in another order). Returns (max abs float error, max error
    over scale, rows excused, rows of the convolution checked bit for bit)."""
    import torch

    from dspeed_tpu_torch.processors._tile_program import OPCODES

    slots = program.slots
    B = next(iter(got.values())).shape[0]
    dev = next(iter(got.values())).device
    moved: dict = {}  # root slot -> rows excused (bool, (B,))
    worst_abs = worst_rel = 0.0
    conv_rows = 0

    def plain(key):
        return want[key] if key in want else vals[key]

    def kernel(key):
        return got[key] if key in got else vals[key]

    def same_rows(g, w):
        s = (g == w) | (torch.isnan(g) & torch.isnan(w))
        return s.all(1) if s.ndim == 2 else s

    for op in program.ops:
        if op.code == OPCODES["load"]:
            continue
        mv = torch.zeros(B, dtype=torch.bool, device=dev)
        for e in op.ins:
            if not isinstance(e, tuple) and slots[e].root in moved:
                mv |= moved[slots[e].root]
        for q, sid in enumerate(op.outs):
            key = slots[sid].key
            g, w = got[key].double(), want[key].double()
            if g.shape != w.shape:
                raise AssertionError(f"K7 {label} {key}: shape {tuple(g.shape)} "
                                     f"against {tuple(w.shape)}")
            index = op.code == OPCODES["time_point_thresh"] or (
                op.code == OPCODES["min_max"] and q < 2)
            if index:
                src = plain(slots[op.ins[0]].key)
                moved_rows = mv.cpu().numpy()

                def plane(r):
                    return src[r].double().cpu().numpy()

                if op.code == OPCODES["time_point_thresh"]:
                    a = op.ins[1]

                    def near(r, gi, wi, a=a):
                        thr = a[1] if isinstance(a, tuple) else float(
                            plain(slots[a].key)[r])
                        return moved_rows[r] or near_crossing(
                            plane(r), np.float32(thr), (gi, wi))
                else:
                    def near(r, gi, wi):
                        x = plane(r)
                        return moved_rows[r] or (
                            np.isfinite(gi) and np.isfinite(wi)
                            and abs(x[int(gi)] - x[int(wi)])
                            <= REL_TOL * np.abs(x[np.isfinite(x)]).max())

                index_mismatches(f"K7 {label} {key}", g, w, near)
                moved[sid] = mv | ~same_rows(g, w)
                continue
            keep = ~mv if g.ndim == 1 else (~mv)[:, None].expand_as(g)
            gn, wn = torch.isnan(g), torch.isnan(w)
            if bool(((gn != wn) & keep).any()):
                raise AssertionError(f"K7 {label} {key}: NaN positions differ")
            ok = ~wn & keep
            if bool(ok.any()):
                err = float((g[ok] - w[ok]).abs().max())
                scale = float(w[ok].abs().max())
                if err > REL_TOL * scale:
                    raise AssertionError(
                        f"K7 {label} {key}: max |kernel - plain| {err:.3e} > "
                        f"{REL_TOL * scale:.3e}"
                    )
                worst_abs = max(worst_abs, err)
                worst_rel = max(worst_rel, err / max(scale, 1e-30))
            moved[sid] = mv
        if op.code == OPCODES["conv"] and dev.type == "cuda":
            src = slots[op.ins[0]].key
            dst = slots[op.outs[0]].key
            rows = same_rows(kernel(src), plain(src)) & ~mv
            if not bool(same_rows(got[dst], want[dst])[rows].all()):
                raise AssertionError(
                    f"K7 {label} {dst}: the convolution differs from the plain "
                    f"version on a row whose input it shares"
                )
            conv_rows += int(rows.sum())
    excused = int(torch.stack(list(moved.values())).any(0).sum()) if moved else 0
    return worst_abs, worst_rel, excused, conv_rows


def generic_bound(program, B) -> tuple[float, str]:
    """The least time for one K7 launch of ``program`` on B rows: every
    external plane it loads and scalar it reads, once; every stored output
    written once; the operations its ops need per row (a convolution's
    multiply-adds in float32; float64 prefix sums, window sums, pole-zero
    products, slope-fit sums and moving-window stages; a comparison per
    sample for each reduction; the reflected convolution's products and
    sums and the current's difference and division, in the output's
    type)."""
    import torch

    from dspeed_tpu_torch.processors._tile_program import OPCODES

    slots = program.slots
    nbytes = 0
    for key in program.ext_keys:
        s = slots[program.by_key[key]]
        loaded = any(op.code == OPCODES["load"] and op.ins[0] == program.by_key[key]
                     for op in program.ops)
        if s.kind == "plane":
            nbytes += 4 * s.length if loaded else 0
        else:
            nbytes += s.dtype.itemsize
    for sid in program.esc_roots:
        s = slots[sid]
        nbytes += s.dtype.itemsize * (s.length if s.kind == "plane" else 1)
    f32 = f64 = 0
    for op in program.ops:
        n = slots[op.ins[0]].length if op.ins and not isinstance(op.ins[0], tuple) else 0
        if op.code == OPCODES["conv"]:
            f32 += 2 * op.ip[1] * slots[op.outs[0]].length
        elif op.code == OPCODES["trap"]:
            rise, fall = op.ip[1], op.ip[3]
            f64 += n * (1 + 2 + (rise if rise <= 32 else 2) + (fall if fall <= 32 else 2))
        elif op.code == OPCODES["pole_zero"]:
            f64 += 2 * n
        elif op.code == OPCODES["linear_slope_fit"]:
            f64 += 5 * n
        elif op.code == OPCODES["moving_window_multi"]:
            f64 += op.ip[1] * (3 * n + 2 * op.ip[0])
        elif op.code == OPCODES["min_max"]:
            f32 += 2 * n
        elif op.code == OPCODES["amax"]:
            f32 += n
        elif op.code in (OPCODES["reflected_conv"], OPCODES["avg_current"]):
            p = slots[op.outs[0]].length
            ops = 2 * (op.ip[1] if op.code == OPCODES["reflected_conv"] else 1) * p
            if slots[op.outs[0]].dtype == torch.float64:
                f64 += ops
            else:
                f32 += ops
    t_bytes = B * nbytes / PEAK_BYTES_S * 1e3
    t_ops = B * (f32 / PEAK_F32_S + f64 / PEAK_F64_S) * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def k7_phase(build_processing_chain, lh5, _cuda, wf, bl, dev, ptxas_log):
    """K7 on the generic flagship's two groups: the chain built on the CPU
    over every event (NaN rows included), its steps run on the card up to
    the second group, each group lowered twice: with every key it writes
    (held against the plain walk by ``check_generic``) and with the chain's
    own escapes (timed against the plain walk, through the wrapper and on
    the device alone). Returns the figures, with each group's launch and
    ``ptxas -v``'s report for ``generic_rows_kernel``."""
    import torch

    from dspeed_tpu_torch.processing_chain import GroupStep
    from dspeed_tpu_torch.processors._tile_program import lower

    wf = wf.copy()
    bl = bl.copy()
    wf[NAN_SAMPLE_ROW, 500] = np.nan
    bl[NAN_BASELINE_ROW] = np.nan
    tb = lh5.Table({
        "waveform": lh5.WaveformTable(
            values=wf, t0=0.0, t0_units="ns", dt=DT, dt_units="ns"
        ),
        "baseline": lh5.Array(bl.astype(np.float32)),
    })
    chain, _, _ = build_processing_chain(
        config(), tb, db_dict={"pz": {"tau": TAU}}, device="cpu", fuse="generic"
    )
    inputs, B = chain._gather_inputs(0, len(wf))
    env = {k: v.to(dev) for k, v in chain._to_device(inputs).items()}
    env.update({k: v.to(dev) if isinstance(v, torch.Tensor) else v
                for k, v in chain._const_env().items()})
    groups = [s for s in chain._steps if isinstance(s, GroupStep)]
    if [len(g.members) for g in groups] != [34, 19]:
        raise AssertionError(f"generic groups {[len(g.members) for g in groups]}")
    figs = []
    with torch.no_grad():
        for step in chain._steps:
            if not isinstance(step, GroupStep):
                step.run(env)
                continue
            label = "A" if not figs else "B"
            vals = {k: env[k] for k in step.ext_in}
            prog = lower(step.members, vals, step.escapes)
            every = sorted(s.key for s in prog.slots if not s.ext)
            full = lower(step.members, vals, every)
            got = _cuda.generic_rows(full, vals)
            want = _cuda.generic_rows_plain(full, vals)
            torch.cuda.synchronize()
            err, rel, excused, conv_rows = check_generic(full, vals, got, want,
                                                         label)
            outs = _cuda.generic_rows(prog, vals)
            for k in step.escapes:
                g, w = outs[k], got[k]
                if g.shape != w.shape or g.stride() != w.stride() or not bool(
                        ((g == w) | (torch.isnan(g) & torch.isnan(w))).all()):
                    raise AssertionError(f"K7 {label} {k}: the chain's launch differs")
            ms = time_ms(lambda: _cuda.generic_rows(prog, vals), 20)
            dev_ms = device_ms(lambda: _cuda.generic_rows(prog, vals))
            plain_ms = time_ms(lambda: _cuda.generic_rows_plain(prog, vals), 3, 1)
            bound, by = generic_bound(prog, B)
            launch = _cuda.generic_rows_launch(prog)
            print(
                f"K7 generic_rows [group {label}: {len(step.members)} members, "
                f"{len(prog.ops)} ops, {sum(op.plan for op in prog.ops)} planned "
                f"barriers, {len(prog.ext_keys)} inputs, "
                f"{len(step.escapes)} escapes, {prog.smem_bytes} B of shared "
                f"memory] {B} rows: max |kernel - plain| {err:.3e} ({rel:.3e} of "
                f"scale), {excused} rows excused as near-ties, convolution bit "
                f"for bit on {conv_rows} rows; kernel {ms:.4f} ms ({dev_ms:.4f} "
                f"ms on the device alone), plain {plain_ms:.4f} ms, bound "
                f"{bound:.4f} ms ({by}), {bound / ms:.1%} of the bound "
                f"({bound / dev_ms:.1%} on the device alone); launch: "
                f"{launch['threads']} threads and {launch['smem_bytes']} + "
                f"{launch['static_smem_bytes']} B of shared memory a block, "
                f"{launch['blocks_per_sm']} blocks per SM, "
                f"{launch['registers']} registers and {launch['local_bytes']} "
                f"local bytes a thread",
                flush=True,
            )
            figs.append(dict(ms=ms, dev_ms=dev_ms, plain_ms=plain_ms,
                             bound=bound, by=by, err=err, launch=launch))
            env.update({k: got[k] for k in step.escapes})
            if len(figs) == 2:
                break
    a, b = figs
    ptxas = list(ptxas_report(ptxas_log, "generic_rows_kernel").values())
    if not ptxas:
        raise AssertionError("K7: no ptxas report for generic_rows_kernel")
    print(f"K7 ptxas for generic_rows_kernel: {' | '.join(ptxas)}; on "
          f"{card_line()}", flush=True)
    return dict(
        max_abs_err=max(a["err"], b["err"]), ms=a["ms"] + b["ms"],
        plain_ms=a["plain_ms"] + b["plain_ms"],
        bound_ms=a["bound"] + b["bound"],
        bound_by=a["by"] if a["bound"] >= b["bound"] else b["by"],
        device_ms=a["dev_ms"] + b["dev_ms"],
        bound_share=(a["bound"] + b["bound"]) / (a["ms"] + b["ms"]),
        device_bound_share=(a["bound"] + b["bound"]) / (a["dev_ms"] + b["dev_ms"]),
        group_a_ms=a["ms"], group_b_ms=b["ms"], group_a_device_ms=a["dev_ms"],
        group_b_device_ms=b["dev_ms"], group_a_plain_ms=a["plain_ms"],
        group_b_plain_ms=b["plain_ms"], group_a_bound_ms=a["bound"],
        group_b_bound_ms=b["bound"], group_a_launch=a["launch"],
        group_b_launch=b["launch"], ptxas=ptxas,
    )


def sipm_table(lh5, wf):
    return lh5.Table({"waveform": lh5.WaveformTable(
        values=wf, t0=0.0, t0_units="ns", dt=DT, dt_units="ns")})


def same_bits(a, b) -> bool:
    """Equal values, NaN where NaN, of equal shape and type (two tensors)."""
    import torch

    return (a.shape == b.shape and a.dtype == b.dtype
            and bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all()))


def sipm_k7_phase(build_processing_chain, lh5, _cuda, wf, dev):
    """K7 on the SiPM chain's group (``reflected_convolve_wf`` and
    ``avg_current``, float64 from the smoothed waveform on), lowered from
    the chain the port builds on the CPU over ``wf`` (``sipm_edge_rows``:
    a NaN row, a row with an infinite sample, a row whose reflected edges
    hold its extremes). Every key the group writes, on every row, must
    equal the tape's plain walk bit for bit; the chain's own launch (its
    escape ``curr``) is timed against the plain walk, through the wrapper
    and on the device alone. Returns the figures and ``curr``."""
    from dspeed_tpu_torch.processing_chain import GroupStep
    from dspeed_tpu_torch.processors._tile_program import lower

    chain, _, _ = build_processing_chain(sipm_config(), sipm_table(lh5, wf),
                                         device="cpu")
    groups = [s for s in chain._steps if isinstance(s, GroupStep)]
    kinds = [[m.kernel.__name__ for m in g.members] for g in groups]
    if kinds != [["reflected_convolve_wf", "avg_current"]]:
        raise AssertionError(f"SiPM generic groups {kinds}")
    (step,) = groups
    inputs, B = chain._gather_inputs(0, len(wf))
    env = {k: v.to(dev) for k, v in chain._to_device(inputs).items()}
    vals = {k: env[k] for k in step.ext_in}
    prog = lower(step.members, vals, step.escapes)
    every = sorted(s.key for s in prog.slots if not s.ext)
    full = lower(step.members, vals, every)
    got = _cuda.generic_rows(full, vals)
    want = _cuda.generic_rows_plain(full, vals)
    for k in every:
        if not same_bits(got[k], want[k]):
            raise AssertionError(f"K7 SiPM {k}: not the plain walk's bits")
    outs = _cuda.generic_rows(prog, vals)
    (curr_key,) = step.escapes
    if not same_bits(outs[curr_key], got[curr_key]):
        raise AssertionError("K7 SiPM: the chain's launch differs")
    ms = time_ms(lambda: _cuda.generic_rows(prog, vals), 20)
    dev_ms = device_ms(lambda: _cuda.generic_rows(prog, vals))
    plain_ms = time_ms(lambda: _cuda.generic_rows_plain(prog, vals), 5, 1)
    bound, by = generic_bound(prog, B)
    launch = _cuda.generic_rows_launch(prog)
    print(
        f"K7 generic_rows [SiPM group: {len(step.members)} members, "
        f"{len(prog.ops)} ops, {sum(op.plan for op in prog.ops)} planned "
        f"barriers, {prog.smem_bytes} B of shared memory, planes "
        f"{[str(s.dtype).split('.')[-1] for s in prog.slots if s.kind == 'plane']}] "
        f"{B} rows x {wf.shape[1]} samples (a NaN row, an infinite sample, "
        f"extremes in the reflected edges): every key it writes equal to the "
        f"plain walk bit for bit on every row; kernel {ms:.4f} ms ({dev_ms:.4f} "
        f"ms on the device alone), plain {plain_ms:.4f} ms, bound {bound:.4f} ms "
        f"({by}), {bound / ms:.1%} of the bound ({bound / dev_ms:.1%} on the "
        f"device alone); launch: {launch['threads']} threads and "
        f"{launch['smem_bytes']} + {launch['static_smem_bytes']} B of shared "
        f"memory a block, {launch['blocks_per_sm']} blocks per SM, "
        f"{launch['registers']} registers and {launch['local_bytes']} local "
        f"bytes a thread; on {card_line()}",
        flush=True,
    )
    figs = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, bound_share=bound / ms,
                device_bound_share=bound / dev_ms, launch=launch,
                max_abs_err=0.0)
    return figs, outs[curr_key]


SIPM_DMAX, SIPM_DMIN, SIPM_SLOTS = 5.0, 0.1, 20  # the config's peak finder


def sipm_amax(curr):
    """``3 * fwhm`` of ``curr`` as the SiPM chain computes it: the port's
    own ``histogram`` (100 bins) and ``histogram_stats``."""
    from dspeed_tpu_torch.processors import histogram, histogram_stats

    hw, hb = histogram(curr, dims={"m": 100, "p": 101})
    _, _, fwhm = histogram_stats(hw, hb, np.nan)
    return 3 * fwhm


def scan_bound(curr, m_max, m_min) -> float:
    """The sweep's least time: the row read once, the slots and the two
    int32 counts written once (bytes; a few comparisons a sample are far
    below the card's operation rate)."""
    B, n = curr.shape
    isz = curr.element_size()
    nbytes = B * (n * isz + (m_max + m_min) * isz + 2 * 4)
    return nbytes / PEAK_BYTES_S * 1e3


def sipm_scan_phase(_cuda, curr):
    """The peak finder's sweep (``csrc/peakdet_scan.cu``) on the SiPM
    group's ``curr`` with the chain's parameters (``dmax`` 5, ``dmin`` 0.1,
    ``amax`` = 3 fwhm from the port's ``histogram_stats``, ``amin`` 0, 20
    slots each), one launch a direction: both directions' slots and counts
    equal to the plain version on every row, rows of NaN fwhm included (one
    set NaN, ``NAN_FWHM_ROW``, beside those the histogram gives) and a row
    that fills all 20 slots (``FULL_SLOT_ROW``, its ``amax`` set to 0).
    Directions 2 and 3 through the processor against the processor on the
    CPU. Returns the figures."""
    import torch

    from dspeed_tpu_torch.processors import get_multi_local_extrema

    amax = sipm_amax(curr)
    natural_nan = int(torch.isnan(amax).sum())
    amax[FULL_SLOT_ROW] = 0.0
    amax[NAN_FWHM_ROW] = float("nan")
    m = SIPM_SLOTS
    args = (SIPM_DMAX, SIPM_DMIN, amax, 0.0, m, m)
    for reverse in (False, True):
        got = _cuda.peakdet_scan(curr, *args, reverse=reverse)
        want = _cuda.peakdet_scan_plain(curr, *args, reverse=reverse)
        for name, g, w in zip(("vt_max", "vt_min", "n_max", "n_min"), got, want):
            if not same_bits(g, w):
                raise AssertionError(f"peakdet_scan (reverse={reverse}) {name}: "
                                     f"not the plain version's bits")
        if int(got[2][FULL_SLOT_ROW]) != m:
            raise AssertionError(f"peakdet_scan: row {FULL_SLOT_ROW} declared "
                                 f"{int(got[2][FULL_SLOT_ROW])} maxima, not {m}")
        nan_rows = torch.isnan(amax)
        if int(got[2][nan_rows].max()) != 0 or int(got[3][nan_rows].max()) != 0:
            raise AssertionError("peakdet_scan: a row of NaN amax declared extrema")
    full_rows = int((got[2] == m).sum())
    curr_cpu = curr.cpu()
    for direction in (2, 3):
        dims = {"m": m, "p": m}
        pa = (SIPM_DMAX, SIPM_DMIN, direction)
        g = get_multi_local_extrema(curr, *pa, amax, 0.0, dims=dims)
        w = get_multi_local_extrema(curr_cpu, *pa, amax.cpu(), 0.0, dims=dims)
        for q, (a, b) in enumerate(zip(g, w)):
            if not same_bits(a.cpu(), b):
                raise AssertionError(f"get_multi_local_extrema direction "
                                     f"{direction}, output {q}: card and CPU differ")
    ms = time_ms(lambda: _cuda.peakdet_scan(curr, *args, reverse=True), 20)
    dev_ms = device_ms(lambda: _cuda.peakdet_scan(curr, *args, reverse=True))
    plain_ms = time_ms(
        lambda: _cuda.peakdet_scan_plain(curr, *args, reverse=True), 1, 1)
    bound = scan_bound(curr, m, m)
    launch = _cuda.peakdet_scan_launch()
    B, n = curr.shape
    print(
        f"peakdet_scan {B} rows x {n} {str(curr.dtype).split('.')[-1]} samples, "
        f"{m} + {m} slots: both directions equal to the plain version bit for "
        f"bit on every row ({natural_nan} rows of NaN fwhm from the histogram, "
        f"row {NAN_FWHM_ROW} set NaN, {full_rows} rows filling all {m} slots), "
        f"directions 2 and 3 through the processor equal to the CPU's; kernel "
        f"{ms:.4f} ms ({dev_ms:.4f} ms on the device alone), plain {plain_ms:.1f} "
        f"ms, bound {bound:.4f} ms (bytes), {bound / ms:.1%} of the bound "
        f"({bound / dev_ms:.1%} on the device alone); launch: "
        f"{launch['threads']} threads a block, {launch['blocks_per_sm']} blocks "
        f"per SM, {launch['registers']} registers and {launch['local_bytes']} "
        f"local bytes a thread; on {card_line()}",
        flush=True,
    )
    return dict(max_abs_err=0.0, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by="bytes", bound_share=bound / ms,
                device_bound_share=bound / dev_ms, launch=launch,
                natural_nan_fwhm_rows=natural_nan)


# mean |found - injected| pulse count per event of the JAX package's SiPM
# chain on make_sipm_waveforms(16384): its build_dsp on the CPU in x64,
# buffer_len 2048 (2766 miscounted pulses over 16384 events). The port's CPU
# run gives the same trigger positions on every event, so the margin only
# allows for a near-tie that the card's float64 sums might move: 0.001 is
# 16 miscounts more or fewer
SIPM_PULSE_ERR = 0.1688232421875
SIPM_PULSE_MARGIN = 0.001


def vov_arrays(col, n):
    """The first ``n`` rows of a ``VectorOfVectors`` column: (cumulative
    lengths, flattened data)."""
    cl = np.array(col.cumulative_length.nda[:n])
    return cl, np.array(col.flattened_data.nda[: int(cl[-1]) if n else 0])


def column_arrays(col, n):
    """A copy of the first ``n`` rows of an output column: an array, or
    for a ``VectorOfVectors`` its cumulative lengths and flattened data by
    name."""
    if hasattr(col, "cumulative_length"):
        cl, flat = vov_arrays(col, n)
        return {"cumulative_length": cl, "flattened_data": flat}
    return np.array(col.nda[:n])


def sipm_e2e_phase(build_dsp, lh5, _cuda, wf, n_pulses, card):
    """The SiPM path: ``build_dsp`` of ``configs/sipm-pulse-finding.yaml``
    over every event of ``wf`` on the card, Table -> Table (file -> file is
    tested on the CPU), twice: the second call a chain-cache hit. One chunk:
    ``generic_rows`` and ``peakdet_scan`` launched once each, no group
    split. The VoV columns of the first 256 events equal the port's CPU run
    (cumulative lengths and flattened data); the mean |found - injected|
    pulse count lies within ``SIPM_PULSE_MARGIN`` of the JAX package's.
    Returns the launch counts and rates."""
    import torch

    from dspeed_tpu_torch.processors import _tile_program

    cfg = sipm_config()
    tb = sipm_table(lh5, wf)
    n_ev = len(wf)
    n_cpu = min(256, n_ev)

    def run(dev, n):
        return build_dsp(tb, dsp_config=cfg, n_entries=n, buffer_len=n, device=dev)

    def timed():
        torch.cuda.synchronize()
        t_0 = time.time()
        out = run(DEVICE, n_ev)
        torch.cuda.synchronize()
        return out, time.time() - t_0

    _cuda.reset_launches()
    _tile_program.reset_splits()
    out, cold_s = timed()
    launches = dict(_cuda.LAUNCHES)
    splits = dict(_tile_program.SPLITS)
    print(f"build_dsp [SiPM] launches: {launches}; generic-group splits: {splits}",
          flush=True)
    with counted_builds(build_dsp) as builds:
        out2, warm_s = timed()
    if builds.n:
        raise AssertionError(f"[SiPM] the second build_dsp call built {builds.n} "
                             f"chain(s): no chain-cache hit")
    for name in ("generic_rows", "peakdet_scan"):
        if launches.get(name, 0) != 1:
            raise AssertionError(f"[SiPM] {name} launched {launches.get(name, 0)} "
                                 f"times on one chunk, not once")
    if splits:
        raise AssertionError(f"generic groups split on the SiPM path: {splits}")
    cpu = run("cpu", n_cpu)
    for k in cfg["outputs"]:
        a, b = column_arrays(out[k], n_ev), column_arrays(out2[k], n_ev)
        if any(a[q].tobytes() != b[q].tobytes() for q in a):
            raise AssertionError(f"[SiPM] {k}: the two calls differ")
        got, want = column_arrays(out[k], n_cpu), column_arrays(cpu[k], n_cpu)
        for q in want:
            if got[q].dtype != want[q].dtype or got[q].tobytes() != want[q].tobytes():
                raise AssertionError(f"[SiPM] {k} {q}: the first {n_cpu} events "
                                     f"differ from the port's CPU run")
    cl, _ = vov_arrays(out["trigger_pos"], n_ev)
    found = np.diff(cl.astype(np.int64), prepend=0)
    err = float(np.abs(found - n_pulses).mean())
    print(f"build_dsp [SiPM] Table -> Table (no h5py here), {n_ev} events x "
          f"{wf.shape[1]} samples, VoV outputs {cfg['outputs']}: first call "
          f"{cold_s:.3f} s ({n_ev / cold_s:.0f} wf/s), second call {warm_s:.3f} s "
          f"({n_ev / warm_s:.0f} wf/s, a chain-cache hit) on {card}; first "
          f"{n_cpu} events equal to the port's CPU run (cumulative lengths and "
          f"flattened data); {int(found.sum())} pulses found against "
          f"{int(n_pulses.sum())} injected, mean |found - injected| {err:.6f} "
          f"per event (the JAX package: {SIPM_PULSE_ERR})", flush=True)
    if abs(err - SIPM_PULSE_ERR) > SIPM_PULSE_MARGIN:
        raise AssertionError(f"[SiPM] mean |found - injected| {err} is not within "
                             f"{SIPM_PULSE_MARGIN} of the JAX package's "
                             f"{SIPM_PULSE_ERR}")
    return dict(launches=launches, first_wfps=n_ev / cold_s,
                warm_wfps=n_ev / warm_s, pulse_err=err)


def sipm_pipeline_phase(build_dsp, build_processing_chain, lh5, _cuda, wf, card):
    """Two chunks of distinct SiPM events (the second rolled by 1237 rows)
    through ``build_dsp``'s production loop: every VoV output of every
    chunk bit for bit against the synchronous call of the same chain;
    ``generic_rows`` and ``peakdet_scan`` once a chunk."""
    import torch

    tables = distinct_chunks(lh5, wf, None, 2)
    total = sum(len(t) for t in tables)
    chain, _, tb_out = build_processing_chain(sipm_config(), tables[0],
                                              device=DEVICE)
    torch.cuda.synchronize()
    _cuda.reset_launches()
    got, split, run_s = run_pipeline(build_dsp, chain, tb_out, tables)
    launches = dict(_cuda.LAUNCHES)
    for name in ("generic_rows", "peakdet_scan"):
        if launches.get(name, 0) != len(tables):
            raise AssertionError(f"pipeline [SiPM]: {name} launched "
                                 f"{launches.get(name, 0)} times on {len(tables)} "
                                 f"chunks")
    torch.cuda.synchronize()
    t_0 = time.time()
    want, i_entry = {}, 0
    for tb in tables:
        out = chain(tb)
        want[i_entry] = {k: column_arrays(col, len(tb)) for k, col in out.items()}
        i_entry += len(tb)
    sync_s = time.time() - t_0
    if sorted(got) != sorted(want):
        raise AssertionError(f"pipeline [SiPM]: chunks written at {sorted(got)}")
    for i_entry, cols in want.items():
        for k, arrs in cols.items():
            for q, w in arrs.items():
                g = got[i_entry][k][q]
                if g.dtype != w.dtype or g.tobytes() != w.tobytes():
                    raise AssertionError(f"pipeline [SiPM]: {k} {q} of the chunk "
                                         f"at entry {i_entry} differs from the "
                                         f"synchronous call")
    print(f"pipeline [SiPM] {len(tables)} chunks x {len(tables[0])} events, every "
          f"VoV output of every chunk equal to the synchronous call bit for bit; "
          f"launches {launches}; production loop {run_s:.3f} s ({total / run_s:.0f} "
          f"wf/s), the synchronous calls {sync_s:.3f} s ({total / sync_s:.0f} "
          f"wf/s); split (s): {json.dumps(split)}; on {card}", flush=True)
    return dict(wfps=total / run_s, sync_wfps=total / sync_s, launches=launches)


def compare_columns(cols, cpu, wf, bl, n_cpu,
                    aoe_geometry=AOE_GEOMETRY) -> tuple[int, float]:
    """Hold the card's first ``n_cpu`` events against the port's CPU run:
    float columns within REL_TOL of column scale, index columns exact, NaN
    positions identical. Excused, and counted: an event whose ``tp_0_est``
    moved by one sample (two f32 convolutions rounding differently) in the
    columns that read it; a search (``tp_0_atrap``, a cascade link) whose
    plane sits within REL_TOL of its threshold at the crossing, and the
    cascade links after it. Returns (excused events, worst float error)."""
    import torch

    from dspeed_tpu_torch.processors import asym_trap_filter, pole_zero

    a = {k: v[:n_cpu].astype(np.float64) for k, v in cols.items()}
    c = {k: v.astype(np.float64) for k, v in cpu.items()}
    excused = {k: np.zeros(n_cpu, bool) for k in cols}
    if "tp_0_est" in cols:
        g, w = a["tp_0_est"], c["tp_0_est"]
        moved = np.isfinite(g) & np.isfinite(w) & (g != w)
        if (np.abs(g - w)[moved] != DT).any():
            raise AssertionError("tp_0_est: card and CPU differ by more than one sample")
        for k in READS_TP0:
            if k in excused:
                excused[k] |= moved
        # searches whose plane sits on the threshold at the crossing
        rows = sorted(set(np.flatnonzero(
            np.any([~((a[k] == c[k]) | (np.isnan(a[k]) & np.isnan(c[k])))
                    for k in ("tp_0_atrap", *CASCADE)], axis=0)
        )) - set(np.flatnonzero(moved)))
        if rows:
            x = torch.from_numpy(wf[rows] - bl[rows, None].astype(np.float32))
            (pz,) = pole_zero(x, TAU)
            (trap,) = asym_trap_filter(pz, *ATRAP[1:])
            pz, trap = pz.numpy(), trap.numpy()
            for j, r in enumerate(rows):
                pairs = [("tp_0_atrap", trap[j], c["bl_std"][r])] + [
                    (k, pz[j], np.float32(f) * np.float32(c["trapTmax"][r]))
                    for k, f in zip(CASCADE, CASCADE_FACTORS)
                ]
                later = False
                for k, plane, thr in pairs:
                    if later:
                        excused[k][r] = True
                        continue
                    g, w = a[k][r], c[k][r]
                    if g == w or (np.isnan(g) and np.isnan(w)):
                        continue
                    if not near_crossing(plane, thr, (g / DT, w / DT)):
                        raise AssertionError(
                            f"{k}: event {r} differs from the CPU run "
                            f"({g} against {w}) away from its threshold"
                        )
                    excused[k][r] = True
                    later = k != "tp_0_atrap"
    if "tp_aoe_max" in cols:
        aoe_near_ties(a, c, excused, wf, bl, n_cpu, aoe_geometry)
    worst = 0.0
    for k in cols:
        keep = ~excused[k]
        g, w = a[k][keep], c[k][keep]
        if not np.array_equal(np.isnan(g), np.isnan(w)):
            raise AssertionError(f"{k}: NaN positions differ from the CPU run")
        if not np.isfinite(w).any():
            continue
        err = np.nanmax(np.abs(g - w))
        scale = np.nanmax(np.abs(w))
        limit = 0.0 if is_index(k) else REL_TOL * scale
        if err > limit:
            raise AssertionError(f"{k}: card vs CPU max diff {err:.3e} > {limit:.3e}")
        if not is_index(k):
            worst = max(worst, err / max(scale, 1e-30))
    n_ex = int(np.any(list(excused.values()), axis=0).sum())
    if n_ex:
        print("events excused against the CPU run: "
              + ", ".join(f"{k} {np.flatnonzero(v).tolist()}"
                          for k, v in excused.items() if v.any()), flush=True)
    return n_ex, worst


def aoe_near_ties(a, c, excused, wf, bl, n_cpu, geometry=AOE_GEOMETRY) -> None:
    """Excuse, in ``excused``, the events whose ``tp_aoe_max`` (and so
    ``tp_aoe_samp``) differs between the card (``a``) and the CPU run
    (``c``) with both values on a near-tie of the CPU's current curve:
    within REL_TOL of ``A_max``'s scale of its maximum. K5's float32
    interior and the plain version's float64 cascade may break such a tie
    differently (``_pallas.py:1413-1420``). Fails on any other difference,
    and above 1% of the events."""
    import torch

    from dspeed_tpu_torch.processors import avg_current, pole_zero, windower

    g, w = a["tp_aoe_max"], c["tp_aoe_max"]
    rows = np.flatnonzero(
        ~excused["tp_aoe_max"] & np.isfinite(g) & np.isfinite(w) & (g != w)
    )
    if rows.size == 0:
        return
    if rows.size > 0.01 * n_cpu:
        raise AssertionError(
            f"tp_aoe_max: {rows.size} of {n_cpu} events differ from the CPU run"
        )
    x = torch.from_numpy(wf[rows] - bl[rows, None].astype(np.float32))
    (pz,) = pole_zero(x, TAU)
    tp0 = torch.from_numpy((c["tp_0_est"][rows] / DT).astype(np.float32))
    (wle,) = windower(pz, tp0, dims={"m": CURR_SPEC[0]})
    (cur,) = avg_current(wle, float(CURR_SPEC[1]), dims={"m": CURR_SPEC[2]})
    curve = current_curve(cur, geometry).double().numpy()
    tol = REL_TOL * np.nanmax(np.abs(c["A_max"]))
    for j, r in enumerate(rows):
        top = curve[j].max()
        for v in (g[r], w[r]):
            if abs(curve[j, int(v / DT)] - top) > tol:
                raise AssertionError(
                    f"tp_aoe_max: event {r} differs from the CPU run ({g[r]} "
                    f"against {w[r]}) off a near-tie of its current"
                )
        excused["tp_aoe_max"][r] = excused["tp_aoe_samp"][r] = True
    print(f"tp_aoe_max: {rows.size} events excused as near-ties of the "
          f"current: {rows.tolist()}", flush=True)


def aoe_checks(cols, good, amp, t0, rt, label, ref=AOE_RATIO[48]) -> None:
    """The A/E columns' physics on good events: ``A_max`` is the current's
    maximum, about ``amp / rt`` for a linear rise (the median of ``A_max *
    rt / amp`` on events with ``amp / rt > 50`` within 2% of ``ref``, the
    JAX package's value of ``AOE_RATIO``), and ``tp_aoe_samp`` lies inside
    the rise (at
    least 98% of events with ``(tp_aoe_samp / 16 ns - t0) / rt`` in [0,
    1]). A column that is NaN because ``tp_0_est`` is, or because the
    window runs past the row, is counted; any other NaN fails."""
    tp0 = cols["tp_0_est"] / DT
    past = np.isfinite(tp0) & (tp0 + CURR_SPEC[0] > N_SAMPLES)
    explained = ~np.isfinite(tp0) | past
    for k in AOE_OUTPUTS:
        nan = good & np.isnan(cols[k])
        if (nan & ~explained).any():
            raise AssertionError(f"{k}: NaN on good events with a window in the row")
    live = good & ~explained
    print(f"[{label}] A/E: {int((good & explained).sum())} good events without a "
          f"current (tp_0_est NaN: {int((good & ~np.isfinite(tp0)).sum())}, window "
          f"past the row: {int((good & past).sum())})", flush=True)
    steep = live & (amp / rt > 50)
    ratio = cols["A_max"][steep] * rt[steep] / amp[steep]
    med = float(np.median(ratio))
    frac = (cols["tp_aoe_samp"][live] / DT - t0[live]) / rt[live]
    inside = float(np.mean((frac >= 0) & (frac <= 1)))
    print(f"[{label}] A_max * rt / amp: median {med:.4f} (1st-99th percentile "
          f"{np.percentile(ratio, 1):.4f} to {np.percentile(ratio, 99):.4f}) on "
          f"{int(steep.sum())} events with amp/rt > 50; (tp_aoe_samp/16 ns - t0)"
          f"/rt: median {np.median(frac):.3f}, {inside:.2%} of {int(live.sum())} "
          f"events in [0, 1]", flush=True)
    if abs(med / ref - 1) > 0.02:
        raise AssertionError(f"A_max * rt / amp is more than 2% from {ref}")
    if inside < 0.98:
        raise AssertionError("tp_aoe_samp lies outside the rise on > 2% of events")


def e2e_phase(build_dsp, lh5, _cuda, cfg, wf, amp, t0, bl, card, label,
              expect, rt=None, device="cuda", fuse=True, forbid=(),
              aoe_geometry=AOE_GEOMETRY):
    """A main path: ``build_dsp`` of ``cfg`` with fusion mode ``fuse`` over
    every event of ``wf`` on ``device``, file -> file where ``h5py`` is
    installed, else Table -> Table; launch counts and generic-group splits
    read around the first run: each kernel of ``expect`` must have been
    launched, none of ``forbid``, and no group split; physics and CPU
    cross-checks (the CPU run in the same mode) on the output. Event
    ``NAN_SAMPLE_ROW`` gets a NaN sample and event ``NAN_BASELINE_ROW`` a
    NaN baseline, so the NaN rules are checked end to end;
    ``aoe_geometry`` is the current front's (its window length picks the A/E
    reference of ``AOE_RATIO``). Returns the launch counts."""
    import importlib.util

    import torch

    from dspeed_tpu_torch.processors import _tile_program

    outputs = list(cfg["outputs"])
    wf = wf.copy()
    bl = bl.copy()
    wf[NAN_SAMPLE_ROW, 500] = np.nan
    bl[NAN_BASELINE_ROW] = np.nan
    n_ev = wf.shape[0]
    n_cpu = min(256, n_ev)
    good = np.ones(n_ev, dtype=bool)
    good[[NAN_SAMPLE_ROW, NAN_BASELINE_ROW]] = False
    tb = lh5.Table({
        "waveform": lh5.WaveformTable(
            values=wf, t0=0.0, t0_units="ns", dt=DT, dt_units="ns"
        ),
        "baseline": lh5.Array(bl.astype(np.float32)),
    })
    files = importlib.util.find_spec("h5py") is not None
    with tempfile.TemporaryDirectory() as tmp:
        if files:
            import h5py

            raw = os.path.join(tmp, "smoke_raw.lh5")
            lh5.write(tb, "ch001/raw", raw)

            def run(dev, n, stats=None):
                out = os.path.join(tmp, f"smoke_dsp_{dev}.lh5")
                build_dsp(raw, out, cfg, database={"ch001": {"pz": {"tau": TAU}}},
                          n_entries=n, buffer_len=n, device=dev, write_mode="r",
                          fuse=fuse, stats=stats)
                with h5py.File(out, "r") as f:
                    return {k: f[f"ch001/dsp/{k}"][()] for k in outputs}
        else:
            def run(dev, n, stats=None):
                out = build_dsp(tb, dsp_config=cfg, database={"pz": {"tau": TAU}},
                                n_entries=n, buffer_len=n, device=dev, fuse=fuse,
                                stats=stats)
                return {k: np.asarray(out[k].nda) for k in outputs}

        route = "file -> file" if files else "Table -> Table (no h5py)"

        call_stats = []

        def timed(dev, n):
            stats: dict = {}
            torch.cuda.synchronize()
            t_0 = time.time()
            cols = run(dev, n, stats)
            torch.cuda.synchronize()
            call_stats.append({k: round(v * 1e3, 3) for k, v in stats.items()
                           if k.endswith("_s")})
            return cols, time.time() - t_0

        _cuda.reset_launches()
        _tile_program.reset_splits()
        cols, cold_s = timed(device, n_ev)
        launches = dict(_cuda.LAUNCHES)
        group_splits = dict(_tile_program.SPLITS)
        print(f"build_dsp [{label}] launches: {launches}; generic-group splits: "
              f"{group_splits}", flush=True)
        with counted_builds(build_dsp) as builds:
            cols, warm_s = timed(device, n_ev)
        print(
            f"build_dsp [{label}] {route}, {n_ev} events, {len(outputs)} "
            f"columns: first call {cold_s:.3f} s ({n_ev / cold_s:.0f} wf/s), "
            f"second call {warm_s:.3f} s ({n_ev / warm_s:.0f} wf/s) on {card}; "
            f"second call a chain-cache {'miss' if builds.n else 'hit'}; stats "
            f"(ms) {json.dumps(call_stats[0])}, {json.dumps(call_stats[1])}",
            flush=True,
        )
        if builds.n:
            raise AssertionError(f"[{label}] the second build_dsp call built "
                                 f"{builds.n} chain(s): no chain-cache hit")
        cpu = run("cpu", n_cpu)
    searches = ("tp_0_est", *READS_TP0)
    not_found = {}
    for k, v in cols.items():
        if v.shape != (n_ev,):
            raise AssertionError(f"{k}: shape {v.shape}")
        if k in AOE_OUTPUTS:
            pass  # counted by aoe_checks
        elif k in searches:
            # a search that finds no crossing gives NaN: a result, counted
            not_found[k] = int(np.isnan(v[good]).sum())
        elif not np.isfinite(v[good]).all():
            raise AssertionError(f"{k}: non-finite values on good events")
        # a NaN baseline leaves the raw waveform's extrema intact
        raw_only = k in ("tp_min", "tp_max", "wf_min", "wf_max")
        nan_rows = [NAN_SAMPLE_ROW] if raw_only else [NAN_SAMPLE_ROW, NAN_BASELINE_ROW]
        if not np.isnan(v[nan_rows]).all():
            raise AssertionError(f"{k}: a NaN row was not poisoned")
    if not_found:
        print(f"[{label}] NaN on good events (a search found nothing): "
              f"{json.dumps(not_found)}", flush=True)
    rel = np.abs(cols["trapEmax"][good] / amp[good] - 1)
    print(f"[{label}] trapEmax vs injected amplitude: max {rel.max():.4%}, "
          f"median {np.median(rel):.4%}", flush=True)
    if rel.max() > 0.005:
        raise AssertionError("trapEmax misses the injected amplitudes by > 0.5%")
    if "tp_0_est" in cols:
        tp0 = cols["tp_0_est"]
        ok = good & np.isfinite(tp0)
        d = tp0[ok] / DT - t0[ok]
        med = float(np.median(d))
        print(f"[{label}] tp_0_est/16 ns - injected t0: median {med:.1f} "
              f"samples, 1st-99th percentile {np.percentile(d, 1):.1f} to "
              f"{np.percentile(d, 99):.1f}, on {int(ok.sum())} events", flush=True)
        if abs(med + 65) > 2:
            raise AssertionError("tp_0_est is not 65 samples before the injected t0")
        for k in range(2, len(CASCADE)):
            link = cols[CASCADE[k]]
            start = cols[CASCADE[CASCADE_STARTS[k]]]
            both = np.isfinite(link) & np.isfinite(start)
            if (link[both] > start[both]).any():
                raise AssertionError(f"{CASCADE[k]} lies after its start")
    if "A_max" in cols:
        aoe_checks(cols, good, amp, t0, rt, label, AOE_RATIO[aoe_geometry[3]])
    n_ex, worst = compare_columns(cols, cpu, wf, bl, n_cpu, aoe_geometry)
    print(f"[{label}] first {n_cpu} events vs the port's CPU run: worst "
          f"|diff|/max|col| {worst:.3e}, {n_ex} events excused", flush=True)
    for name in expect:
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"{name} was not launched on the {label} path")
    for name in forbid:
        if launches.get(name, 0) != 0:
            raise AssertionError(f"{name} was launched on the {label} path")
    if group_splits:
        raise AssertionError(
            f"generic groups split on the {label} path: {group_splits}")
    return launches


def pipeline_phase(build_dsp, build_processing_chain, lh5, _cuda, wf, bl, card,
                   expect):
    """The flagship through ``build_dsp``'s production loop
    (``run_pipeline``) over ``PIPELINE_CHUNKS`` chunks of distinct events
    (``distinct_chunks``), twice, on one chain: every output of every chunk
    must equal, bit for bit, the synchronous ``chain(chunk)`` of the same
    chain on the same chunk. Launch counts are read around the first pass:
    each kernel of ``expect`` once a chunk. A third pass over one chunk runs
    under ``torch.cuda.set_sync_debug_mode("warn")`` and lists where the
    host waits for the device. Returns the figures."""
    import traceback
    import warnings
    from collections import Counter

    import torch

    tables = distinct_chunks(lh5, wf, bl, PIPELINE_CHUNKS)
    total = sum(len(t) for t in tables)
    chain, _, tb_out = build_processing_chain(
        config(), tables[0], db_dict={"pz": {"tau": TAU}}, device=DEVICE
    )
    torch.cuda.synchronize()
    _cuda.reset_launches()
    got, split, first_s = run_pipeline(build_dsp, chain, tb_out, tables)
    launches = dict(_cuda.LAUNCHES)
    got2, split2, warm_s = run_pipeline(build_dsp, chain, tb_out, tables)
    for name in expect:
        if launches.get(name, 0) != len(tables):
            raise AssertionError(f"pipeline: {name} launched "
                                 f"{launches.get(name, 0)} times on "
                                 f"{len(tables)} chunks")
    syncs: Counter = Counter()
    pkg = os.path.join(REPO, "dspeed_tpu_torch")
    armed = [False]

    def record(message, category, filename, lineno, file=None, line=None):
        # the warning's own site, and the innermost frame of the port (of
        # this script, where none) on the thread that waited
        if not armed[0] or "synchroniz" not in str(message):
            return
        stack = traceback.extract_stack()[:-1]
        ours = ([f for f in stack if f.filename.startswith(pkg)]
                or [f for f in stack if f.filename.startswith(REPO)])
        via = (f" via {os.path.relpath(ours[-1].filename, REPO)}:"
               f"{ours[-1].lineno} ({ours[-1].name})" if ours else "")
        syncs[f"{os.path.basename(filename)}:{lineno}{via}"] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        armed[0] = True
        try:
            run_pipeline(build_dsp, chain, tb_out, tables[:1])
        finally:
            armed[0] = False
            torch.cuda.set_sync_debug_mode("default")
    # the synchronous path, chunk by chunk, on the same chain
    torch.cuda.synchronize()
    t_0 = time.time()
    want, i_entry = {}, 0
    for tb in tables:
        out = chain(tb)
        want[i_entry] = {k: np.array(col.nda[: len(tb)]) for k, col in out.items()}
        i_entry += len(tb)
    sync_s = time.time() - t_0
    for label, run in (("first", got), ("warm", got2)):
        if sorted(run) != sorted(want):
            raise AssertionError(f"pipeline [{label} pass]: chunks written at "
                                 f"{sorted(run)}, not {sorted(want)}")
        for i_entry, cols in want.items():
            for k, w in cols.items():
                g = run[i_entry][k]
                if g.dtype != w.dtype or g.tobytes() != w.tobytes():
                    raise AssertionError(
                        f"pipeline [{label} pass]: {k} of the chunk at entry "
                        f"{i_entry} differs from the synchronous call")
    print(f"pipeline [flagship] {len(tables)} chunks x {len(tables[0])} events, "
          f"{len(want[0])} columns, every output of every chunk equal to the "
          f"synchronous call bit for bit; launches {launches}", flush=True)
    print(f"pipeline [flagship] first pass {first_s:.3f} s ({total / first_s:.0f} "
          f"wf/s), warm pass {warm_s:.3f} s ({total / warm_s:.0f} wf/s), the "
          f"synchronous calls {sync_s:.3f} s ({total / sync_s:.0f} wf/s); split "
          f"of the warm pass (s): {json.dumps(split2)}; first pass: "
          f"{json.dumps(split)}; on {card}", flush=True)
    print(f"pipeline [flagship] host waits on the device in one pipelined chunk "
          f"(set_sync_debug_mode): {json.dumps(dict(syncs))}", flush=True)
    return dict(first_wfps=total / first_s, warm_wfps=total / warm_s,
                sync_wfps=total / sync_s, split=split2, syncs=dict(syncs),
                launches=launches)


def auto_buffer_len_line(build_dsp, card) -> int:
    """``buffer_len="auto"``'s probe on the card: the pick and the rates."""
    driver = sys.modules[build_dsp.__module__]
    rates: dict = {}
    pick = driver._auto_buffer_len(DEVICE, rates=rates)
    print(f"buffer_len='auto': picked {pick}; events/s by candidate "
          f"{json.dumps({n: round(r) for n, r in rates.items()})}; on {card}",
          flush=True)
    if pick not in rates:
        raise AssertionError(f"buffer_len='auto' picked {pick}, not a candidate")
    return pick


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        from dspeed_tpu_torch import build_dsp, build_processing_chain, lh5
        from dspeed_tpu_torch.processors import _cuda
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    card = card_line()
    print(card, flush=True)
    print(
        f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, devices {torch.cuda.device_count()}",
        flush=True,
    )

    # -- build -------------------------------------------------------------
    t0 = time.time()
    logs = _cuda.build_all(verbose=True)
    print(f"kernel build: {time.time() - t0:.2f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "smem" in line:
                print(f"  {name}: {line.strip()}")

    # -- inputs ------------------------------------------------------------
    t0 = time.time()
    wf, amp, inj_t0, bl, rt = make_hpge_waveforms(N_EVENTS)
    print(f"inputs: {N_EVENTS}x{N_SAMPLES} f32 made in {time.time() - t0:.2f} s",
          flush=True)
    w = torch.from_numpy(wf).to(dev)
    b = torch.from_numpy(bl.astype(np.float32)).to(dev)
    w_nan = w.clone()
    b_nan = b.clone()
    w_nan[7, 123] = float("nan")
    w_nan[1000, 4000] = float("nan")
    b_nan[11] = float("nan")

    # -- K1 ----------------------------------------------------------------
    # the energy configuration's spec set
    energy = k1_phase(
        _cuda, w_nan, b_nan, "energy", trap_specs=[("norm", 625, 188)],
        emax_for=[0], slope_specs=[(0, 0, 750), (1, 1500, 4096)],
        mask_specs=[], emit_blsub=True, emit_minmax=True,
    )
    extra = k1_phase(
        _cuda, w_nan, b_nan, "asym+mask",
        trap_specs=[("norm", 625, 188), ATRAP], emax_for=[0, 1],
        slope_specs=[(0, 0, 750), (1, 1500, 4096)],
        mask_specs=[(ATRAP, 0, 1, False, True)], emit_blsub=False,
        emit_minmax=False,
    )
    # the flagship's spec set, which its main path and the timing
    # configuration's launch: trapTmax/trapEmax (one CSE'd trap), the QDrift
    # trap, tp_0_atrap's mask
    timing_k1 = dict(
        trap_specs=[("norm", 625, 188), ("norm", 250, 6)], emax_for=[0],
        slope_specs=[(0, 0, 750), (1, 1500, 4096)],
        mask_specs=[(ATRAP, 0, 1, False, True)], emit_blsub=True,
        emit_minmax=True,
    )
    k1 = k1_phase(_cuda, w_nan, b_nan, "flagship", **timing_k1)
    k1["max_abs_err"] = max(
        k1["max_abs_err"], energy["max_abs_err"], extra["max_abs_err"]
    )
    k1["spec_sets"] = {
        label: {q: fig[q] for q in ("ms", "plain_ms", "bound_ms", "byte_share")}
        for label, fig in (("flagship", k1), ("energy", energy), ("asym+mask", extra))
    }

    # -- K4 ----------------------------------------------------------------
    probe = lh5.Table({
        "waveform": lh5.WaveformTable(
            values=wf[:2], t0=0.0, t0_units="ns", dt=DT, dt_units="ns"
        ),
        "baseline": lh5.Array(bl[:2].astype(np.float32)),
    })
    chain, _, _ = build_processing_chain(
        config(), probe, db_dict={"pz": {"tau": TAU}}, device="cpu"
    )
    consts = {
        k: np.asarray(chain._vars_dict[k].const_value)
        for k in ("cusp_kernel", "zac_kernel", "t0_kernel")
    }
    bank = [consts["cusp_kernel"], consts["zac_kernel"]]
    m = bank[0].shape[-1]
    n_in = N_SAMPLES - round(33.6e3 / DT)
    p = n_in - m + 1
    k4 = k4_phase(_cuda, w_nan, bank, m - 1, p, n_in, "flagship v",
                  logs["banded_conv"])
    t0_taps = consts["t0_kernel"]
    k4s = k4_phase(_cuda, w_nan, [t0_taps], (len(t0_taps) - 1) // 2, N_SAMPLES,
                   None, f"s, {len(t0_taps)} taps", logs["banded_conv"])
    k4["max_abs_err"] = max(k4["max_abs_err"], k4s["max_abs_err"])
    k4["s_window"] = {
        q: k4s[q] for q in ("ms", "plain_ms", "bound_ms", "library_ms",
                            "bound_share", "launch", "ptxas")
    }

    # -- K3 on the card's own wf_pz, with bl_std as the threshold ------------
    outs = _cuda.fused_energy(w_nan, b_nan, TAU, **timing_k1)
    pz, (trap_t, _trap_q), (trap_tmax,) = outs[0], outs[1], outs[2]
    bl_std = outs[3 + 1]  # slope spec 0 (wf_blsub[0:750]), stdev
    a_std = bl_std.clone()
    a_std[13] = float("nan")
    del outs, trap_t, _trap_q
    t0_log = logs["fused_t0"]
    t0_out, k3 = k3_phase(_cuda, pz, t0_taps, a_std, "flagship", t0_log)
    _, k3a = k3_phase(_cuda, pz, t0_taps, a_std, "flagship+atrap", t0_log,
                      atrap_spec=ATRAP)
    # as the flagship chain launches it: with the absorbed A/E current
    t0c_out, k3c = k3_phase(_cuda, pz, t0_taps, a_std, "flagship+curr",
                            t0_log, curr_spec=CURR_SPEC)
    k3["max_abs_err"] = max(
        k3["max_abs_err"], k3a["max_abs_err"], k3c["max_abs_err"]
    )
    k3.update(curr_spec_ms=k3c["ms"], curr_spec_plain_ms=k3c["plain_ms"],
              curr_spec_bound_ms=k3c["bound_ms"],
              curr_spec_bound_share=k3c["bound_share"],
              atrap_ms=k3a["ms"], atrap_plain_ms=k3a["plain_ms"],
              atrap_bound_ms=k3a["bound_ms"], atrap_launch=k3a["launch"])

    # -- K2: trapTmax as the base, K3's tp_0 as the start ---------------------
    k2 = k2_phase(_cuda, pz, trap_tmax, t0_out[4], logs["cascade_tp"])

    # -- K5 and K6 on K3's current -------------------------------------------
    curr = t0c_out[5]
    k5 = k5_phase(_cuda, curr, logs["fused_current"])
    k6 = k6_phase(_cuda, curr, logs["fused_current"])
    del pz, trap_tmax, bl_std, a_std, t0_out, t0c_out, curr, w, b, w_nan, b_nan
    torch.cuda.empty_cache()

    # -- K7 on the generic flagship's two groups --------------------------------
    k7 = k7_phase(build_processing_chain, lh5, _cuda, wf, bl, dev,
                  logs["generic_rows"])
    torch.cuda.empty_cache()

    # -- the SiPM chain's K7 group, then the peak finder's sweep on its curr --
    t0 = time.time()
    swf, n_pulses = make_sipm_waveforms(N_EVENTS)
    print(f"SiPM inputs: {N_EVENTS}x{SIPM_SAMPLES} f32 made in "
          f"{time.time() - t0:.2f} s", flush=True)
    k7["sipm_group"], curr = sipm_k7_phase(
        build_processing_chain, lh5, _cuda, sipm_edge_rows(swf), dev)
    scan = sipm_scan_phase(_cuda, curr)
    del curr
    torch.cuda.empty_cache()

    # -- the main paths: build_dsp -------------------------------------------
    launches = e2e_phase(
        build_dsp, lh5, _cuda, config(), wf, amp, inj_t0, bl, card, "flagship",
        expect=("fused_energy", "cascade_tp", "fused_t0", "banded_conv_multi",
                "fused_current_poly"),
        rt=rt, device=DEVICE,
    )
    # the A/E window at 128 upsampled samples: no polyphase plan, so the
    # front takes the up-domain route, K6, once a chunk
    l128_launches = e2e_phase(
        build_dsp, lh5, _cuda, l128_config(), wf, amp, inj_t0, bl, card,
        "flagship L128",
        expect=("fused_energy", "cascade_tp", "fused_t0", "banded_conv_multi",
                "fused_current"),
        rt=rt, device=DEVICE, forbid=("fused_current_poly",),
        aoe_geometry=AOE_L128_GEOMETRY,
    )
    # the generic mode: no hand pattern, the two groups as two K7 launches
    gen_launches = e2e_phase(
        build_dsp, lh5, _cuda, config(), wf, amp, inj_t0, bl, card,
        "flagship generic", expect=("generic_rows", "banded_conv_multi"),
        rt=rt, device=DEVICE, fuse="generic",
        forbid=("fused_energy", "cascade_tp", "fused_t0", "fused_current_poly",
                "fused_current"),
    )
    if gen_launches["generic_rows"] != 2:
        raise AssertionError(
            f"generic_rows launched {gen_launches['generic_rows']} times on one "
            f"chunk of the generic flagship, not 2"
        )
    e2e_phase(
        build_dsp, lh5, _cuda, timing_config(), wf, amp, inj_t0, bl, card,
        "timing",
        expect=("fused_energy", "cascade_tp", "fused_t0", "banded_conv_multi"),
        device=DEVICE,
    )
    e2e_phase(
        build_dsp, lh5, _cuda, energy_config(), wf, amp, inj_t0, bl, card,
        "energy", expect=("fused_energy", "banded_conv_multi"), device=DEVICE,
    )
    torch.cuda.empty_cache()
    # the flagship through the production loop: read-ahead, staging on the
    # copy stream, write-behind, over chunks of distinct events
    pipeline_phase(
        build_dsp, build_processing_chain, lh5, _cuda, wf, bl, card,
        expect=("fused_energy", "cascade_tp", "fused_t0", "banded_conv_multi",
                "fused_current_poly"),
    )
    auto_buffer_len_line(build_dsp, card)
    # the SiPM path: VoV outputs, K7's group and the sweep
    sipm = sipm_e2e_phase(build_dsp, lh5, _cuda, swf, n_pulses, card)
    scan["sipm_wfps"] = {"first": sipm["first_wfps"], "warm": sipm["warm_wfps"]}
    scan["pipeline"] = sipm_pipeline_phase(build_dsp, build_processing_chain, lh5,
                                           _cuda, swf, card)

    kernels = [
        dict(
            name="fused_energy", route="cuda",
            source="dspeed_tpu_torch/csrc/fused_energy.cu",
            replaces="dspeed_tpu/processors/_pallas.py:287",
            launches=launches["fused_energy"], library_ms=None, **k1,
        ),
        dict(
            name="cascade_tp", route="cuda",
            source="dspeed_tpu_torch/csrc/cascade_tp.cu",
            replaces="dspeed_tpu/processors/_pallas.py:1528",
            launches=launches["cascade_tp"], library_ms=None, **k2,
        ),
        dict(
            name="fused_t0", route="cuda",
            source="dspeed_tpu_torch/csrc/fused_t0.cu",
            replaces="dspeed_tpu/processors/_pallas.py:1140",
            launches=launches["fused_t0"], library_ms=None, **k3,
        ),
        dict(
            name="banded_conv_multi", route="cuda",
            source="dspeed_tpu_torch/csrc/banded_conv.cu",
            replaces="dspeed_tpu/processors/_pallas.py:999",
            launches=launches["banded_conv_multi"], **k4,
        ),
        dict(
            name="fused_current_poly", route="cuda",
            source="dspeed_tpu_torch/csrc/fused_current.cu",
            replaces="dspeed_tpu/processors/_pallas.py:804",
            launches=launches["fused_current_poly"], library_ms=None, **k5,
        ),
        dict(
            name="fused_current", route="cuda",
            source="dspeed_tpu_torch/csrc/fused_current.cu",
            replaces="dspeed_tpu/processors/_pallas.py:572",
            launches=l128_launches["fused_current"], library_ms=None, **k6,
        ),
        dict(
            name="generic_rows", route="cuda",
            source="dspeed_tpu_torch/csrc/generic_rows.cu",
            replaces="dspeed_tpu/processors/_pallas.py:1782",
            launches=gen_launches["generic_rows"], library_ms=None, **k7,
        ),
        dict(
            name="peakdet_scan", route="cuda",
            source="dspeed_tpu_torch/csrc/peakdet_scan.cu",
            replaces="dspeed_tpu/processors/peak_finding.py:49 (lax.scan)",
            launches=sipm["launches"]["peakdet_scan"], library_ms=None, **scan,
        ),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
