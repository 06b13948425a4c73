#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's hand-written CUDA kernels from ``dspeed_tpu_torch/csrc``
(K1 energy front, K2 rise-time cascade, K3 t0 front, K4 convolution bank),
holds each against its plain PyTorch version on the card at the main path's
shapes (16384 events x 4096 samples, NaN rows included), times kernel, plain
version and a library yardstick with CUDA events, then drives the main
paths: ``build_dsp`` over 16384 synthetic HPGe events with the **timing
configuration** (``configs/hpge-energy-timing.yaml`` without its three A/E
columns, 31 outputs) and with the **energy configuration** (its 17 energy
and baseline columns), file -> file where ``h5py`` is installed, else Table
-> Table. It checks the physics (``trapEmax`` against the injected
amplitudes, ``tp_0_est`` against the injected start, the order of the
cascade), the first 256 events against the port's own CPU run, and that
every kernel of each path was launched on it.

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
AOE_OUTPUTS = ("A_max", "tp_aoe_max", "tp_aoe_samp")  # the A/E slice's
CASCADE = ["tp_100", "tp_99", "tp_95", "tp_90", "tp_80", "tp_50", "tp_20",
           "tp_10", "tp_01"]
# the flagship's cascade (tp_chain links): thresholds factor * trapTmax,
# walk forward (1) or back (0), start from tp_0_est (-1) or an earlier link
CASCADE_FACTORS = [1, 0.99, 0.95, 0.9, 0.8, 0.5, 0.2, 0.1, 0.01]
CASCADE_DIRS = [1, 1, 0, 0, 0, 0, 0, 0, 0]
CASCADE_STARTS = [-1, -1, 1, 2, 3, 4, 5, 6, 7]
# columns that read tp_0_est: excused on an event whose tp_0_est moved by
# one sample because two f32 convolutions rounded differently
READS_TP0 = ("trapEftp", "QDrift", "dt_eff", "tp_0_atrap", *CASCADE)
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


def make_hpge_waveforms(n, nsamp=N_SAMPLES, seed=11, dt=16.0):
    """Synthetic HPGe pulses: flat baseline, linear rise over ``rt`` samples
    at ``t0``, then exponential decay with tau=27460.5 samples (the
    generator ``make_hpge_waveforms`` of ``tests/test_build_dsp.py``)."""
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
    return wf.astype("float32"), amp, t0, bl


def config(outputs=None) -> dict:
    """The flagship YAML with its outputs cut to ``outputs`` (default: the
    timing configuration, every column but the A/E ones)."""
    import yaml

    with open(CONFIG) as f:
        cfg = yaml.safe_load(f)
    if outputs is None:
        outputs = [o for o in cfg["outputs"] if o not in AOE_OUTPUTS]
    cfg["outputs"] = list(outputs)
    return cfg


def energy_config() -> dict:
    return config(ENERGY_OUTPUTS)


def is_index(col: str) -> bool:
    return col.startswith("tp_")


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
    # is evaluated at three samples, a window of <= 32 summed directly);
    # f32: subtract and pole-zero multiply-add per sample
    mask_ops = sum(3 * (sp[1] + 4 if sp[1] <= 32 else 4) for sp, *_ in mask_specs)
    f64_ops = B * n * (2 + 4 * len(trap_specs) + mask_ops)
    f32_ops = B * n * 3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = (f64_ops / PEAK_F64_S + f32_ops / PEAK_F32_S) * 1e3
    print(
        f"K1 fused_energy [{label}] {B}x{n}: max_abs_err {max_err:.3e}, "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{max(t_bytes, t_ops):.4f} ms ({'bytes' if t_bytes >= t_ops else 'operations'})",
        flush=True,
    )
    return dict(
        max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
        bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
    )


def k4_phase(_cuda, w, kerns, lo, p, n_in, label):
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
    print(
        f"K4 banded_conv_multi [{label}] {B}x{n} nk={nk} m={m} p={p} "
        f"lo={lo}: max_abs_err {max_err:.3e}, kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, conv1d {library_ms:.4f} ms (max |conv1d - "
        f"plain| / max|plain| {lib_err:.3e}), bound {max(t_bytes, t_ops):.4f} ms "
        f"({'bytes' if t_bytes >= t_ops else 'operations'})",
        flush=True,
    )
    return dict(
        max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
        bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=library_ms,
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


def k3_phase(_cuda, w, taps, a, label, atrap_spec=None):
    """K3 against its plain version on the card (rows of ``w`` with a NaN
    and a NaN threshold included); returns its figures."""
    import torch

    from dspeed_tpu_torch.processors.trap_filters import asym_trap_filter

    got = _cuda.fused_t0(w, taps, a, atrap_spec=atrap_spec)
    want = _cuda.fused_t0_plain(w, taps, a, atrap_spec=atrap_spec)
    torch.cuda.synchronize()
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
    ms = time_ms(lambda: _cuda.fused_t0(w, taps, a, atrap_spec=atrap_spec), 20)
    plain_ms = time_ms(
        lambda: _cuda.fused_t0_plain(w, taps, a, atrap_spec=atrap_spec), 3, 1
    )
    nout = 5 + (atrap_spec is not None)
    nbytes = 4 * B * n + 4 * B + 4 * m + 4 * B * nout
    f32_ops = 2 * m * n * B
    # the absorbed trap: one f64 prefix add, the short rise window summed
    # directly, the fall window differenced, two divides and a subtract
    f64_ops = B * n * (atrap_spec[1] + 5) if atrap_spec is not None else 0
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = (f32_ops / PEAK_F32_S + f64_ops / PEAK_F64_S) * 1e3
    max_err = max(errs.values())
    print(
        f"K3 fused_t0 [{label}] {B}x{n} m={m}: max_abs_err {max_err:.3e}, "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{max(t_bytes, t_ops):.4f} ms ({'bytes' if t_bytes >= t_ops else 'operations'})",
        flush=True,
    )
    return got, dict(
        max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
        bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
    )


def k2_phase(_cuda, w, base, t_start):
    """K2 against its plain version on the card, bit for bit, with rows of
    a NaN base and of NaN, non-integral, negative and out-of-range starts
    added; returns its figures."""
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
    plain_ms = time_ms(lambda: _cuda.cascade_tp_plain(*args), 3, 1)
    m = len(CASCADE_FACTORS)
    nbytes = 4 * B * n + 4 * B * m + 4 * B + 4 * B * m
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = 4 * walked / PEAK_F32_S * 1e3
    print(
        f"K2 cascade_tp {B}x{n}, {m} links: bit-identical to the plain version "
        f"(found per link {found}), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {max(t_bytes, t_ops):.4f} ms "
        f"({'bytes' if t_bytes >= t_ops else 'operations'})",
        flush=True,
    )
    return dict(
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
        bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
    )


def compare_columns(cols, cpu, wf, bl, n_cpu) -> tuple[int, float]:
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


def e2e_phase(build_dsp, lh5, _cuda, cfg, wf, amp, t0, bl, card, label,
              expect, device="cuda"):
    """A main path: ``build_dsp`` of ``cfg`` over every event of ``wf`` on
    ``device``, file -> file where ``h5py`` is installed, else Table ->
    Table; launch counts read around the first run, and each kernel of
    ``expect`` must have been launched; physics and CPU cross-checks on the
    output. Event ``NAN_SAMPLE_ROW`` gets a NaN sample and event
    ``NAN_BASELINE_ROW`` a NaN baseline, so the NaN rules are checked end
    to end. Returns the launch counts."""
    import importlib.util

    import torch

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

            def run(dev, n):
                out = os.path.join(tmp, f"smoke_dsp_{dev}.lh5")
                build_dsp(raw, out, cfg, database={"ch001": {"pz": {"tau": TAU}}},
                          n_entries=n, buffer_len=n, device=dev, write_mode="r")
                with h5py.File(out, "r") as f:
                    return {k: f[f"ch001/dsp/{k}"][()] for k in outputs}
        else:
            def run(dev, n):
                out = build_dsp(tb, dsp_config=cfg, database={"pz": {"tau": TAU}},
                                n_entries=n, buffer_len=n, device=dev)
                return {k: np.asarray(out[k].nda) for k in outputs}

        route = "file -> file" if files else "Table -> Table (no h5py)"

        def timed(dev, n):
            torch.cuda.synchronize()
            t_0 = time.time()
            cols = run(dev, n)
            torch.cuda.synchronize()
            return cols, time.time() - t_0

        _cuda.reset_launches()
        cols, cold_s = timed(device, n_ev)
        launches = dict(_cuda.LAUNCHES)
        print(f"build_dsp [{label}] launches: {launches}", flush=True)
        cols, warm_s = timed(device, n_ev)
        print(
            f"build_dsp [{label}] {route}, {n_ev} events, {len(outputs)} "
            f"columns: first call {cold_s:.3f} s ({n_ev / cold_s:.0f} wf/s), "
            f"second call {warm_s:.3f} s ({n_ev / warm_s:.0f} wf/s) on {card}",
            flush=True,
        )
        cpu = run("cpu", n_cpu)
    searches = ("tp_0_est", *READS_TP0)
    not_found = {}
    for k, v in cols.items():
        if v.shape != (n_ev,):
            raise AssertionError(f"{k}: shape {v.shape}")
        if k in searches:
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
    n_ex, worst = compare_columns(cols, cpu, wf, bl, n_cpu)
    print(f"[{label}] first {n_cpu} events vs the port's CPU run: worst "
          f"|diff|/max|col| {worst:.3e}, {n_ex} events excused", flush=True)
    for name in expect:
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"{name} was not launched on the {label} path")
    return launches


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
    wf, amp, inj_t0, bl = make_hpge_waveforms(N_EVENTS)
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
    flag = k1_phase(
        _cuda, w_nan, b_nan, "flagship", trap_specs=[("norm", 625, 188)],
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
    # the timing configuration's spec set, which its main path launches:
    # trapTmax/trapEmax (one CSE'd trap), the QDrift trap, tp_0_atrap's mask
    timing_k1 = dict(
        trap_specs=[("norm", 625, 188), ("norm", 250, 6)], emax_for=[0],
        slope_specs=[(0, 0, 750), (1, 1500, 4096)],
        mask_specs=[(ATRAP, 0, 1, False, True)], emit_blsub=True,
        emit_minmax=True,
    )
    k1 = k1_phase(_cuda, w_nan, b_nan, "timing", **timing_k1)
    k1["max_abs_err"] = max(
        k1["max_abs_err"], flag["max_abs_err"], extra["max_abs_err"]
    )

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
    k4 = k4_phase(_cuda, w_nan, bank, m - 1, p, n_in, "flagship v")
    t0_taps = consts["t0_kernel"]
    k4s = k4_phase(_cuda, w_nan, [t0_taps], (len(t0_taps) - 1) // 2, N_SAMPLES,
                   None, f"s, {len(t0_taps)} taps")
    k4["max_abs_err"] = max(k4["max_abs_err"], k4s["max_abs_err"])

    # -- K3 on the card's own wf_pz, with bl_std as the threshold ------------
    outs = _cuda.fused_energy(w_nan, b_nan, TAU, **timing_k1)
    pz, (trap_t, _trap_q), (trap_tmax,) = outs[0], outs[1], outs[2]
    bl_std = outs[3 + 1]  # slope spec 0 (wf_blsub[0:750]), stdev
    a_std = bl_std.clone()
    a_std[13] = float("nan")
    del outs, trap_t, _trap_q
    t0_out, k3 = k3_phase(_cuda, pz, t0_taps, a_std, "flagship")
    _, k3a = k3_phase(_cuda, pz, t0_taps, a_std, "flagship+atrap",
                      atrap_spec=ATRAP)
    k3["max_abs_err"] = max(k3["max_abs_err"], k3a["max_abs_err"])

    # -- K2: trapTmax as the base, K3's tp_0 as the start ---------------------
    k2 = k2_phase(_cuda, pz, trap_tmax, t0_out[4])
    del pz, trap_tmax, bl_std, a_std, t0_out, w, b, w_nan, b_nan
    torch.cuda.empty_cache()

    # -- the main paths: build_dsp -------------------------------------------
    launches = e2e_phase(
        build_dsp, lh5, _cuda, config(), wf, amp, inj_t0, bl, card, "timing",
        expect=("fused_energy", "cascade_tp", "fused_t0", "banded_conv_multi"),
        device=DEVICE,
    )
    e2e_phase(
        build_dsp, lh5, _cuda, energy_config(), wf, amp, inj_t0, bl, card,
        "energy", expect=("fused_energy", "banded_conv_multi"), device=DEVICE,
    )

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
