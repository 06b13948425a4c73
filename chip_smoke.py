#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's hand-written CUDA kernels from ``dspeed_tpu_torch/csrc``,
holds each against its plain PyTorch version on the card at the main path's
shapes (16384 events x 4096 samples, NaN rows included), times kernel, plain
version and a library yardstick with CUDA events, then drives the main path:
``build_dsp`` file->file over 16384 synthetic HPGe events with the energy
configuration of ``configs/hpge-energy-timing.yaml`` (Table -> Table where
``h5py`` is missing). It checks the physics
(``trapEmax`` against the injected amplitudes), the first 256 events against
the port's own CPU run, and that every kernel of the path was launched.

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
EXACT_OUTPUTS = ("tp_min", "tp_max")
TAU = 27460.5
N_EVENTS = 16384
N_SAMPLES = 4096
REL_TOL = 1e-5  # |kernel - plain| <= REL_TOL * max|plain| per output column
NAN_SAMPLE_ROW = 3  # end-to-end input: this event holds a NaN sample
NAN_BASELINE_ROW = 5  # and this one a NaN baseline
# H100 SXM peaks (NVIDIA data sheet): HBM3, f32 and f64 outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
PEAK_F64_S = 34e12


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


def energy_config() -> dict:
    import yaml

    with open(CONFIG) as f:
        cfg = yaml.safe_load(f)
    cfg["outputs"] = list(ENERGY_OUTPUTS)
    return cfg


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
            trap = flat_want[1 + list(trap_specs).index(sp)]
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
    # f64: two prefix adds per sample and 4 per trap sample; f32: subtract
    # and pole-zero multiply-add per sample
    f64_ops = B * n * (2 + 4 * len(trap_specs))
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


def e2e_phase(build_dsp, lh5, _cuda, cfg, wf, amp, bl, card, device="cuda"):
    """The main path: ``build_dsp`` over every event of ``wf`` on
    ``device``, file -> file where ``h5py`` is installed, else Table ->
    Table; launch counts read around the first run; physics and CPU
    cross-checks on the output. Event ``NAN_SAMPLE_ROW`` gets a NaN sample
    and event ``NAN_BASELINE_ROW`` a NaN baseline, so the NaN rules are
    checked end to end. Returns the launch counts."""
    import importlib.util

    import torch

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
            values=wf, t0=0.0, t0_units="ns", dt=16.0, dt_units="ns"
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
                    return {k: f[f"ch001/dsp/{k}"][()] for k in ENERGY_OUTPUTS}
        else:
            def run(dev, n):
                out = build_dsp(tb, dsp_config=cfg, database={"pz": {"tau": TAU}},
                                n_entries=n, buffer_len=n, device=dev)
                return {k: np.asarray(out[k].nda) for k in ENERGY_OUTPUTS}

        route = "file -> file" if files else "Table -> Table (no h5py)"

        def timed(dev, n):
            torch.cuda.synchronize()
            t0 = time.time()
            cols = run(dev, n)
            torch.cuda.synchronize()
            return cols, time.time() - t0

        _cuda.reset_launches()
        cols, cold_s = timed(device, n_ev)
        launches = dict(_cuda.LAUNCHES)
        print(f"build_dsp launches: {launches}", flush=True)
        cols, warm_s = timed(device, n_ev)
        print(
            f"build_dsp {route}, {n_ev} events: first call {cold_s:.3f} s "
            f"({n_ev / cold_s:.0f} wf/s), second call {warm_s:.3f} s "
            f"({n_ev / warm_s:.0f} wf/s) on {card}",
            flush=True,
        )
        cpu = run("cpu", n_cpu)
    for k, v in cols.items():
        if v.shape != (n_ev,) or not np.isfinite(v[good]).all():
            raise AssertionError(f"{k}: shape {v.shape} or non-finite values")
        # a NaN baseline leaves the raw waveform's extrema intact
        raw_only = k in ("tp_min", "tp_max", "wf_min", "wf_max")
        nan_rows = [NAN_SAMPLE_ROW] if raw_only else [NAN_SAMPLE_ROW, NAN_BASELINE_ROW]
        if not np.isnan(v[nan_rows]).all():
            raise AssertionError(f"{k}: a NaN row was not poisoned")
    rel = np.abs(cols["trapEmax"][good] / amp[good] - 1)
    print(f"trapEmax vs injected amplitude: max {rel.max():.4%}, "
          f"median {np.median(rel):.4%}", flush=True)
    if rel.max() > 0.005:
        raise AssertionError("trapEmax misses the injected amplitudes by > 0.5%")
    worst = 0.0
    for k in ENERGY_OUTPUTS:
        a, c = cols[k][:n_cpu].astype(np.float64), cpu[k].astype(np.float64)
        if not np.array_equal(np.isnan(a), np.isnan(c)):
            raise AssertionError(f"{k}: NaN positions differ from the CPU run")
        err = np.nanmax(np.abs(a - c))
        limit = 0.0 if k in EXACT_OUTPUTS else REL_TOL * np.nanmax(np.abs(c))
        if err > limit:
            raise AssertionError(f"{k}: card vs CPU max diff {err:.3e} > {limit:.3e}")
        worst = max(worst, err / max(np.nanmax(np.abs(c)), 1e-30))
    print(f"first {n_cpu} events vs the port's CPU run: worst "
          f"|diff|/max|col| {worst:.3e}", flush=True)
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
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
    dev = torch.device("cuda")
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
    wf, amp, _t0, bl = make_hpge_waveforms(N_EVENTS)
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
    atrap = ("asym", 8, 4, 125)
    extra = k1_phase(
        _cuda, w_nan, b_nan, "asym+mask",
        trap_specs=[("norm", 625, 188), atrap], emax_for=[0, 1],
        slope_specs=[(0, 0, 750), (1, 1500, 4096)],
        mask_specs=[(atrap, 0, 1, False, True)], emit_blsub=False,
        emit_minmax=False,
    )
    k1 = dict(flag, max_abs_err=max(flag["max_abs_err"], extra["max_abs_err"]))

    # -- K4 ----------------------------------------------------------------
    cfg = energy_config()
    probe = lh5.Table({
        "waveform": lh5.WaveformTable(
            values=wf[:2], t0=0.0, t0_units="ns", dt=16.0, dt_units="ns"
        ),
        "baseline": lh5.Array(bl[:2].astype(np.float32)),
    })
    chain, _, _ = build_processing_chain(
        cfg, probe, db_dict={"pz": {"tau": TAU}}, device="cpu"
    )
    bank = [
        np.asarray(chain._vars_dict[k].const_value)
        for k in ("cusp_kernel", "zac_kernel")
    ]
    m = bank[0].shape[-1]
    n_in = N_SAMPLES - round(33.6e3 / 16.0)
    p = n_in - m + 1
    k4 = k4_phase(_cuda, w_nan, bank, m - 1, p, n_in, "flagship v")
    t0_taps = np.random.default_rng(5).normal(size=133)
    k4s = k4_phase(_cuda, w_nan, [t0_taps], 66, N_SAMPLES, None, "s, 133 taps")
    k4["max_abs_err"] = max(k4["max_abs_err"], k4s["max_abs_err"])

    # -- end to end: build_dsp file -> file ----------------------------------
    launches = e2e_phase(build_dsp, lh5, _cuda, cfg, wf, amp, bl, card)

    kernels = [
        dict(
            name="fused_energy", route="cuda",
            source="dspeed_tpu_torch/csrc/fused_energy.cu",
            replaces="dspeed_tpu/processors/_pallas.py:287",
            launches=launches["fused_energy"], library_ms=None, **k1,
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
