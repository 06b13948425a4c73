#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's hand-written CUDA kernels from ``dspeed_tpu_torch/csrc``
(K1 energy front, K2 rise-time cascade, K3 t0 front with its absorbed A/E
current, K4 convolution bank, K5 and K6 the A/E current front's polyphase
and up-domain routes, K7 the generic fusion groups' row-tape interpreter,
the SiPM peak finder's sweep, which replaces a ``lax.scan``, and the
recurrence kernel of the recursive-filter family, which replaces scans
and blocked matmuls,
and the bi-level trigger's sweep, which replaces a ``lax.scan``),
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
The **flagship DPZ** (``dpz_config``: the flagship with ``double_pole_zero``
in place of ``pole_zero``, on ``make_hpge_dpz_waveforms``' two-exponential
tails): the recurrence kernel through each of its clients, bit for bit
against the plain recurrence; K7 on its two groups (the energy front, with
``double_pole_zero``'s op, and the second), the op's plane bit for bit
against the plain walk and within REL_TOL of ``double_pole_zero`` called
alone; ``build_dsp`` twice over 16384 events (K7 twice a chunk, K3, K2, K5
and K4 once, K1 and the recurrence never, no split; ``trapEmax`` within the
JAX package's own worst error on the same events).
Then the **SiPM path** (``configs/sipm-pulse-finding.yaml``, 16384 events x
1024 samples, VectorOfVectors outputs): K7 on its group and the sweep on
its current, each bit for bit against its plain version, ``build_dsp``
twice (a chain-cache hit) with the pulse count held against the JAX
package's, the first 256 events against the port's CPU run, and two chunks
through the production loop against the synchronous calls. Then the
**flagship extras** (``extras_config``: the flagship's 34 columns and the
12 processors of `poly_fit.py`, `soft_pileup_corr.py`, `corrections.py` and
the rest of `time_point_thresh.py` on its waveforms): those processors called alone
on the card against the CPU (``inl_correction`` among them, on the rows'
integer codes), the bi-level trigger's sweep (``csrc/bilevel_scan.cu``) on
the extras' ``rc_cr2`` rows bit for bit against its plain version, K7 on the
extras' three groups (the new ops ``poly_residual``, ``soft_pileup``,
``wf_correction``, ``wf_centroid`` and ``time_point_thresh``'s interpolation
modes), and ``build_dsp`` twice over 16384 events (the hand fronts, K7 three
times a chunk, ``rc_cr2`` on the recurrence kernel, the sweep once, no
split; each new column finite on at least 90% of the events, the first 256
events against the CPU run). Then the **flagship injection + ML path**
(``inject_ml_config``: the flagship's 34 columns, the four pulse injectors
on a second, late pulse, a DPLMS filter's convolution and maximum, an NNLS
fit of the rising edge against eight shifted reference pulses and a small
classifier with seeded weights; ``inject_ml_db`` makes its database from
the generator): K7 on its two groups (the ``inject`` and ``dense`` ops' outputs
bit for bit against the plain walk on every row), each new op alone timed
against its bound, and ``build_dsp`` twice over 16384 events (the hand
fronts, K7 twice a chunk, no split; each new column finite on at least 99%
of the events, the first 1024 events against the CPU run, the spread of
``dplmsEmax`` and ``trapEmax`` over the amplitudes). Then the **optimisers**
(``opt_configs``): ``optimize_1pz`` over the flagship's 16384 events (the
median tau within 1% of the generator's) and ``optimize_2pz`` over 2048
events of the DPZ generator on the recurrence kernel, its objective on the
first 64 events against the JAX package's (``tests/torch_optimize_2pz_jax.npz``,
from ``tools/optimize_2pz_reference.py``). Then **checked mode**
(``checked_phase``: the flagship through ``build_dsp(checked=True)`` equal to
the unchecked call bit for bit with its four flagged pick-offs, the generic
flagship checked with no K7 launch, a bad pick-off time raising ``DSPFatal``
at its entry through the production loop), **stacked production**
(``stacked_phase``: 4 channel tables x 4096 events in one dispatch, equal to
four ``build_dsp`` calls bit for bit, K1 to K5 once) and **the mesh**
(``mesh_phase``: NCCL at world size 1, the flagship over ``{"data": 1}`` and
``sp_convolve_same`` over ``{"sp": 1}``; with two cards, two NCCL ranks,
``--mesh-rank``). The **coverage path** (``coverage_config``: the flagship's
34 columns and columns that run each of K7's twelve ops of slice 19 inside
a generic group): K7 on its four groups, each new op alone on the values
its group gave it, bit for bit against the plain walk on every row, timed
against its bound; ``build_dsp`` twice in the generic mode (K7 four times a
chunk, no split; each new column finite on at least 90% of the events, the
first 1024 events against the CPU run). The **plane path** (``plane_config``:
the flagship's 34 columns and columns that run each of K7's plane ops
inside a generic group, ``PLANE_OPS``): the same, K7 three times a chunk.
The **float64 paths** (``F64_PATHS``: the flagship, its DPZ, its extras and
the injection + ML, coverage and plane paths on float64 rows): K7's float64
kernel on their groups (the plane path's group C, whose float64 arena is
over one block's shared memory, in the three parts it bisects into), every
stored output bit for bit against the plain walk on every row, each float64
op alone (``F64_HELD``) bit for bit against the plain walk, within
``F64_REL`` of its member's own body and timed against its bound;
``build_dsp`` of the float64 flagship twice in each mode (K7 twice a chunk,
no hand kernel, no split) and of the float64 plane path twice in the
generic mode (K7 ``F64_PLANE_LAUNCHES`` times a chunk, no split but group
C's on shared memory); the first 1024 events against the CPU run at the
golden replay's tolerance.
The **float64 SiPM path** (``F64_PATHS``' first entry and
``sipm_f64_phase``): the SiPM chain on its rows widened to float64 as one
float64 K7 launch, bit for bit against the plain walk and, through
``build_dsp``, against the float32 SiPM path's VoV columns. The **examples**
(``examples_phase``): the port's examples' steps that need neither ``h5py``
nor ``matplotlib``, at full width, through the examples' own functions.
The **browser** (``vis_phase``:
``dspeed_tpu_torch.vis.WaveformBrowser`` over the flagship's 16384 events,
its chain's K1, K3 and K2 once each, fetched entries against ``build_dsp``
on the card and a browser on the CPU, drawn where matplotlib is installed).

Prints the card's name and power limit, one JSON line of kernel figures
(``{"kernels": [...]}``), and as the last line
``{"ok": true, "device": {...}}``. Any failed check exits non-zero. Needs
CUDA; imports nothing of the JAX package.
"""

from __future__ import annotations

import json
import os
import re
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
# the flagship DPZ's trapEmax bound: the JAX package's own worst
# |trapEmax / amplitude - 1| on the same 16384 events (its float32 chain on
# the CPU, tools/dpz_reference.py: 0.008622882489735861; its float64 chain
# 0.006851252233267324), plus 1e-5; neither meets 0.5% on this generator
DPZ_TRAP_TOL = 0.008622882489735861 + 1e-5
DT = 16.0  # ns per sample
N_EVENTS = 16384
N_SAMPLES = 4096
REL_TOL = 1e-5  # |kernel - plain| <= REL_TOL * max|plain| per output column
# float64 paths: the golden replay's tolerance (tests/test_goldens.py:40-45),
# |card - reference| <= F64_ATOL + F64_REL * max|reference| per column
F64_REL, F64_ATOL = 1e-9, 1e-12
NAN_SAMPLE_ROW = 3  # end-to-end input: this event holds a NaN sample
NAN_BASELINE_ROW = 5  # and this one a NaN baseline
ATRAP = ("asym", 8, 4, 125)  # the flagship's wf_atrap (128 ns, 4, 2 us)
# H100 SXM peaks (NVIDIA data sheet): HBM3, f32 and f64 outside the tensor
# cores, f64 on the tensor cores (full float64 precision), which bound the
# float64 work shaped as a matrix product (a convolution's or a dense
# layer's products and sums over the rows)
PEAK_BYTES_S = 3.35e12
INJECT_OPS = 12  # operations an injected sample (each exp or pow as one)
PEAK_F32_S = 67e12
PEAK_F64_S = 34e12
PEAK_F64_MM_S = 67e12
DEVICE = "cuda"
E2E_RATES: dict = {}  # e2e_phase's label -> (first, warm) wf/s
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


DPZ = {"tau1": 27460.5, "tau2": 250.0, "frac": 0.04}  # samples, samples, 1


def make_hpge_dpz_waveforms(n, nsamp=N_SAMPLES, seed=11):
    """The flagship's synthetic HPGe pulses (:func:`make_hpge_waveforms`)
    with the two-exponential tail ``(1 - frac) exp(-t/tau1) + frac
    exp(-t/tau2)`` that ``double_pole_zero`` inverts (``DPZ``; the
    generator of ``tests/torch_flagship.py``). Returns ``(wf, amp, t0, bl,
    rt)``."""
    rng = np.random.default_rng(seed)
    amp = rng.uniform(500, 30000, n)
    t0 = rng.integers(950, 1050, n)
    rt = rng.integers(40, 150, n)
    bl = rng.uniform(14000, 16000, n)
    t = np.arange(nsamp)[None, :]
    rise = np.clip((t - t0[:, None]) / rt[:, None], 0, 1)
    dt = t - t0[:, None] - rt[:, None]
    tail = ((1 - DPZ["frac"]) * np.exp(-dt / DPZ["tau1"])
            + DPZ["frac"] * np.exp(-dt / DPZ["tau2"]))
    wf = bl[:, None] + amp[:, None] * rise * np.where(dt > 0, tail, 1.0)
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
    NaN sample (row 0, at sample 300 of 1024), an infinite sample (row 1, at
    700 of 1024; both placed in proportion on shorter rows), the row's
    maximum and minimum in the samples the reflected pad copies (row 2:
    samples 1 and n - 2), and a sine of period 40 samples (row
    ``FULL_SLOT_ROW``, where the rows reach it: more maxima than the peak
    finder's 20 slots)."""
    wf = wf.copy()
    n = wf.shape[1]
    wf[0, 300 * n // SIPM_SAMPLES] = np.nan
    wf[1, 700 * n // SIPM_SAMPLES] = np.inf
    hi, lo = np.abs(wf[2]).max() + 50, -np.abs(wf[2]).max() - 50
    wf[2, 1], wf[2, -2] = hi, lo
    i = np.arange(wf.shape[1])
    if len(wf) > FULL_SLOT_ROW:
        wf[FULL_SLOT_ROW] += (100 * np.sin(2 * np.pi * i / 40)).astype(np.float32)
    return wf


def peakdet_edge_rows(n, seed=29):
    """Rows of ``n`` samples (``n`` >= 400) made to hit the corners of the
    peak finder's sweep, with their parameters: ``(w (R, n), (dmax, dmin,
    amax, amin) each (R,))``, float64. Ordinary rows of pulses on noise; a
    NaN ``amax`` (nothing declared); a sine with ``amax`` 0 (every slot
    filled); plateaus (exact ties); infinite and NaN samples; a constant
    row; signed zeros; and zigzags that declare at every sample, across
    sweep positions 31/32 and 127/128 and in the ragged last step, one
    region for each direction."""
    rng = np.random.default_rng(seed)
    i = np.arange(n)
    rows, pars = [], []

    def add(w, dmax=5.0, dmin=0.1, amax=10.0, amin=0.0):
        rows.append(np.asarray(w, np.float64))
        pars.append((dmax, dmin, amax, amin))

    def pulses(k=6):
        w = rng.normal(0.0, 1.0, n)
        for t0 in rng.integers(0, n - 50, k):
            w[t0:] += rng.uniform(20, 60) * np.exp(-(i[t0:] - t0) / 8.0)
        return w

    def zigzag(*regions):  # 10 at every other sample of each region, else 0
        w = np.zeros(n)
        for a, b in regions:
            w[a:b:2] = 10.0
        return w

    add(pulses())
    add(pulses(12), amin=-np.inf)
    add(pulses(), amax=np.nan)
    add(15 * np.sin(2 * np.pi * i / 40), amax=0.0)
    add(np.repeat(np.round(np.cumsum(rng.normal(0, 2, n // 3 + 1))), 3)[:n],
        dmax=2.0, dmin=2.0, amax=-1e9, amin=1e9)
    w = pulses()
    w[[100, 700]] = np.inf
    w[[300, n - 100]] = -np.inf
    w[[500, 501, n - 1]] = np.nan
    add(w, amin=1e9)
    add(np.full(n, 7.0), amax=0.0, amin=100.0)
    w = np.where(i % 2 == 1, 0.0, -0.0)
    w[n // 2] = 20.0
    add(w, dmax=0.0, dmin=0.0, amax=-1.0, amin=1.0)
    for regions in (((100, 160), (n - 160, n - 100)), ((20, 46), (n - 46, n - 20)),
                    ((n - 20, n), (0, 20))):
        add(zigzag(*regions), amax=0.0, amin=5.0)
    return np.stack(rows), tuple(np.array(p) for p in zip(*pars))


def bilevel_edge_rows(n, seed=31):
    """Rows of ``n`` samples (``n`` >= 3000) made to hit the corners of the
    bi-level trigger's sweep, with their parameters: ``(w (R, n) float64,
    (pos, neg) float64 (R,), (gate, start) int32 (R,))``. Bipolar pulses on
    noise (the ``rc_cr2`` shape); a sine that crosses more often than 8
    slots hold; a start in a pulse (1000) and an odd one (333); a gate of 5;
    NaN and infinite samples; pairs that cross zero and a threshold at once,
    both ways; threshold pairs that straddle sweep positions 31/32,
    127/128, 255/256 and 1023/1024; a sine of period 8 (several crossings a
    lane); a NaN row; thresholds at 0."""
    rng = np.random.default_rng(seed)
    i = np.arange(n, dtype=np.float64)
    rows, pars = [], []

    def add(w, pos=500.0, neg=-500.0, gate=200, start=0):
        rows.append(np.asarray(w, np.float64))
        pars.append((pos, neg, gate, start))

    def bipolar(c, a, s=30.0):
        return a * (i - c) / s * np.exp(-((i - c) ** 2) / (2 * s**2))

    def noisy(*pulses):
        w = rng.normal(0.0, 5.0, n)
        for c, a in pulses:
            w += bipolar(c, a)
        return w

    def steps(levels):  # piecewise constant: (from sample, level), in order
        w = np.zeros(n)
        for a, v in levels:
            w[a:] = v
        return w

    add(noisy((1000, 2000)))
    add(3000 * np.sin(2 * np.pi * i / 64))
    add(noisy((1000, 2000), (2500, 1500)), start=1000)
    add(noisy((330, 2000), (1800, -2000)), start=333)
    add(noisy((1000, 2000), (1300, 2000)), gate=5)
    w = noisy((1000, 2000), (2600, 2000))
    w[700], w[2000], w[3000] = np.nan, np.inf, -np.inf
    add(w)
    add(steps([(0, 0), (500, -600), (600, 600), (1500, -600), (2000, 600),
               (2100, -600), (2500, 0)]))
    add(steps([(0, 100), (32, 600), (128, 100), (256, -600), (512, -100),
               (768, 600), (1024, -600), (1280, 600), (1536, 100), (2048, -600),
               (2304, 600), (2560, 0)]), gate=300)
    add(3000 * np.sin(2 * np.pi * i / 8 + 0.3))
    add(np.full(n, np.nan))
    add(rng.normal(0.0, 5.0, n), pos=0.0, neg=0.0, gate=3)
    add(noisy((2000, -2000)), gate=50, start=7)
    for _ in range(4):
        add(noisy(*((c, rng.uniform(800, 3000) * rng.choice([-1, 1]))
                    for c in rng.integers(200, n - 200, rng.integers(1, 4)))))
    p = tuple(np.array(q) for q in zip(*pars))
    return np.stack(rows), (p[0], p[1]), (p[2].astype(np.int32), p[3].astype(np.int32))


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


def flagship_config(dtype="float32") -> dict:
    """The flagship YAML; with ``dtype="float64"`` its float32 declarations
    widened, as ``tests/torch_flagship.flagship_config`` widens them."""
    import yaml

    with open(CONFIG) as f:
        txt = f.read()
    if dtype == "float64":
        for f32, f64 in (("'f')", "'d')"), ("'f', grid", "'d', grid"),
                         ('"fi->f"', '"di->d"')):
            txt = txt.replace(f32, f64)
    return yaml.safe_load(txt)


def dpz_config(dtype="float32") -> dict:
    """The flagship with its pole-zero step changed to the two-pole
    correction of HPGe production chains, ``double_pole_zero(wf_blsub,
    db.pz2.tau1, db.pz2.tau2, db.pz2.frac)`` with the defaults of ``DPZ``
    (chosen for the synthetic tail; no published source gives them), all 34
    outputs: the **flagship DPZ** (``tests/torch_flagship.py`` builds the
    same). With ``dtype="float64"`` its float32 declarations are widened,
    as ``tests/torch_flagship.flagship_config`` widens them."""
    cfg = flagship_config(dtype)
    cfg["processors"]["wf_pz"] = {
        "function": "double_pole_zero",
        "module": "dspeed_tpu.processors",
        "args": ["wf_blsub", "db.pz2.tau1", "db.pz2.tau2", "db.pz2.frac", "wf_pz"],
        "unit": "ADC",
        "defaults": {f"db.pz2.{k}": repr(v) for k, v in DPZ.items()},
    }
    return cfg


# the flagship-extras columns (extras_config): the 12 processors of the
# port's `poly_fit.py`, `soft_pileup_corr.py`, `corrections.py` and the rest
# of `time_point_thresh.py` beside the flagship's 34, with their windows and
# thresholds chosen for make_hpge_waveforms' pulses (t0 in 950-1050, rise
# 40-150 samples, amplitude 500-30000 ADC, noise 3 ADC)
EXTRAS_BL = 750  # the baseline window, wf_blsub[0:750] (the flagship's)
EXTRAS_TAIL = (2500, 4000)  # the tail window, wf_blsub[2500:4000]
EXTRAS_RC_TAU = 20  # rc_cr2's time constant, samples
EXTRAS_SLOTS = 8  # the bi-level trigger's slots
EXTRAS_STEP = 64  # the step kernel's length, samples
EXTRAS_ALIGN = 128  # wf_alignment's window, samples


def extras_config(dtype="float32") -> dict:
    """The **flagship extras**: ``configs/hpge-energy-timing.yaml``'s 34
    columns, plus columns that run each of the 12 processors of the port's
    ``poly_fit.py``, ``soft_pileup_corr.py``, ``corrections.py`` and the rest
    of ``time_point_thresh.py`` at least once (``poly_fit``, ``poly_diff``, ``poly_exp_rms``,
    ``soft_pileup_corr``, ``soft_pileup_corr_bl``,
    ``interpolated_time_point_thresh``, ``multi_time_point_thresh``,
    ``bi_level_zero_crossing_time_points``, ``get_wf_centroid``,
    ``wf_alignment``, ``wf_correction``; ``inl_correction`` takes integer
    ADC codes, which this config cannot give, so ``extras_card_phase``
    holds it on the card alone). Built in memory; the YAML is not
    changed. With ``dtype="float64"`` every float32 declaration is
    widened, as :func:`flagship_config` widens the flagship's."""
    cfg = flagship_config(dtype)
    k = "dspeed_tpu.processors"
    lo, hi = EXTRAS_TAIL
    c = "d" if dtype == "float64" else "f"
    f32 = {"signature": "(n),()->()", "types": [f"{c}i->{c}"]}
    extra = {
        # the baseline's linear fit, and its residual: sum(r_i / (i+1)) and
        # rms (ADC)
        "bl_poly": {"function": "poly_fit", "module": k,
                    "init_args": [str(EXTRAS_BL), "1"],
                    "args": [f"wf_blsub[0:{EXTRAS_BL}]", f"bl_poly(2, '{c}')"]},
        "bl_pdiff_mean, bl_pdiff_rms": {
            "function": "poly_diff", "module": k,
            "args": [f"wf_blsub[0:{EXTRAS_BL}]", "bl_poly", "bl_pdiff_mean",
                     "bl_pdiff_rms"], "unit": ["ADC", "ADC"]},
        # the tail's exponential decay: a line fitted to its log, and the
        # residual of the tail against the line's exponential (ADC)
        "tail_log": {"function": "log", "module": "numpy",
                     "args": [f"wf_blsub[{lo}:{hi}]", "tail_log"],
                     "kwargs": {"signature": "(n)->(n)", "types": [f"{c}->{c}"]}},
        "tail_poly": {"function": "poly_fit", "module": k,
                      "init_args": [str(hi - lo), "1"],
                      "args": ["tail_log", f"tail_poly(2, '{c}')"]},
        "tail_pexp_mean, tail_pexp_rms": {
            "function": "poly_exp_rms", "module": k,
            "args": [f"wf_blsub[{lo}:{hi}]", "tail_poly", "tail_pexp_mean",
                     "tail_pexp_rms"], "unit": ["ADC", "ADC"]},
        # the waveform less a pile-up tail A exp(-i/tau) + B fitted to the
        # baseline window, and its maximum (ADC); the corrected baseline's
        # mean and slope would be the fit's rounding (the two terms are
        # nearly collinear over 750 samples at tau = 27460.5)
        "wf_spc": {"function": "soft_pileup_corr", "module": k,
                   "args": ["wf_blsub", str(EXTRAS_BL), "db.pz.tau", "wf_spc"],
                   "unit": "ADC", "defaults": {"db.pz.tau": "27460.5"}},
        "spc_max": dict(function="amax", module="numpy", unit="ADC",
                        args=["wf_spc", 1, "spc_max"], kwargs=f32),
        # the same with the baseline fixed at the fitted bl_mean
        "wf_spcbl": {"function": "soft_pileup_corr_bl", "module": k,
                     "args": ["wf_blsub", str(EXTRAS_BL), "db.pz.tau", "bl_mean",
                              "wf_spcbl"],
                     "unit": "ADC", "defaults": {"db.pz.tau": "27460.5"}},
        "spcbl_max": dict(function="amax", module="numpy", unit="ADC",
                          args=["wf_spcbl", 1, "spcbl_max"], kwargs=f32),
        # the 50% crossing of the pulse's rise, interpolated linearly (ns)
        "tp_50_interp": {"function": "interpolated_time_point_thresh",
                         "module": k,
                         "args": ["wf_pz", "trapTmax*0.5", "tp_0_est", 1, "'l'",
                                  "tp_50_interp"], "unit": "ns"},
        # the 10%, 50% and 90% crossings in one chained sweep (ns, (3))
        "tp_multi": {"function": "multi_time_point_thresh", "module": k,
                     "args": ["wf_pz", "trapTmax*[0.1, 0.5, 0.9]", "tp_0_est", 1,
                              "'l'", f"tp_multi(3, '{c}')"]},
        # the RC-CR^2 shaped waveform, and its gated bipolar zero-crossing
        # triggers: their count, polarities and samples (up to 8)
        "wf_rc": {"function": "rc_cr2", "module": k,
                  "args": ["wf_blsub", str(EXTRAS_RC_TAU), "wf_rc"], "unit": "ADC"},
        "bl_ncross, bl_pol, bl_trig": {
            "function": "bi_level_zero_crossing_time_points", "module": k,
            "args": ["wf_rc", "500", "-500", "200", "0", "bl_ncross",
                     f"bl_pol({EXTRAS_SLOTS}, '{c}')",
                     f"bl_trig({EXTRAS_SLOTS}, '{c}')"]},
        # the rise's centroid from a step-kernel convolution (ns), and the
        # waveform aligned on it
        "step_kernel": {"function": "step", "module": k,
                        "args": ["16", f"step_kernel({EXTRAS_STEP}, '{c}')"]},
        "wf_step": {"function": "convolve_wf", "module": k,
                    "args": ["wf_blsub", "step_kernel", "'v'",
                             f"wf_step(len(wf_blsub) - {EXTRAS_STEP - 1}, '{c}')"],
                    "unit": "ADC"},
        "centroid": {"function": "get_wf_centroid", "module": k,
                     "args": ["wf_step", "0", "centroid"], "unit": "ns"},
        "wf_aligned": {"function": "wf_alignment", "module": k,
                       "args": ["wf_blsub", "centroid", "5",
                                str(EXTRAS_ALIGN), f"wf_aligned({EXTRAS_ALIGN}, '{c}')"],
                       "unit": "ADC"},
        "aligned_max": dict(function="amax", module="numpy", unit="ADC",
                            args=["wf_aligned", 1, "aligned_max"], kwargs=f32),
        # the waveform less a fixed correction (the step kernel) over 64
        # samples of the baseline, and that window's mean
        "wf_corr": {"function": "wf_correction", "module": k,
                    "args": ["wf_blsub", "step_kernel", "100", str(100 + EXTRAS_STEP),
                             "wf_corr"], "unit": "ADC"},
        "corr_mean, corr_std, corr_slope, corr_icpt": {
            "function": "linear_slope_fit", "module": k,
            "args": [f"wf_corr[100:{100 + EXTRAS_STEP}]", "corr_mean", "corr_std",
                     "corr_slope", "corr_icpt"], "unit": ["ADC"] * 4},
    }
    cfg["processors"].update(extra)
    cfg["outputs"] += EXTRAS_OUTPUTS
    return cfg


# in this order: multi_time_point_thresh's thresholds (a (3) plane, which
# K7 does not take) are made right after the bi-level trigger, outside a
# generic run; the (m) columns stay in samples, since K7 converts per-row
# scalars only
EXTRAS_OUTPUTS = [
    "bl_pdiff_mean", "bl_pdiff_rms", "tail_pexp_mean", "tail_pexp_rms",
    "spc_max", "spcbl_max", "tp_50_interp",
    "bl_ncross", "bl_pol", "bl_trig", "tp_multi", "centroid", "aligned_max",
    "corr_mean",
]


# the flagship injection + ML path (inject_ml_config): its choices, made for
# make_hpge_waveforms' pulses (t0 in 950-1050, rise 40-150 samples,
# amplitude 500-30000 ADC, noise 3 ADC, tau 27460.5); no published source
INJ_STARTS = (3000, 3100, 3200, 3300)  # the injected pulses' starts, samples
INJ_AMP = "(baseline + -14000)*4"  # the injected amplitudes, ADC: 0-8000, per event
INJ_WINDOW = (896, 1152)  # the rising edge's window: NNLS fit, classifier input
DPLMS_TAPS = 256  # the DPLMS filter's length, samples
DPLMS_REF = 512  # the reference pulse's length, samples (t0 at its middle)
DPLMS_PENALTIES = (1.0, 10.0, 0.0, 1.0)  # a1 (noise), a2 (reference), a3, ff
NNLS_SHIFTS = 8  # the NNLS templates: the reference pulse t0 at 936 + 16 k
NN_WIDTHS = (256, 32, 16)  # the classifier's layers: 256 -> 32 -> 16 -> 1


def inject_ml_db(n=4096, seed=23) -> dict:
    """The database of :func:`inject_ml_config`, made from ``n`` events of
    the flagship generator (seed ``seed``, not the measured events'):

    - ``dplms.noise_matrix``: the covariance of baseline-only windows of
      ``DPLMS_TAPS`` samples (the three in each event's first 768 samples,
      before any pulse starts), ``(256, 256)``;
    - ``dplms.reference``: the mean pulse over amplitude, aligned on its
      start at the middle of ``DPLMS_REF`` samples;
    - ``nnls.templates``: that reference pulse in ``INJ_WINDOW`` with its
      start at ``936 + 16 k`` for ``k < NNLS_SHIFTS``, ``(256, 8)``;
    - ``nn``: the normalisation's means and variances (the window's, over
      the events), seeded random weights for the three layers (He-scaled
      normal, small biases): no trained network is in the repository and
      nothing is downloaded, so the score only has to be a function of the
      window, the same on the card and on the CPU;
    - ``pz.tau``: the flagship's."""
    wf, amp, t0, bl, _rt = make_hpge_waveforms(n, seed=seed)
    x = wf.astype(np.float64) - bl[:, None]
    noise = x[:, : 3 * DPLMS_TAPS].reshape(-1, DPLMS_TAPS)
    idx = t0[:, None] - DPLMS_REF // 2 + np.arange(DPLMS_REF)
    ref = (np.take_along_axis(x, idx, 1) / amp[:, None]).mean(0)
    lo, hi = INJ_WINDOW
    k = np.arange(hi - lo)[:, None]
    starts = 936 + 16 * np.arange(NNLS_SHIFTS)[None, :]
    templates = ref[np.clip(DPLMS_REF // 2 + lo + k - starts, 0, DPLMS_REF - 1)]
    win = x[:, lo:hi]
    rng = np.random.default_rng(seed)
    n0, n1, n2 = NN_WIDTHS
    a1, a2, a3, ff = DPLMS_PENALTIES
    f32 = np.float32
    return {
        "pz": {"tau": TAU},
        "dplms": {"noise_matrix": np.cov(noise.T), "reference": ref,
                  "a1": a1, "a2": a2, "a3": a3, "ff": ff},
        "nnls": {"templates": templates.astype(f32)},
        "nn": {"mu": win.mean(0).astype(f32), "var": win.var(0).astype(f32),
               "w1": rng.normal(0, np.sqrt(2 / n0), (n0, n1)).astype(f32),
               "b1": rng.normal(0, 0.05, n1).astype(f32),
               "w2": rng.normal(0, np.sqrt(1 / n1), (n1, n2)).astype(f32),
               "v": rng.normal(0, np.sqrt(1 / n2), n2).astype(f32),
               "v_nb": rng.normal(0, np.sqrt(1 / n2), n2).astype(f32)},
    }


def inject_ml_config(dtype="float32") -> dict:
    """The **flagship injection + ML path**: ``configs/hpge-energy-timing.yaml``'s
    34 columns, plus columns that run the pulse injectors, the DPLMS filter,
    the NNLS template fit and a classifier (database :func:`inject_ml_db`).
    Built in memory; the YAML is not changed. With ``dtype="float64"`` every
    float32 declaration is widened, as :func:`flagship_config` widens the
    flagship's.

    - Pile-up injection, as LEGEND studies pile-up and the energy
      estimators' robustness: each of the four injectors adds a second
      pulse to ``wf_blsub`` late in the trace (``INJ_STARTS``) with an
      amplitude from the baseline column (``INJ_AMP``, 0-8000 ADC; the
      generator draws the baseline uniformly from a seed) and the
      detector's decay; each injected plane's maximum, and for the
      sigmoid one a pole zero, the flagship's energy trapezoid and its
      maximum (``trapEmax_inj``).
    - DPLMS (D'Andrea et al., EPJ C 83, 149 (2023), which LEGEND uses for
      HPGe energies): the filter of ``DPLMS_TAPS`` taps from the noise
      matrix and the reference pulse, its valid convolution with
      ``wf_blsub`` and the maximum, ``dplmsEmax``.
    - An NNLS fit of the rising edge's window (``INJ_WINDOW``) against
      ``NNLS_SHIFTS`` shifted copies of the reference pulse: ``nnls_coef``
      (8).
    - A classifier of the same window: ``normalisation_layer``, then
      ``dense_layer_with_bias`` (256 -> 32, ReLU), ``dense_layer_no_bias``
      (32 -> 16, tanh), ``classification_layer_with_bias`` (16 -> 1,
      sigmoid): ``nn_score``; and ``classification_layer_no_bias`` (leaky
      ReLU) beside it: ``nn_score_nb``. Its weights are seeded random,
      made by numpy (no trained network is in the repository, and nothing
      is downloaded)."""
    cfg = flagship_config(dtype)
    k = "dspeed_tpu.processors"
    c = "d" if dtype == "float64" else "f"
    amax = {"signature": "(n),()->()", "types": [f"{c}i->{c}"]}
    lo, hi = INJ_WINDOW
    n0, n1, n2 = NN_WIDTHS
    s0, s1, s2, s3 = INJ_STARTS
    extra = {
        "wf_sig": {"function": "inject_sig_pulse", "module": k, "unit": "ADC",
                   "args": ["wf_blsub", f"{s0}", "60", INJ_AMP, "db.pz.tau", "wf_sig"],
                   "defaults": {"db.pz.tau": "27460.5"}},
        "wf_exp": {"function": "inject_exp_pulse", "module": k, "unit": "ADC",
                   "args": ["wf_blsub", f"{s1}", "50", INJ_AMP, "db.pz.tau", "wf_exp"],
                   "defaults": {"db.pz.tau": "27460.5"}},
        "wf_gum": {"function": "inject_gumbel", "module": k, "unit": "ADC",
                   "args": ["wf_blsub", INJ_AMP, f"{s2}", "20", "wf_gum"]},
        "wf_log": {"function": "inject_general_logistic", "module": k, "unit": "ADC",
                   "args": ["wf_blsub", INJ_AMP, f"{s3}", "60", "1.0", "1.0",
                            "db.pz.tau", "wf_log"],
                   "defaults": {"db.pz.tau": "27460.5"}},
        **{f"{q}_amax": dict(function="amax", module="numpy", unit="ADC",
                             args=[f"wf_{q}", 1, f"{q}_amax"], kwargs=amax)
           for q in ("sig", "exp", "gum", "log")},
        "wf_pz_inj": {"function": "pole_zero", "module": k, "unit": "ADC",
                      "args": ["wf_sig", "db.pz.tau", "wf_pz_inj"],
                      "defaults": {"db.pz.tau": "27460.5"}},
        "wf_trap_inj": {"function": "trap_norm", "module": k, "unit": "ADC",
                        "args": ["wf_pz_inj", "10*us", "3.008*us", "wf_trap_inj"]},
        "trapEmax_inj": dict(function="amax", module="numpy", unit="ADC",
                             args=["wf_trap_inj", 1, "trapEmax_inj"], kwargs=amax),
        "dplms_kernel": {"function": "dplms", "module": k,
                         "args": ["db.dplms.noise_matrix", "db.dplms.reference",
                                  "db.dplms.a1", "db.dplms.a2", "db.dplms.a3",
                                  "db.dplms.ff", f"dplms_kernel({DPLMS_TAPS}, '{c}')"]},
        "wf_dplms": {"function": "convolve_wf", "module": k, "unit": "ADC",
                     "args": ["wf_blsub", "dplms_kernel", "'v'",
                              f"wf_dplms(len(wf_blsub) - {DPLMS_TAPS - 1}, '{c}')"]},
        "dplmsEmax": dict(function="amax", module="numpy", unit="ADC",
                          args=["wf_dplms", 1, "dplmsEmax"], kwargs=amax),
        "nnls_coef": {"function": "optimize_nnls", "module": k,
                      "args": ["db.nnls.templates", f"wf_blsub[{lo}:{hi}]", "0",
                               "1e-6", "0", "0.0", f"nnls_coef({NNLS_SHIFTS}, '{c}')"]},
        "nn_x": {"function": "normalisation_layer", "module": k,
                 "args": [f"wf_blsub[{lo}:{hi}]", "db.nn.mu", "db.nn.var", "nn_x"]},
        "nn_h1": {"function": "dense_layer_with_bias", "module": k,
                  "args": ["nn_x", "db.nn.w1", "db.nn.b1", "'r'", f"nn_h1({n1}, '{c}')"]},
        "nn_h2": {"function": "dense_layer_no_bias", "module": k,
                  "args": ["nn_h1", "db.nn.w2", "'t'", f"nn_h2({n2}, '{c}')"]},
        "nn_score": {"function": "classification_layer_with_bias", "module": k,
                     "args": ["nn_h2", "db.nn.v", "0.1", "'s'", "nn_score"]},
        "nn_score_nb": {"function": "classification_layer_no_bias", "module": k,
                        "args": ["nn_h2", "db.nn.v_nb", "'l'", "nn_score_nb"]},
    }
    cfg["processors"].update(extra)
    cfg["outputs"] += INJECT_ML_OUTPUTS
    return cfg


INJECT_ML_OUTPUTS = [
    "sig_amax", "exp_amax", "gum_amax", "log_amax", "trapEmax_inj", "dplmsEmax",
    "nnls_coef", "nn_score", "nn_score_nb",
]


# the coverage path (coverage_config): columns that run each of the twelve
# K7 ops of slice 19 inside a generic group, on make_hpge_waveforms' pulses
# (baseline 14000-16000 ADC, noise 3 ADC, amplitude 500-30000 ADC)
COVER_BIT_DEPTH = 16  # the ADC's bits: its rails at 0 and 2**16 - 16
COVER_PRESUM = 4  # samples a presummed sample
COVER_ROUND = 10.0  # ADC: trapTmax rounded to a multiple of it
COVER_TOT_MIN = 10  # samples over half the trapezoid's maximum: a pulse


def coverage_config(dtype="float32") -> dict:
    """The **coverage path**: the flagship's 34 columns, plus columns that
    run each of the twelve K7 ops of slice 19 at least once inside a generic
    group: ``mean_below_threshold`` (the baseline's mean below twice its
    spread, and the log row's), ``time_over_threshold`` (the trapezoid's
    samples over half its maximum), ``saturation`` at 16 bits,
    ``trap_pickoff`` at the flat top (as ``trapEftp`` picks it),
    ``min_max_norm`` then ``log_check`` of the raw row (positive: its
    baseline), ``linear_slope_diff`` on the baseline's fit, ``get`` (the
    pole-zero row's last sample; the first found maximum's amplitude),
    ``get_default`` (``wf_pz[...]`` at ``tp_0_est``'s sample),
    ``multi_a_filter`` after ``get_multi_local_extrema`` on the trapezoid,
    ``presum`` by 4, ``where`` on a comparison and the four rounders on
    ``trapTmax``. With ``fuse="generic"`` it forms the JAX package's four
    groups (34, 19, 24 and 26 members). With ``dtype="float64"`` every
    float32 declaration is widened, as :func:`flagship_config` widens the
    flagship's. Built in memory; the YAML is not changed."""
    cfg = flagship_config(dtype)
    k = "dspeed_tpu.processors"
    c = "d" if dtype == "float64" else "f"

    def proc(fn, args, unit=None):
        node = {"function": fn, "module": k, "args": args}
        if unit is not None:
            node["unit"] = unit
        return node

    def amax(src, out):
        return {"function": "amax", "module": "numpy", "unit": "ADC",
                "args": [src, 1, out],
                "kwargs": {"signature": "(n),()->()", "types": [f"{c}i->{c}"]}}

    half = "trapTmax*0.5"
    cfg["processors"].update({
        "bl_below": proc("mean_below_threshold", ["wf_blsub[0:750]", "bl_std*2",
                                                  "bl_below"], "ADC"),
        "t_over": proc("time_over_threshold", ["wf_trap", half, "t_over"]),
        "sat_lo, sat_hi": proc("saturation", ["waveform", str(COVER_BIT_DEPTH),
                                              "sat_lo", "sat_hi"]),
        "trapEpick": {**proc("trap_pickoff", [
            "wf_pz", "db.etrap.rise", "db.etrap.flat",
            "round(tp_0_est+db.etrap.rise+db.etrap.flat*db.etrap.sample, wf_pz.grid)",
            "trapEpick"], "ADC"),
            "defaults": {"db.etrap.rise": "10*us", "db.etrap.flat": "3.008*us",
                         "db.etrap.sample": "0.8"}},
        "wf_norm": proc("min_max_norm", ["waveform", "wf_min", "wf_max", "wf_norm"]),
        "wf_log": proc("log_check", ["wf_norm", "wf_log"]),
        "log_mean": proc("mean_below_threshold", ["wf_log", "0.0", "log_mean"]),
        "bl_dmean, bl_drms": proc("linear_slope_diff", [
            "wf_blsub[0:750]", "bl_slope", "bl_intercept", "bl_dmean", "bl_drms"],
            ["ADC", "ADC"]),
        "pz_tail": proc("get", ["wf_pz", "-1", "pz_tail"], "ADC"),
        "pz_at_t0": f"wf_pz[round(tp_0_est, wf_pz.grid, 'int64')]",
        "vt_max, vt_min, n_max, n_min": proc("get_multi_local_extrema", [
            "wf_trap", half, half, "0", half, "0", "vt_max(4, vector_len=n_max)",
            "vt_min(4, vector_len=n_min)", "n_max", "n_min"]),
        "pk_amp": proc("multi_a_filter", ["wf_trap", "vt_max", "pk_amp"], "ADC"),
        "pk_a0": proc("get", ["pk_amp", "0", "pk_a0"], "ADC"),
        "ps_fact, wf_ps": proc("presum", [
            "wf_blsub", "0", "ps_fact", f"wf_ps({N_SAMPLES // COVER_PRESUM}, '{c}')"]),
        "ps_max": amax("wf_ps", "ps_max"),
        "trapT_sel": f"where(t_over > {COVER_TOT_MIN}, trapTmax, 0.0)",
        **{f"E_{m}": proc(f"{m}_to_nearest", ["trapTmax", repr(COVER_ROUND), f"E_{m}"],
                          "ADC")
           for m in ("round", "floor", "ceil", "trunc")},
    })
    cfg["outputs"] = cfg["outputs"] + COVER_OUTPUTS
    return cfg


COVER_OUTPUTS = [
    "bl_below", "t_over", "sat_lo", "sat_hi", "trapEpick", "log_mean", "bl_dmean",
    "bl_drms", "pz_tail", "pz_at_t0", "pk_a0", "ps_fact", "ps_max", "trapT_sel",
    "E_round", "E_floor", "E_ceil", "E_trunc",
]
# the new ops (the opcodes of _tile_program.OPCODES they lower to)
COVER_OPS = ("mean_below_threshold", "count", "presum", "log_check", "trap_pickoff",
             "min_max_norm", "linear_slope_diff", "get", "multi_a_filter", "where",
             "round")


def cover_op_label(prog, op):
    """The opcode name of ``op`` (of ``prog``) where it is one of
    ``COVER_OPS``, else None."""
    from dspeed_tpu_torch.processors._tile_program import OPCODES

    codes = {OPCODES[c]: c for c in COVER_OPS}
    return codes.get(op.code)

PLANE_BL = 750  # the baseline window, wf_blsub[0:750] (the flagship's)
PLANE_CUT = 3  # baseline-subtracted samples over 3 standard deviations: the pulse
# the pick-offs' fractions of a sample: 'n' reads either neighbour (a per-row
# fraction from the baseline's mean), 'f', 'c' and 'h' a fixed offset
PLANE_PICKS = {"n": "bl_mean*64", "f": "11*ns", "c": "3*ns", "h": "7*ns"}


def plane_config(dtype="float32") -> dict:
    """The **plane path**: the flagship's 34 columns, plus columns that run
    each of K7's plane ops inside a generic group: ``trap_filter`` (the
    unnormalised trapezoid) and its maximum, both moving windows at 1 us and
    their maxima, ``fixed_time_pickoff`` in modes ``n``, ``f``, ``c`` and
    ``h`` at fractional times of ``wf_etrap`` (``PLANE_PICKS``), a 17-tap
    ``t0_filter`` (16 ns rise, 256 ns fall) convolved in modes ``s``, ``f``
    and ``v`` (the direct route) with their maxima, ufuncs over planes (a
    comparison with a per-row scalar into a bool plane, ``where`` over it,
    numpy's ``isnan``, ``logical_not``, ``absolute``, ``sqrt``, ``log1p``,
    ``square``, ``maximum``, ``floor_divide`` by a per-row scalar,
    ``remainder``, ``sign`` and ``power``) and the row reductions
    (``amin``, ``min``, ``max``, ``sum`` of a bool plane too, ``mean``,
    ``nansum``, ``nanmean``, ``nanmax``, ``nanmin``) over them and over the
    baseline window, a per-row ``sqrt``, ``floor`` of ``tp_0_est`` to its
    grid and ``ceil`` and ``trunc`` of it to a 48 ns grid (``convert_floor``
    ...), and an int64 index converted into a sliced row's grid
    (``convert_int``). With ``fuse="generic"`` the JAX package and the port
    form the same three groups (``PLANE_MEMBERS``). With ``dtype="float64"``
    every float32 declaration is widened, as :func:`flagship_config` widens
    the flagship's. Built in memory; the YAML is not changed."""
    cfg = flagship_config(dtype)
    k = "dspeed_tpu.processors"
    c = "d" if dtype == "float64" else "f"

    def proc(fn, args, unit="ADC", **extra):
        return {"function": fn, "module": k, "args": args, "unit": unit, **extra}

    def red(fn, src, out):
        return {"function": fn, "module": "numpy", "unit": "ADC", "args": [src, 1, out],
                "kwargs": {"signature": "(n),()->()", "types": [f"{c}i->{c}"]}}

    def ufunc(fn, args, types):
        return {"function": fn, "module": "numpy", "args": args,
                "kwargs": {"signature": ",".join(["()"] * (len(args) - 1)) + "->()",
                           "types": [t.replace("f", c) for t in types]}}

    pick = "tp_0_est+db.etrap.rise+db.etrap.flat*db.etrap.sample"
    etrap = {"db.etrap.rise": "10*us", "db.etrap.flat": "3*us",
             "db.etrap.sample": "0.8"}
    bl = f"wf_blsub[0:{PLANE_BL}]"
    conv_len = {"s": "len(wf_pz)", "f": "len(wf_pz)+16", "v": "len(wf_pz)-16"}
    cfg["processors"].update({
        "wf_tf": proc("trap_filter", ["wf_pz", "db.etrap.rise", "db.etrap.flat",
                                      "wf_tf"],
                      defaults={"db.etrap.rise": "10*us", "db.etrap.flat": "3.008*us"}),
        "tf_max": red("amax", "wf_tf", "tf_max"),
        "wf_mwl": proc("moving_window_left", ["wf_pz", "1*us", "wf_mwl"]),
        "mwl_max": red("amax", "wf_mwl", "mwl_max"),
        "wf_mwr": proc("moving_window_right", ["wf_pz", "1*us", "wf_mwr"]),
        "mwr_max": red("amax", "wf_mwr", "mwr_max"),
        **{f"trapEftp_{m}": proc("fixed_time_pickoff", [
            "wf_etrap", f"round({pick}, wf_etrap.grid)+{PLANE_PICKS[m]}", f"'{m}'",
            f"trapEftp_{m}"], defaults=etrap) for m in "nfch"},
        "t0k17": proc("t0_filter", ["16*ns/wf_pz.period", "256*ns/wf_pz.period",
                                    f"t0k17(round(272*ns/wf_pz.period), '{c}')"]),
        **{f"wf_t0{m}": proc("convolve_wf", [
            "wf_pz", "t0k17", f"'{m}'", f"wf_t0{m}({conv_len[m]}, '{c}')"])
           for m in "sfv"},
        **{f"t0{m}_max": red("amax", f"wf_t0{m}", f"t0{m}_max") for m in "sfv"},
        "wf_sel": f"where(wf_blsub > {PLANE_CUT}*bl_std, wf_blsub, 0.0)",
        "sel_sum": red("sum", "wf_sel", "sel_sum"),
        "sel_mean": red("mean", "wf_sel", "sel_mean"),
        "wf_nan": ufunc("isnan", ["wf_t0f", "wf_nan"], ["f->?"]),
        "wf_ok": ufunc("logical_not", ["wf_nan", "wf_ok"], ["?->?"]),
        "wf_abs": ufunc("absolute", ["wf_t0s", "wf_abs(unit='ADC')"], ["f->f"]),
        "wf_root": ufunc("sqrt", ["wf_abs", "wf_root"], ["f->f"]),
        "wf_lg": ufunc("log1p", ["wf_abs", "wf_lg"], ["f->f"]),
        "wf_sq": ufunc("square", ["wf_t0v", "wf_sq"], ["f->f"]),
        "wf_hi": ufunc("maximum", ["wf_mwl", "wf_mwr", "wf_hi"], ["ff->f"]),
        "wf_fd": "wf_blsub // (bl_std+1)",
        "wf_rm": ufunc("remainder", ["wf_blsub", "7.5", "wf_rm"], ["ff->f"]),
        "wf_sg": ufunc("sign", ["wf_blsub", "wf_sg"], ["f->f"]),
        "wf_pw": ufunc("power", ["wf_root", "1.5", "wf_pw"], ["ff->f"]),
        "ok_sum": {"function": "sum", "module": "numpy", "args": ["wf_ok", 1, "ok_sum"],
                   "kwargs": {"signature": "(n),()->()", "types": ["?i->l"]}},
        "root_max": red("nanmax", "wf_root", "root_max"),
        "lg_max": red("max", "wf_lg", "lg_max"),
        "mwl_min": red("min", "wf_mwl", "mwl_min"),
        "sq_max": red("amax", "wf_sq", "sq_max"),
        "hi_nsum": red("nansum", "wf_hi", "hi_nsum"),
        "fd_nmean": red("nanmean", "wf_fd", "fd_nmean"),
        "rm_nmin": red("nanmin", "wf_rm", "rm_nmin"),
        "sg_sum": red("sum", "wf_sg", "sg_sum"),
        "pw_mean": red("mean", "wf_pw", "pw_mean"),
        "bl_amin": red("amin", bl, "bl_amin"),
        "bl_avg": red("mean", bl, "bl_avg"),
        "bl_nmax": red("nanmax", bl, "bl_nmax"),
        "bl_sum": red("sum", bl, "bl_sum"),
        "bl_rt": ufunc("sqrt", ["bl_std", "bl_rt"], ["f->f"]),
        "t0_floor": "floor(tp_0_est, wf_pz.grid)",
        **{f"t0_{m}": f"{m}(tp_0_est, 48*ns)" for m in ("ceil", "trunc")},
        "t0_idx": "round(tp_0_est, wf_pz.grid, 'int64')",
        "t0_late": "wf_pz[100:][t0_idx]",
    })
    cfg["outputs"] = cfg["outputs"] + PLANE_OUTPUTS
    return cfg


PLANE_OUTPUTS = [
    "tf_max", "mwl_max", "mwr_max", "trapEftp_n", "trapEftp_f", "trapEftp_c",
    "trapEftp_h", "t0s_max", "t0f_max", "t0v_max", "sel_sum", "sel_mean", "ok_sum",
    "root_max", "lg_max", "mwl_min", "sq_max", "hi_nsum", "fd_nmean", "rm_nmin", "sg_sum",
    "pw_mean", "bl_amin", "bl_avg", "bl_nmax", "bl_sum", "bl_rt", "t0_floor",
    "t0_ceil", "t0_trunc", "t0_idx", "t0_late",
]
PLANE_MEMBERS = (34, 19, 107)  # the generic groups' members, as the JAX package's
# the plane columns computed from tp_0_est (a column may move where it moved)
PLANE_READS_T0 = ("trapEftp_n", "trapEftp_f", "trapEftp_c", "trapEftp_h", "t0_floor",
                  "t0_ceil", "t0_trunc", "t0_idx", "t0_late")
# K7's plane ops, as plane_op_label names them
PLANE_OPS = ("trap_filter", "moving_window", "fixed_time_pickoff n",
             "fixed_time_pickoff f", "fixed_time_pickoff c", "fixed_time_pickoff h",
             "conv_direct", "convert_floor", "convert_ceil", "convert_trunc",
             "convert_int", "ewise", "ufunc", "reduce")


def plane_op_label(prog, op):
    """The name of the plane op that ``op`` (of ``prog``) is, or None: the
    ``trap`` op's ``trap_filter`` kind, the pick-off's new modes, the
    ``convert`` op's new kinds and the ``ufunc`` op's new table entries by
    their own names, the new opcodes by theirs."""
    from dspeed_tpu_torch.processors._tile_program import CONVERTS, OPCODES

    names = {v: k for k, v in OPCODES.items()}
    name = names[op.code]
    if name in ("moving_window", "conv_direct", "ewise", "reduce"):
        return name
    if name == "trap" and op.ip[0] == 2:
        return "trap_filter"
    if name == "fixed_time_pickoff" and chr(op.ip[0]) in "nfch":
        return f"fixed_time_pickoff {chr(op.ip[0])}"
    if name == "convert" and op.ip[0] >= 2:
        return {v: k for k, v in CONVERTS.items()}[op.ip[0]]
    if name == "ufunc" and op.ip[0] >= 9:
        return "ufunc"
    return None


# the float64 paths: K7's float64 kernel on the groups of the SiPM chain on
# float64 rows (sipm_edge_rows widened; its config declares float64 taps,
# so its rows alone are of the path's type), and of the float64 flagship,
# DPZ, extras, injection + ML, coverage and plane paths (flagship_config ...
# plane_config with "float64"), with their members (in fuse="generic") and
# the groups that may bisect, on shared memory alone (the plane path's
# group C: its float64 arena is over one block's); the SiPM path first, so
# that the flagship's avg_current keeps its figure under ops_alone
F64_PATHS = (("float64 SiPM", lambda dtype: sipm_config(), (2,), ""),
             ("float64 flagship", flagship_config, (34, 19), ""),
             ("float64 DPZ", dpz_config, (34, 19), ""),
             ("float64 extras", extras_config, (34, 19, 9, 2, 22), ""),
             ("float64 injection + ML", inject_ml_config, (34, 19, 25, 22), ""),
             ("float64 coverage", coverage_config, (34, 19, 24, 26), ""),
             ("float64 plane", plane_config, PLANE_MEMBERS, "C"))
# K7 launches a chunk of the float64 plane path's build_dsp: groups A and B,
# and group C's three parts
F64_PLANE_LAUNCHES = 5
# the float64 ops those groups run, each held alone (f64_op_label; every
# program loads its rows)
F64_HELD = ("bl_subtract", "windower", "avg_current", "min_max", "amax",
            "linear_slope_fit", "pole_zero", "trap_norm", "asym_trap_filter", "conv",
            "moving_window_multi", "time_point_thresh", "time_point_thresh l",
            "fixed_time_pickoff l", "double_pole_zero", "poly_residual", "soft_pileup",
            "wf_correction", "wf_centroid",
            # the injection + ML, coverage and plane paths'
            "inject", "dense normalisation", "dense", "mean_below_threshold", "count",
            "presum", "log_check", "trap_pickoff", "min_max_norm", "linear_slope_diff",
            "get", "multi_a_filter", "where", "round", "trap_filter", "moving_window",
            "conv_direct", "ewise", "reduce",
            # the SiPM chain's
            "reflected_conv")


def f64_op_label(prog, op):
    """The name of the float64 plane op that ``op`` (of the float64 program
    ``prog``) is, or None (the loads, the per-row ufunc and convert ops):
    the ``trap`` op by its member's kind, ``time_point_thresh`` and
    ``fixed_time_pickoff`` with their interpolation mode, soft_pileup's two
    ops (one member) as ``soft_pileup``, the ``dense`` op's normalisation as
    ``dense normalisation`` (its layers as ``dense``), the rest by their
    opcodes."""
    from dspeed_tpu_torch.processors._tile_program import OPCODES, TRAP_KINDS

    if not prog.f64:
        return None
    name = {v: k for k, v in OPCODES.items()}[op.code]
    if name in ("load", "ufunc", "convert"):
        return None
    if name == "trap":
        return {v: k for k, v in TRAP_KINDS.items()}[op.ip[0]]
    if name == "time_point_thresh" and op.ip[1]:
        return f"time_point_thresh {chr(op.ip[1])}"
    if name == "fixed_time_pickoff":
        return f"fixed_time_pickoff {chr(op.ip[0])}"
    if name == "dense" and op.ip[0] == 0:
        return "dense normalisation"
    return "soft_pileup" if name == "soft_pileup_out" else name


# the optimisers' phase (opt_configs): one-pole on the flagship generator's
# rows, two-pole on the DPZ generator's, from a start away from the truth
OPT_2PZ_EVENTS = 2048  # events of the two-pole optimisation (150 iterations)
OPT_1PZ_WINDOW = (1500, 4096)  # the one-pole objective's window, samples
OPT_2PZ_WINDOW = (1200, 2800)  # the two-pole objective's window, samples
OPT_2PZ_BOUNDS = (1e5, 0.5)  # tau_upper_bound (samples), frac_upper_bound
OPT_2PZ_START = (20000.0, 400.0, 0.1)  # tau1, tau2 (samples), frac (DPZ's truth:
# 27460.5, 250, 0.04)
OPT_2PZ_REF = os.path.join(REPO, "tests", "torch_optimize_2pz_jax.npz")
OPT_2PZ_REF_EVENTS = 64  # events of the JAX package's stored objectives


# checked mode: the steps the fused flagship flags (the JAX package flags
# the same four, tests/test_torch_checked.py holds that; K1 absorbs
# pole_zero and its checker in both packages)
CHECKED_FLAGSHIP_STEPS = [
    "fixed_time_pickoff(wf_trap2, (tp_0_est+8.096 us), l, trapQftp)",
    "fixed_time_pickoff(wf_etrap, round(((tp_0_est+10.0 us)+2.4000000000000004 us), "
    "(16.0 ns,waveform_dt)), l, trapEftp)",
    "fixed_time_pickoff(wf_cusp, 50, i, cuspEftp)",
    "fixed_time_pickoff(wf_zac, 50, i, zacEftp)",
]
PICK_BAD = 12345  # the event whose pick-off time is not an integer
PICK_MESSAGE = "fixed_time_pickoff requires integer t_in when using mode 'i'"
PICK_PROCESSOR = "fixed_time_pickoff(wf_blsub, t_pick, i, pick_i)"


def checked_raise_config() -> dict:
    """The flagship plus ``pick_i = fixed_time_pickoff(wf_blsub, t_pick,
    'i')`` on a per-event float column ``t_pick`` (:func:`pickoff_times`):
    checked mode raises at its one non-integral time."""
    cfg = flagship_config()
    cfg["processors"]["pick_i"] = {
        "function": "fixed_time_pickoff",
        "module": "dspeed_tpu.processors",
        "args": ["wf_blsub", "t_pick", "'i'", "pick_i"],
        "unit": "ADC",
    }
    cfg["outputs"] = cfg["outputs"] + ["pick_i"]
    return cfg


def pickoff_times(n, bad=PICK_BAD) -> np.ndarray:
    """``t_pick``: integral sample indices in [1000, 2000), float32, but
    half a sample off at event ``bad``."""
    t = (1000 + np.arange(n) % 1000).astype(np.float32)
    t[bad] += 0.5
    return t


def opt_configs(dtype="float32") -> tuple[dict, dict]:
    """The optimisers through ``build_dsp``: ``optimize_1pz`` of the
    baseline-subtracted rows over ``OPT_1PZ_WINDOW`` from ``db.pz.tau``
    (``opt_tau``), and ``optimize_2pz`` over ``OPT_2PZ_WINDOW`` with the
    bounds ``OPT_2PZ_BOUNDS`` from ``OPT_2PZ_START`` (``opt_tau1``,
    ``opt_tau2``, ``opt_frac``)."""
    k = "dspeed_tpu.processors"
    blsub = {"function": "bl_subtract", "module": k,
             "args": ["waveform", "baseline", "wf_blsub(unit='ADC')"]}
    one = {"outputs": ["opt_tau"], "processors": {
        "wf_blsub": blsub,
        "opt_tau": {"function": "optimize_1pz", "module": k,
                    "args": ["wf_blsub", "0", *map(str, OPT_1PZ_WINDOW), "db.pz.tau",
                             "opt_tau"], "defaults": {"db.pz.tau": "27460.5"}}}}
    two = {"outputs": ["opt_tau1", "opt_tau2", "opt_frac"], "processors": {
        "wf_blsub": blsub,
        "opt_tau1, opt_tau2, opt_frac": {
            "function": "optimize_2pz", "module": k,
            "args": ["wf_blsub", "0", *map(str, OPT_2PZ_WINDOW),
                     *map(str, OPT_2PZ_BOUNDS), *map(str, OPT_2PZ_START),
                     "opt_tau1", "opt_tau2", "opt_frac"]}}}
    if dtype == "float64":
        for cfg in (one, two):
            cfg["processors"]["wf_blsub"]["args"][2] = "wf_blsub(unit='ADC', dtype='d')"
    return one, two


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


def k7_ptxas(log: str) -> tuple[list, list]:
    """``ptxas -v``'s report for K7's float kernel and for its float64
    kernel; fails unless the float kernel takes 80 registers or fewer, the
    float64 kernel 128 or fewer (two blocks an SM), and neither spills."""
    reports = ptxas_report(log, "generic_rows_kernel")
    ptxas = [v for k, v in reports.items() if "_f64" not in k]
    ptxas64 = [v for k, v in reports.items() if "_f64" in k]
    for kernel, rep in (("generic_rows_kernel", ptxas), ("generic_rows_kernel_f64", ptxas64)):
        if len(rep) != 1 or "0 bytes spill stores, 0 bytes spill loads" not in rep[0]:
            raise AssertionError(f"K7: {kernel} spills, or its ptxas report is {rep}")
    for kernel, rep, cap in (("generic_rows_kernel", ptxas, 80),
                             ("generic_rows_kernel_f64", ptxas64, 128)):
        regs = int(re.search(r"Used (\d+) registers", rep[0]).group(1))
        if regs > cap:
            raise AssertionError(f"K7: {kernel} takes {regs} registers, over {cap}")
    return ptxas, ptxas64


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


def generic_bound(program, B, nbytes=None) -> tuple[float, str]:
    """The least time for one K7 launch of ``program`` on B rows: every
    external plane it loads and scalar it reads, once; every stored output
    written once (or ``nbytes`` in all, where the caller counts the bytes
    the function needs); the operations its ops need per row (a convolution's
    multiply-adds in float32; float64 prefix sums, window sums, pole-zero
    products, slope-fit sums and moving-window stages; a comparison per
    sample for each reduction; the reflected convolution's products and
    sums and the current's difference and division, in the output's
    type; the polynomial residual's, the soft pile-up fit's and the
    correction's arithmetic, the centroid's comparisons; an injected pulse's
    ``INJECT_OPS`` a sample, a layer's float64 products and sums; slice
    19's ops: a comparison and a float64 sum a sample for a masked mean,
    comparisons for a count, a residual's eight float64 operations, a
    comparison and a float64 log, a NaN test a sample and the pick-off's
    two window sums, a presum's additions, a normalisation's division; slice
    20's ops: four float64 operations a sample for ``trap_filter``, three for
    a moving window, the direct convolution's multiply-adds in float32, one
    operation a sample for an elementwise op and for a reduction; a gather,
    select or rounding none). A float64 program's planes count 8 bytes a
    sample, and all its operations are float64 ones (its trapezoids take
    every window from the prefix). Float64 products and sums shaped as a
    matrix product (a float64 convolution's, direct or banded, the
    reflected convolution's in float64, a dense layer's) count at the
    float64 tensor-core peak
    ``PEAK_F64_MM_S``, the rest of the float64 work at ``PEAK_F64_S``."""
    import torch

    from dspeed_tpu_torch.processors._tile_program import OPCODES

    slots = program.slots
    nb, nbytes = nbytes, 0
    for key in program.ext_keys:
        s = slots[program.by_key[key]]
        loaded = any(op.code == OPCODES["load"] and op.ins[0] == program.by_key[key]
                     for op in program.ops)
        if s.kind == "plane":
            nbytes += s.dtype.itemsize * s.length if loaded else 0
        else:
            nbytes += s.dtype.itemsize
    for sid in program.esc_roots:
        s = slots[sid]
        nbytes += s.dtype.itemsize * (s.length if s.kind == "plane" else 1)
    f32 = f64 = mm = 0
    for op in program.ops:
        n = slots[op.ins[0]].length if op.ins and not isinstance(op.ins[0], tuple) else 0
        if op.code == OPCODES["conv"]:
            if program.f64:
                mm += 2 * op.ip[1] * slots[op.outs[0]].length
            else:
                f32 += 2 * op.ip[1] * slots[op.outs[0]].length
        elif op.code == OPCODES["trap"]:
            rise, fall = op.ip[1], op.ip[3]
            short = 0 if program.f64 else 32  # windows summed directly
            f64 += n * (1 + 2 + (rise if rise <= short else 2) + (fall if fall <= short else 2))
        elif op.code == OPCODES["pole_zero"]:
            f64 += 2 * n
        elif op.code == OPCODES["double_pole_zero"]:
            # the prefix, the numerator on it, the pole; the correction
            f64 += 6 * n
            f32 += 3 * n
        elif op.code == OPCODES["linear_slope_fit"]:
            f64 += 5 * n
        elif op.code == OPCODES["moving_window_multi"]:
            f64 += op.ip[1] * (3 * n + 2 * op.ip[0])
        elif op.code == OPCODES["min_max"]:
            f32 += 2 * n
        elif op.code == OPCODES["amax"]:
            f32 += n
        elif op.code == OPCODES["poly_residual"]:
            # the polynomial's products and FMAs, the residual, its two
            # products; two float64 sums (and the exponential, one)
            m = op.ip[1]
            f32 += n * (3 * (m - 1) + 4)
            f64 += n * (2 + op.ip[0])
        elif op.code == OPCODES["soft_pileup"]:
            # the fit's exponential, division, two products and four sums
            # over the window; the exponential, division, product and two
            # sums of the correction over the row
            f64 += 8 * op.ip[0] + 5 * n
        elif op.code == OPCODES["wf_correction"]:
            f32 += op.ip[1] - op.ip[0]
        elif op.code == OPCODES["wf_centroid"]:
            f32 += 3 * n
        elif op.code == OPCODES["inject"]:
            # a pulse's arithmetic, each exp or pow counted as one operation
            f32 += INJECT_OPS * n
        elif op.code == OPCODES["dense"]:
            if op.ip[0] == 0:  # normalisation: a subtraction, root and division
                f32 += 3 * n
            else:  # the products and sums in float64, bias and activation
                mm += 2 * n * op.ip[5]
                f32 += 2 * op.ip[5]
        elif op.code == OPCODES["mean_below_threshold"]:
            f32 += n  # the comparisons
            f64 += n  # the sums
        elif op.code == OPCODES["count"]:
            f32 += n * (1 + op.ip[0])
        elif op.code == OPCODES["linear_slope_diff"]:
            # the residual's product, two sums, the division and two
            # products, the two sums
            f64 += 8 * n
        elif op.code == OPCODES["log_check"]:
            f32 += n  # the comparison
            f64 += n  # the log, as one operation
        elif op.code == OPCODES["trap_pickoff"]:
            f32 += n  # the NaN test
            f64 += 2 * op.ip[0]  # the two window sums
        elif op.code == OPCODES["presum"]:
            f32 += n * (1 + op.ip[0])
        elif op.code == OPCODES["min_max_norm"]:
            f32 += n
        elif op.code == OPCODES["trap"] and op.ip[0] == 2:
            # trap_filter: the prefix, two window differences and their
            # difference, in float64
            f64 += 4 * n
        elif op.code == OPCODES["moving_window"]:
            f64 += 3 * n  # the prefix, a difference and a division
        elif op.code == OPCODES["conv_direct"]:
            if program.f64:
                mm += 2 * op.ip[1] * slots[op.outs[0]].length
            else:
                f32 += 2 * op.ip[1] * slots[op.outs[0]].length
        elif op.code == OPCODES["ewise"]:
            f32 += slots[op.outs[0]].length  # one operation a sample
        elif op.code == OPCODES["reduce"]:
            f64 += n  # a float64 sum or a comparison a sample
        elif op.code in (OPCODES["reflected_conv"], OPCODES["avg_current"]):
            p = slots[op.outs[0]].length
            ops = 2 * (op.ip[1] if op.code == OPCODES["reflected_conv"] else 1) * p
            if slots[op.outs[0]].dtype != torch.float64:
                f32 += ops
            elif op.code == OPCODES["reflected_conv"]:
                mm += ops
            else:
                f64 += ops
    if program.f64:
        f32, f64 = 0, f32 + f64
    t_bytes = (B * nbytes if nb is None else nb) / PEAK_BYTES_S * 1e3
    t_ops = B * (f32 / PEAK_F32_S + f64 / PEAK_F64_S + mm / PEAK_F64_MM_S) * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def k7_parts(step, env, refusals, members=None, needed=None):
    """The launches ``GroupStep._exec`` makes for the group ``step``: the
    whole group as one program where it lowers, else (the refusal's reason
    appended to ``refusals``) its halves in turn, each lowered once the
    parts before it have put their outputs into ``env`` (the caller runs a
    part before it takes the next). Yields ``(members, vals, program)``."""
    from dspeed_tpu_torch.processing_chain import _step_writes
    from dspeed_tpu_torch.processors._tile_program import LoweringError, lower

    members = list(step.members if members is None else members)
    needed = set(step.escapes if needed is None else needed)
    reads = step.proc_chain._step_env_reads
    ext, written = set(), set()
    for m in members:
        ext |= reads(m) - written
        written |= _step_writes(m)
    vals = {k: env[k] for k in sorted(ext)}
    try:
        prog = lower(members, vals, sorted(needed & written))
    except LoweringError as e:
        if len(members) < 4:
            raise
        refusals.append(str(e))
        prog = None
    if prog is not None:
        yield members, vals, prog
        return
    mid = len(members) // 2
    needed1 = set(needed)
    for m in members[mid:]:
        needed1 |= reads(m)
    yield from k7_parts(step, env, refusals, members[:mid], needed1)
    yield from k7_parts(step, env, refusals, members[mid:], needed)


def alone_program(full, op, got, vals):
    """``(program, inputs)``: the member step of ``op`` (an op of ``full``)
    lowered alone over the values the group's launch gave its arguments
    (``got``; ``vals``, the group's inputs), storing what it writes."""
    from dspeed_tpu_torch.processing_chain import ProcessingChain, _step_writes
    from dspeed_tpu_torch.processors._tile_program import lower

    step = op.step
    ins = {k: got[k] if k in got else vals[k]
           for k in sorted(ProcessingChain._step_env_reads(step))}
    return lower([step], ins, sorted(_step_writes(step))), ins


def store_every(_cuda, members, vals, keys):
    """``(program, got, want)``: every key of ``keys`` that ``members``
    write, from K7 launches of the whole group (``got``) and the plain walk
    of the same tapes (``want``). A tape stores at most
    ``_cuda.GEN_MAX_ESC`` keys (``lower`` refuses more), so a longer list is
    stored in parts, each a launch of the whole group; ``program`` is the
    first part's tape (every part runs the same ops)."""
    from dspeed_tpu_torch.processors._tile_program import lower

    cap = _cuda.GEN_MAX_ESC
    parts = [lower(members, vals, keys[q:q + cap]) for q in range(0, len(keys), cap)]
    got, want = {}, {}
    for prog in parts:
        got.update(_cuda.generic_rows(prog, vals))
        want.update(_cuda.generic_rows_plain(prog, vals))
    return parts[0], got, want


def alone_bytes(op, ins, outs) -> int:
    """The bytes the member of ``op`` must move on this run's rows: each
    output written once, each input read once and whole, but for ``get``'s
    row, of which it reads one sample, where its index is in range.
    ``trap_pickoff`` and ``multi_a_filter`` read their rows whole: a NaN
    anywhere in the row makes their outputs NaN, as in the reference."""
    import torch

    from dspeed_tpu_torch.processors._tile_program import OPCODES

    nbytes = sum(t.numel() * t.element_size() for t in outs.values())
    a = op.step.arg_specs if op.code == OPCODES["get"] else None
    row = a[0].key if a else None
    nbytes += sum(t.numel() * t.element_size() for k, t in ins.items()
                  if k != row and isinstance(t, torch.Tensor))
    if row is not None:
        x = ins[row]
        n = x.shape[-1]
        i = ins[a[1].key] if a[1].kind == "env" else torch.as_tensor(a[1].value)
        ok = ((i >= -n) & (i < n)).to(x.device).expand(x.shape[:-1])
        nbytes += int(ok.sum()) * x.element_size()
    return nbytes


def member_outputs(step, ins) -> dict:
    """The member's own kernel body (the unfused step's run, not the tape's
    K7-order variant) on ``ins``, its arguments bound as the unfused step
    binds them; its outputs (by key) in the step's types."""
    from dspeed_tpu_torch.processing_chain import _step_writes

    env = dict(ins)
    step.run(env)
    return {k: env[k] for k in _step_writes(step)}


def k7_alone_ops(_cuda, full, got, vals, pick, label, timed, B):
    """Each op of ``full`` that ``pick(full, op)`` names (else None), alone
    on the values the group gave its arguments: one launch, every output bit for
    bit against the plain walk of that one-op program on every row, within
    REL_TOL of its scale (F64_REL, F64_ATOL in a float64 program) of the
    member kernel's own body on the same inputs (the plain walk runs a
    K7-order variant for some members, ``k7_plain``),
    and the group's own output bit for bit against the launch alone (the
    op in its group computes what it computes alone). The first op of each
    name not in ``timed`` is timed through the wrapper and on the device
    alone against its bound (the bytes its member needs,
    :func:`alone_bytes`), the plain walk beside it; returns those figures by
    the names ``pick`` gives."""
    import torch

    figs = {}
    for op in full.ops:
        name = pick(full, op)
        if name is None:
            continue
        prog, ins = alone_program(full, op, got, vals)
        alone = _cuda.generic_rows(prog, ins)
        plain = _cuda.generic_rows_plain(prog, ins)
        member = member_outputs(op.step, ins)
        member_name = op.name.split("[")[0]
        torch.cuda.synchronize()
        rel, atol = (F64_REL, F64_ATOL) if prog.f64 else (REL_TOL, 0.0)
        worst = 0.0
        for key, m in member.items():
            g = alone[key]
            if not same_bits(g, plain[key]):
                raise AssertionError(f"K7 {label} {key}: the {name} op "
                                     f"differs from the plain walk")
            if not same_bits(got[key], g):
                raise AssertionError(f"K7 {label} {key}: the {name} op "
                                     f"in its group differs from the op alone")
            g, m = g.double(), m.double()
            if g.shape != m.shape or not torch.equal(torch.isnan(g), torch.isnan(m)):
                raise AssertionError(f"K7 {label} {key}: the {name} op's NaN rows "
                                     f"differ from its member's ({member_name})")
            ok = ~torch.isnan(m)
            if bool(ok.any()):
                err = float((g[ok] - m[ok]).abs().max())
                scale = float(m[ok].abs().max())
                if err > atol + rel * scale:
                    raise AssertionError(
                        f"K7 {label} {key}: max |{name} op - member "
                        f"{member_name}| {err:.3e} > {atol + rel * scale:.3e}")
                worst = max(worst, err / max(scale, 1e-30))
        print(f"K7 {label} {name} op [{member_name}] against its member's "
              f"own body on the card: {worst:.3e} of scale", flush=True)
        if name in timed or name in figs:
            continue
        ms = time_ms(lambda: _cuda.generic_rows(prog, ins), 20)
        dev_ms = device_ms(lambda: _cuda.generic_rows(prog, ins))
        plain_ms = time_ms(lambda: _cuda.generic_rows_plain(prog, ins), 3, 1)
        bound, by = generic_bound(prog, B, alone_bytes(op, ins, alone))
        launch = _cuda.generic_rows_launch(prog)
        print(f"K7 {name} op alone [{member_name}, {len(prog.ops)} ops, "
              f"{prog.smem_bytes} B of shared memory, {launch['blocks_per_sm']} "
              f"blocks per SM] {B} rows: kernel {ms:.4f} ms ({dev_ms:.4f} ms on the "
              f"device alone), plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({by}, "
              f"what the member needs), {bound / dev_ms:.1%} of the bound on the "
              f"device alone; outputs bit for bit against the plain walk on all {B} "
              f"rows, {worst:.3e} of scale from the member's own body", flush=True)
        figs[name] = dict(member=member_name, ms=ms, device_ms=dev_ms,
                          plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                          member_rel_err=worst)
    return figs


def held_alone(figs, names, path) -> None:
    """Fails unless :func:`k7_phase` held and timed an op of each of
    ``names`` alone (``figs["ops_alone"]``)."""
    missing = set(names) - set(figs["ops_alone"])
    if missing:
        raise AssertionError(f"{path}: no op {sorted(missing)} in its groups")


def k7_phase(build_processing_chain, lh5, _cuda, wf, bl, dev, ptxas_log,
             cfg=None, fuse="generic", members=(34, 19), path="generic flagship",
             db=None, pick=None, may_split=""):
    """K7 on the groups of ``cfg`` (default: the generic flagship's two) in
    fusion mode ``fuse``: the chain built on the CPU over every event (NaN
    rows included), its steps run on the card up to the last group, each
    group lowered twice: with every key it writes (held against the plain
    walk by ``check_generic``) and with the chain's own escapes (timed
    against the plain walk, through the wrapper and on the device alone).
    A group whose lowering is refused runs as the parts ``GroupStep._exec``
    bisects it into (:func:`k7_parts`, labelled C1, C2, ...), each held and
    timed as a group; only the groups named in ``may_split`` may, and only
    on shared memory.
    A ``double_pole_zero`` op's plane must equal the plain walk's bit for
    bit on every row, and, within REL_TOL of its scale, the kernel route's
    (``double_pole_zero`` called alone, on the recurrence kernel); the
    ``inject`` and ``dense`` ops' outputs must equal the plain walk's bit for
    bit on every row. ``db`` is the database (default: the flagship's). The
    ops that ``pick(program, op)`` names are held and timed alone
    (:func:`k7_alone_ops`; their figures under ``ops_alone``). Returns the
    figures, with each group's launch and ``ptxas -v``'s report for
    ``generic_rows_kernel``."""
    import torch

    from dspeed_tpu_torch.processing_chain import GroupStep
    from dspeed_tpu_torch.processors._tile_program import OPCODES

    names = {v: k for k, v in OPCODES.items()}
    alone_figs: dict = {}
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
        cfg or config(), tb, db_dict=db or {"pz": {"tau": TAU}}, device="cpu",
        fuse=fuse
    )
    inputs, B = chain._gather_inputs(0, len(wf))
    env = {k: v.to(dev) for k, v in chain._to_device(inputs).items()}
    env.update({k: v.to(dev) if isinstance(v, torch.Tensor) else v
                for k, v in chain._const_env().items()})
    groups = [s for s in chain._steps if isinstance(s, GroupStep)]
    if [len(g.members) for g in groups] != list(members):
        raise AssertionError(f"{path}: groups of {[len(g.members) for g in groups]} "
                             f"members, not {list(members)}")
    figs = []
    done = 0  # groups run
    with torch.no_grad():
        for step in chain._steps:
            if not isinstance(step, GroupStep):
                step.run(env)
                continue
            group = "ABCDEFGH"[done]
            done += 1
            refusals: list = []
            for part, (part_members, vals, prog) in enumerate(k7_parts(step, env,
                                                                       refusals)):
                label = group + (str(part + 1) if refusals else "")
                figs.append(k7_group(_cuda, part_members, vals, prog, label, path, B,
                                     pick, alone_figs, names))
                got = figs[-1].pop("got")
                env.update({k: got[k] for k in prog.escapes})
            if refusals:
                if group not in may_split or not all("shared memory" in r
                                                     for r in refusals):
                    raise AssertionError(f"{path}: group {group} split: {refusals}")
                print(f"K7 [{path}] group {group} ({len(step.members)} members) ran in "
                      f"{sum(f['label'].startswith(group) for f in figs)} parts: its "
                      f"lowering refused on shared memory ({refusals})", flush=True)
            if done == len(groups):
                break
    ptxas, ptxas64 = k7_ptxas(ptxas_log)
    print(f"K7 ptxas for generic_rows_kernel: {' | '.join(ptxas)}; for "
          f"generic_rows_kernel_f64: {' | '.join(ptxas64)}; on {card_line()}",
          flush=True)

    def total(q):
        return sum(f[q] for f in figs)

    worst = max(figs, key=lambda f: f["bound"])
    out = dict(
        max_abs_err=max(f["err"] for f in figs), ms=total("ms"),
        plain_ms=total("plain_ms"), bound_ms=total("bound"), bound_by=worst["by"],
        device_ms=total("dev_ms"), bound_share=total("bound") / total("ms"),
        device_bound_share=total("bound") / total("dev_ms"), ptxas=ptxas,
        ptxas_f64=ptxas64, f64=any(f["f64"] for f in figs),
    )
    if pick is not None:
        out["ops_alone"] = alone_figs
    for f in figs:
        lab = f["label"].lower()
        out.update({f"group_{lab}_ms": f["ms"], f"group_{lab}_device_ms": f["dev_ms"],
                    f"group_{lab}_plain_ms": f["plain_ms"],
                    f"group_{lab}_bound_ms": f["bound"],
                    f"group_{lab}_launch": f["launch"]})
        if len(figs) > 2:
            out[f"group_{lab}_ops"] = f["ops"]
    return out


def k7_group(_cuda, members, vals, prog, label, path, B, pick, alone_figs, names):
    """One K7 launch of :func:`k7_phase`: ``members`` (a group, or a part of
    one) on ``vals``, lowered as ``prog`` (the chain's escapes); every key it
    writes held against the plain walk (``check_generic``; a float64
    program's bit for bit, a ``double_pole_zero``'s against the kernel
    route, the ``inject`` and ``dense`` ops' bit for bit), the ops ``pick``
    names held and timed alone, then ``prog`` timed. Returns its figures,
    with every output of the launch under ``got``."""
    import torch

    import dspeed_tpu_torch.processors as tp
    from dspeed_tpu_torch.processors._tile_program import OPCODES

    every = sorted(s.key for s in prog.slots if not s.ext)
    full, got, want = store_every(_cuda, members, vals, every)
    torch.cuda.synchronize()
    err, rel, excused, conv_rows = check_generic(full, vals, got, want,
                                                 label)
    if full.f64:
        diff = [k for k in want if not same_bits(got[k], want[k])]
        if diff:
            raise AssertionError(f"K7 {label} [{path}]: {diff} differ from the "
                                 f"plain walk")
        print(f"K7 {label} [{path}]: all {len(want)} outputs of the float64 "
              f"program equal the plain walk's bit for bit on all {B} rows",
              flush=True)
    dpz = [op for op in full.ops if op.code == OPCODES["double_pole_zero"]]
    for op in dpz:
        src, dst = (full.slots[op.ins[0]].key, full.slots[op.outs[0]].key)
        if not same_bits(got[dst], want[dst]):
            raise AssertionError(f"K7 {label} {dst}: double_pole_zero differs "
                                 f"from the plain walk")
        x = got[src] if src in got else vals[src]
        alone = tp.double_pole_zero(x, *(a[1] for a in op.args[1:]))[0]
        g, w = got[dst].double(), alone.double()
        if not torch.equal(torch.isnan(g), torch.isnan(w)):
            raise AssertionError(f"K7 {label} {dst}: NaN rows differ from "
                                 f"the kernel route's")
        ok = ~torch.isnan(w)
        d = float((g[ok] - w[ok]).abs().max())
        scale = float(w[ok].abs().max())
        n_diff = int((g[ok] != w[ok]).sum())
        print(f"K7 {label} {dst} against double_pole_zero alone (the "
              f"recurrence kernel): max |diff| {d:.3e} ({d / scale:.3e} of "
              f"scale), {n_diff} of {int(ok.sum())} samples not equal",
              flush=True)
        if d > REL_TOL * scale:
            raise AssertionError(f"K7 {label} {dst}: off the kernel route")
    bits = [full.slots[sid].key for op in full.ops
            if op.code in (OPCODES["inject"], OPCODES["dense"]) for sid in op.outs]
    for key in bits:
        if not same_bits(got[key], want[key]):
            raise AssertionError(f"K7 {label} {key}: the {path} op differs "
                                 f"from the plain walk")
    if bits:
        print(f"K7 {label} [{path}]: the {len(bits)} outputs of its inject and "
              f"dense ops equal the plain walk's bit for bit on all {B} rows",
              flush=True)
    if pick is not None:
        alone_figs.update(k7_alone_ops(_cuda, full, got, vals, pick,
                                       f"{label} [{path}]", alone_figs, B))
    outs = _cuda.generic_rows(prog, vals)
    for k in prog.escapes:
        g, w = outs[k], got[k]
        if g.shape != w.shape or g.stride() != w.stride() or not bool(
                ((g == w) | (torch.isnan(g) & torch.isnan(w))).all()):
            raise AssertionError(f"K7 {label} {k}: the chain's launch differs")
    ms = time_ms(lambda: _cuda.generic_rows(prog, vals), 20)
    dev_ms = device_ms(lambda: _cuda.generic_rows(prog, vals))
    plain_ms = time_ms(lambda: _cuda.generic_rows_plain(prog, vals), 3, 1)
    bound, by = generic_bound(prog, B)
    launch = _cuda.generic_rows_launch(prog)
    if launch["local_bytes"] or launch["registers"] > (128 if prog.f64 else 80):
        raise AssertionError(f"K7 {label} [{path}]: launch {launch}")
    print(
        f"K7 generic_rows{'_f64' if prog.f64 else ''} [{path} group {label}: "
        f"{len(members)} members, "
        f"{len(prog.ops)} ops, {sum(op.plan for op in prog.ops)} planned "
        f"barriers, {len(prog.ext_keys)} inputs, "
        f"{len(prog.escapes)} escapes, {prog.smem_bytes} B of shared "
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
    return dict(label=label, ms=ms, dev_ms=dev_ms, plain_ms=plain_ms,
                bound=bound, by=by, err=err, launch=launch,
                ops=sorted({names[op.code] for op in prog.ops}),
                f64=prog.f64, got=got)


def new_ops_phase(build_processing_chain, lh5, _cuda, wf, bl, dev, db):
    """The ``inject`` and ``dense`` ops alone on the card at the injection +
    ML path's shapes: its four injector steps lowered as one program (the
    four ops and the row's load, nothing stored) and its five layer steps
    (the normalisation, two dense layers, two classifications, storing the
    two scores), each timed through the wrapper and on the device alone
    against its bound, the plain walk timed beside it. Returns the figures
    (``inject_op`` and ``dense_op``)."""
    import torch

    from dspeed_tpu_torch.processing_chain import KernelStep
    from dspeed_tpu_torch.processors._tile_program import (
        DENSE_KINDS, INJECT_KINDS, lower,
    )

    tb = lh5.Table({
        "waveform": lh5.WaveformTable(values=wf, t0=0.0, t0_units="ns", dt=DT,
                                      dt_units="ns"),
        "baseline": lh5.Array(bl.astype(np.float32)),
    })
    chain, _, _ = build_processing_chain(inject_ml_config(), tb, db_dict=db,
                                         device="cpu", fuse=False)
    inputs, B = chain._gather_inputs(0, len(wf))
    env = {k: v.to(dev) for k, v in chain._to_device(inputs).items()}
    env.update({k: v.to(dev) if isinstance(v, torch.Tensor) else v
                for k, v in chain._const_env().items()})
    with torch.no_grad():
        for step in chain._steps:
            step.run(env)
    figs = {}
    for label, kinds, keep in (("inject_op", INJECT_KINDS, ()),
                               ("dense_op", DENSE_KINDS, ("nn_score", "nn_score_nb"))):
        members = [st for st in chain._steps if isinstance(st, KernelStep)
                   and st.kernel.__name__ in kinds]
        writes = {sp.key for m in members for sp in m.out_specs}
        reads = set()
        for m in members:
            reads |= chain._step_env_reads(m)
        vals = {k: env[k] for k in sorted(reads - writes)}
        escapes = [k for k in sorted(writes) if k.split("#")[0] in keep]
        prog = lower(members, vals, escapes)
        _cuda.generic_rows(prog, vals)
        torch.cuda.synchronize()
        ms = time_ms(lambda: _cuda.generic_rows(prog, vals), 20)
        dev_ms = device_ms(lambda: _cuda.generic_rows(prog, vals))
        plain_ms = time_ms(lambda: _cuda.generic_rows_plain(prog, vals), 3, 1)
        bound, by = generic_bound(prog, B)
        launch = _cuda.generic_rows_launch(prog)
        print(f"K7 {label} alone [{len(members)} steps, {len(prog.ops)} ops, "
              f"{prog.smem_bytes} B of shared memory, {launch['blocks_per_sm']} blocks "
              f"per SM] {B} rows: kernel {ms:.4f} ms ({dev_ms:.4f} ms on the device "
              f"alone), plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({by}), "
              f"{bound / dev_ms:.1%} of the bound on the device alone; on "
              f"{card_line()}", flush=True)
        figs[label] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bound,
                           bound_by=by, launch=launch)
    return figs


def opt_phase(build_dsp, lh5, _cuda, wf, bl, card):
    """The optimisers through ``build_dsp`` (:func:`opt_configs`), Table ->
    Table: ``optimize_1pz`` on the flagship generator's rows ``wf`` (float32)
    from ``db.pz.tau``, its median tau within 1% of the generator's;
    ``optimize_2pz`` on the first ``OPT_2PZ_EVENTS`` events of the DPZ
    generator (the waveform in float64, as ``tools/optimize_2pz_reference.py``
    subtracts its baseline) from ``OPT_2PZ_START``, the recurrence kernel
    launched, and its objective at the result on the first
    ``OPT_2PZ_REF_EVENTS`` events (the port's, on the card, in float64)
    against the JAX package's at its own result, stored in ``OPT_2PZ_REF``:
    their sum at most ``max(2 x`` the JAX package's ``, 1e-2)`` (each event's
    share of that bound printed). Returns the figures."""
    import torch

    from dspeed_tpu_torch.processors.optimize import dpz_traced, slope_objective

    ref = np.load(OPT_2PZ_REF)
    stored = (tuple(ref["window"]), tuple(ref["bounds"]), tuple(ref["start"]),
              tuple(ref["events"]))
    want = (OPT_2PZ_WINDOW, OPT_2PZ_BOUNDS, OPT_2PZ_START,
            (OPT_2PZ_EVENTS, OPT_2PZ_REF_EVENTS))
    if stored != want:
        raise AssertionError(f"{OPT_2PZ_REF} was made for {stored}, not {want}: run "
                             f"tools/optimize_2pz_reference.py")
    one, two = opt_configs()

    def table(w, b):
        return lh5.Table({
            "waveform": lh5.WaveformTable(values=w, t0=0.0, t0_units="ns", dt=DT,
                                          dt_units="ns"),
            "baseline": lh5.Array(b.astype(np.float32)),
        })

    out = {}
    for label, cfg, w, b, db in (
            ("optimize_1pz", one, wf, bl, {"pz": {"tau": TAU}}),
            ("optimize_2pz", two, None, None, None)):
        if w is None:
            dwf, _amp, _t0, dbl, _rt = make_hpge_dpz_waveforms(OPT_2PZ_EVENTS)
            w, b = dwf.astype(np.float64), dbl
        _cuda.reset_launches()
        torch.cuda.synchronize()
        t_0 = time.time()
        res = build_dsp(table(w, b), dsp_config=cfg, database=db, n_entries=len(w),
                        buffer_len=len(w), device=DEVICE)
        torch.cuda.synchronize()
        secs = time.time() - t_0
        launches = dict(_cuda.LAUNCHES)
        cols = {k: np.asarray(res[k].nda) for k in cfg["outputs"]}
        out[label] = dict(events=len(w), seconds=secs, launches=launches)
        print(f"{label} through build_dsp on {card}: {len(w)} events x "
              f"{w.shape[1]} samples in {secs:.3f} s (the first call, the chain "
              f"built); launches {launches}", flush=True)
        if label == "optimize_1pz":
            med = float(np.nanmedian(cols["opt_tau"]))
            print(f"optimize_1pz: median tau {med!r} samples against the generator's "
                  f"{TAU!r} ({med / TAU - 1:+.4%})", flush=True)
            if abs(med / TAU - 1) > 0.01:
                raise AssertionError("optimize_1pz: the median tau is not within 1%")
            out[label]["median_tau"] = med
            continue
        n_rec = launches.get("recurrence", 0)
        if n_rec < 1 + 150:
            raise AssertionError(f"optimize_2pz launched the recurrence kernel "
                                 f"{n_rec} times, not once a Nelder-Mead step")
        n = OPT_2PZ_REF_EVENTS
        beg, end = OPT_2PZ_WINDOW
        rows = torch.from_numpy(w[:n] - b[:n, None].astype(np.float32)
                                .astype(np.float64)).to(DEVICE)
        pars = [torch.from_numpy(cols[k][:n].astype(np.float64)).to(DEVICE)
                for k in ("opt_tau1", "opt_tau2", "opt_frac")]
        with torch.no_grad():
            obj = slope_objective(dpz_traced(rows, *pars, end=end), beg, end).cpu().numpy()
        jax_obj = ref["objective_centered"]
        total, bound = float(obj.sum()), max(2.0 * float(jax_obj.sum()), 1e-2)
        each = int((obj <= np.maximum(2.0 * jax_obj, 1e-2)).sum())
        print(f"optimize_2pz: {n_rec} recurrence launches; objective on the first {n} "
              f"events: sum {total!r} against the JAX package's {float(jax_obj.sum())!r} "
              f"(bound {bound!r}); median {float(np.median(obj))!r} against "
              f"{float(np.median(jax_obj))!r}; {each} of {n} events within max(2 x the "
              f"JAX package's, 1e-2); medians tau1 {float(np.nanmedian(cols['opt_tau1']))!r}, "
              f"tau2 {float(np.nanmedian(cols['opt_tau2']))!r}, frac "
              f"{float(np.nanmedian(cols['opt_frac']))!r} (start {OPT_2PZ_START})",
              flush=True)
        if not np.isfinite(obj).all() or total > bound:
            raise AssertionError("optimize_2pz: the objective at the result is above "
                                 "the bound")
        out[label].update(objective_sum=total, jax_objective_sum=float(jax_obj.sum()),
                          events_within=each, recurrence_launches=n_rec)
    return out


def plain_recurrence():
    """A context in which the recurrence's clients run its plain version
    (``_cuda.recurrence_plain``, a PyTorch loop over the samples) on the
    card, in place of the kernel."""
    import contextlib

    from dspeed_tpu_torch.processors import _cuda

    @contextlib.contextmanager
    def ctx():
        kernel = _cuda.recurrence
        _cuda.recurrence = _cuda.recurrence_plain
        try:
            yield
        finally:
            _cuda.recurrence = kernel

    return ctx()


def recurrence_phase(_cuda, w, ptxas_log):
    """The recurrence kernel (``csrc/recurrence.cu``) through each of its
    clients at the main path's shape, ``w`` the flagship DPZ's baseline-less
    rows on the card (a NaN row and an infinite sample included): the
    first-order recursion at the DPZ pole (``_numerics.iir_first_order``),
    ``rc_cr2`` with a constant and a per-event tau, ``convolve_exp``, a
    notch biquad, ``recursive_filter`` of order 3, ``fixed_time_pickoff``
    mode ``'s'`` and ``interpolating_upsampler`` mode ``'s'`` (x2), each
    held bit for bit against the same call with the plain recurrence;
    ``rc_cr2``'s row with ``w[0] = -inf`` NaN from sample 3 on (F9).
    Times the first-order call through the wrapper and on the device alone
    against its byte bound (each row read and written once), and on the
    device alone the float64 instance that ``rc_cr2``'s stages run (a seed
    a row)."""
    import torch

    import dspeed_tpu_torch.processors as tp
    from dspeed_tpu_torch.processors import _numerics
    from dspeed_tpu_torch.processors.pole_zero import dpz_constants

    B, n = w.shape
    x = w.clone()
    x[9, 2000] = float("inf")
    x[11, 0] = -float("inf")  # F9: rc_cr2 gives NaN from sample 3 on
    p = dpz_constants(DPZ["tau1"], DPZ["tau2"], DPZ["frac"])["p"]
    taus = torch.linspace(20.0, 200.0, B, device=w.device)
    picks = torch.linspace(-1.0, n + 1.0, B, device=w.device)
    a3, b4 = np.array([0.2, 0.3, 0.1]), np.array([1.0, -1.2, 0.4, -0.1])
    clients = {
        "iir_first_order": lambda: _numerics.iir_first_order(x, p),
        "rc_cr2": lambda: tp.rc_cr2(x, 50.0)[0],
        "rc_cr2 per event": lambda: tp.rc_cr2(x, taus)[0],
        "convolve_exp": lambda: tp.convolve_exp(x, 100.0)[0],
        "notch_filter": lambda: tp.notch_filter(0.1, 0.02)(x)[0],
        "recursive_filter order 3": lambda: tp.recursive_filter(x, a3, b4, 0.0, 0.0)[0],
        "fixed_time_pickoff 's'": lambda: tp.fixed_time_pickoff(x, picks, ord("s"))[0],
        "interpolating_upsampler 's'": lambda: tp.interpolating_upsampler(
            x, ord("s"), dims={"m": 2 * n})[0],
    }
    launches = {}
    with torch.no_grad():
        for name, fn in clients.items():
            before = _cuda.LAUNCHES["recurrence"]
            got = fn()
            launches[name] = _cuda.LAUNCHES["recurrence"] - before
            with plain_recurrence():
                want = fn()
            torch.cuda.synchronize()
            if not launches[name] or not same_bits(got, want):
                raise AssertionError(f"recurrence [{name}]: the kernel's call differs "
                                     f"from the plain version's (or did not launch)")
            if name == "rc_cr2" and not (bool(torch.isnan(got[11, 3:]).all())
                                         and bool(torch.isfinite(got[11, 1:3]).all())):
                raise AssertionError("rc_cr2: a row with w[0] = -inf is not NaN from "
                                     "sample 3 on (F9)")
            print(f"recurrence [{name}] {tuple(got.shape)}: bit for bit against the "
                  f"plain recurrence ({launches[name]} launches)", flush=True)
            del got, want
        ms = time_ms(lambda: _numerics.iir_first_order(w, p), 20)
        dev_ms = device_ms(lambda: _numerics.iir_first_order(w, p))
        plain_ms = time_ms(lambda: _cuda.recurrence_plain(w, p), 2, 1)
        # a stage of rc_cr2 (the flagship extras'): float64 rows of n - 3
        # samples at its pole, a seed a row
        a_rc = float(np.exp(-1.0 / EXTRAS_RC_TAU))
        u64, y64 = w[:, 3:].double(), w[:, 2].double()
        dev64_ms = device_ms(lambda: _numerics.iir_first_order(u64, a_rc, y_init=y64))
    bound = 2 * w.numel() * w.element_size() / PEAK_BYTES_S * 1e3
    bound64 = (2 * u64.numel() + B) * 8 / PEAK_BYTES_S * 1e3
    launch = _cuda.recurrence_launch()
    ptxas = ptxas_report(ptxas_log, "recurrence_kernel")
    local = sorted(k for k, v in ptxas.items()
                   if "0 bytes spill stores" not in v or "0 bytes stack frame" not in v)
    ptxas = ([f"{len(ptxas)} instances, spills or a stack frame in {len(local)}"]
             + [f"{k}: {ptxas[k]}" for k in local])
    print(f"recurrence [first order, {B}x{n} f32]: kernel {ms:.4f} ms through the "
          f"wrapper ({dev_ms:.4f} ms on the device alone), plain {plain_ms:.4f} ms, "
          f"byte bound {bound:.4f} ms, {bound / ms:.1%} of it ({bound / dev_ms:.1%} "
          f"on the device alone); float64, rc_cr2's stage ({B}x{n - 3}, a seed a "
          f"row) {dev64_ms:.4f} ms on the device alone, {bound64 / dev64_ms:.1%} of "
          f"its {bound64:.4f} ms byte bound; launch: {launch['rows']} rows and "
          f"{launch['threads']} threads a block, "
          f"{launch['smem_bytes']} B of shared memory, {launch['blocks_per_sm']} "
          f"blocks per SM, {launch['registers']} registers and "
          f"{launch['local_bytes']} local bytes a thread; ptxas {' | '.join(ptxas)}; "
          f"on {card_line()}", flush=True)
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by="bytes", device_ms=dev_ms, bound_share=bound / ms,
                device_bound_share=bound / dev_ms, f64_device_ms=dev64_ms,
                f64_bound_ms=bound64, launch=launch, ptxas=ptxas,
                client_launches=launches)


def sipm_table(lh5, wf):
    return lh5.Table({"waveform": lh5.WaveformTable(
        values=wf, t0=0.0, t0_units="ns", dt=DT, dt_units="ns")})


def same_bits(a, b) -> bool:
    """Equal values, NaN where NaN, of equal shape and type (two tensors)."""
    import torch

    return (a.shape == b.shape and a.dtype == b.dtype
            and bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all()))


def sipm_group(build_processing_chain, lh5, wf, dev):
    """The SiPM chain's K7 group (``reflected_convolve_wf`` and
    ``avg_current``) built on the CPU over ``wf``: ``(step, its inputs on
    dev, rows)``."""
    from dspeed_tpu_torch.processing_chain import GroupStep

    chain, _, _ = build_processing_chain(sipm_config(), sipm_table(lh5, wf),
                                         device="cpu")
    groups = [s for s in chain._steps if isinstance(s, GroupStep)]
    kinds = [[m.kernel.__name__ for m in g.members] for g in groups]
    if kinds != [["reflected_convolve_wf", "avg_current"]]:
        raise AssertionError(f"SiPM generic groups {kinds}")
    (step,) = groups
    inputs, B = chain._gather_inputs(0, len(wf))
    env = {k: v.to(dev) for k, v in chain._to_device(inputs).items()}
    return step, {k: env[k] for k in step.ext_in}, B


def sipm_k7_phase(build_processing_chain, lh5, _cuda, wf, dev):
    """K7 on the SiPM chain's group (``reflected_convolve_wf`` and
    ``avg_current``, float64 from the smoothed waveform on), lowered from
    the chain the port builds on the CPU over ``wf`` (``sipm_edge_rows``:
    a NaN row, a row with an infinite sample, a row whose reflected edges
    hold its extremes). Every key the group writes, on every row, must
    equal the tape's plain walk bit for bit; the chain's own launch (its
    escape ``curr``) is timed against the plain walk, through the wrapper
    and on the device alone. Returns the figures and ``curr``."""
    from dspeed_tpu_torch.processors._tile_program import lower

    step, vals, B = sipm_group(build_processing_chain, lh5, wf, dev)
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


def scan_ptxas(log: str, kernel: str) -> list:
    """``ptxas -v``'s line for each instance of a sweep ``kernel`` (float32
    and float64): registers, stack frame, spills."""
    rep = ptxas_report(log, kernel)
    if len(rep) != 2:
        raise AssertionError(f"{kernel}: ptxas reports {sorted(rep)}")
    return [f"{'float64' if 'IdE' in k else 'float32'}: {v}"
            for k, v in sorted(rep.items())]


def peakdet_edge_check(_cuda, dev) -> str:
    """The sweep on ``peakdet_edge_rows`` (1019 samples, 20 + 20 slots) in
    float32 and float64, both directions, rows contiguous and at a stride
    of 1024 from an offset of 1: every output equal to the plain version's
    bit for bit. Returns a summary."""
    import torch

    w, pars = peakdet_edge_rows(1019)
    m = SIPM_SLOTS
    declared = []
    for dt in (torch.float32, torch.float64):
        rows = torch.from_numpy(w).to(dev, dt)
        wide = torch.full((len(w), 1024), float("nan"), dtype=dt, device=dev)
        wide[:, 1:1020] = rows
        args = [torch.from_numpy(p).to(dev, dt) for p in pars]
        for reverse in (False, True):
            want = _cuda.peakdet_scan_plain(rows, *args, m, m, reverse)
            for layout, x in (("contiguous", rows), ("strided", wide[:, 1:1020])):
                got = _cuda.peakdet_scan(x, *args, m, m, reverse)
                for name, g, r in zip(("vt_max", "vt_min", "n_max", "n_min"), got, want):
                    if not same_bits(g, r):
                        raise AssertionError(f"peakdet_scan edge rows ({dt}, {layout}, "
                                             f"reverse={reverse}) {name}: not the plain "
                                             f"version's bits")
                declared.append(int(got[2].sum() + got[3].sum()))
    return (f"{len(w)} edge rows (float32 and float64, both directions, contiguous and "
            f"strided: {declared} extrema declared) bit for bit")


def sipm_scan_phase(_cuda, curr, ptxas_log):
    """The peak finder's sweep (``csrc/peakdet_scan.cu``) on the SiPM
    group's ``curr`` with the chain's parameters (``dmax`` 5, ``dmin`` 0.1,
    ``amax`` = 3 fwhm from the port's ``histogram_stats``, ``amin`` 0, 20
    slots each), one launch a direction: both directions' slots and counts
    equal to the plain version on every row, rows of NaN fwhm included (one
    set NaN, ``NAN_FWHM_ROW``, beside those the histogram gives) and a row
    that fills all 20 slots (``FULL_SLOT_ROW``, its ``amax`` set to 0); the
    same on ``peakdet_edge_rows`` (``peakdet_edge_check``). Directions 2
    and 3 through the processor against the processor on the CPU. Times the
    float64 rows right to left (the chain's launch) and the same rows in
    float32. Returns the figures."""
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
    edges = peakdet_edge_check(_cuda, curr.device)
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
    c32, a32 = curr.float(), amax.float()
    args32 = (SIPM_DMAX, SIPM_DMIN, a32, 0.0, m, m)
    dev32_ms = device_ms(lambda: _cuda.peakdet_scan(c32, *args32, reverse=True))
    plain_ms = time_ms(
        lambda: _cuda.peakdet_scan_plain(curr, *args, reverse=True), 1, 1)
    bound = scan_bound(curr, m, m)
    bound32 = scan_bound(c32, m, m)
    launch = _cuda.peakdet_scan_launch()
    ptxas = scan_ptxas(ptxas_log, "peakdet_scan_kernel")
    B, n = curr.shape
    print(
        f"peakdet_scan {B} rows x {n} {str(curr.dtype).split('.')[-1]} samples, "
        f"{m} + {m} slots: both directions equal to the plain version bit for "
        f"bit on every row ({natural_nan} rows of NaN fwhm from the histogram, "
        f"row {NAN_FWHM_ROW} set NaN, {full_rows} rows filling all {m} slots), "
        f"{edges}, directions 2 and 3 through the processor equal to the CPU's; "
        f"kernel {ms:.4f} ms ({dev_ms:.4f} ms on the device alone), plain "
        f"{plain_ms:.1f} ms, bound {bound:.4f} ms (bytes), {bound / ms:.1%} of the "
        f"bound ({bound / dev_ms:.1%} on the device alone); the same rows in "
        f"float32 {dev32_ms:.4f} ms on the device alone ({bound32 / dev32_ms:.1%} of "
        f"its {bound32:.4f} ms bound); launch: {launch['threads']} threads a "
        f"block (a warp a row), {launch['blocks_per_sm']} blocks per SM, "
        f"{launch['registers']} registers and {launch['local_bytes']} local bytes "
        f"a thread; ptxas {' | '.join(ptxas)}; on {card_line()}",
        flush=True,
    )
    return dict(max_abs_err=0.0, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by="bytes", bound_share=bound / ms,
                device_bound_share=bound / dev_ms, f32_device_ms=dev32_ms,
                f32_bound_ms=bound32, launch=launch, ptxas=ptxas,
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
                warm_wfps=n_ev / warm_s, pulse_err=err,
                cols={k: column_arrays(out[k], n_ev) for k in cfg["outputs"]})


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


def sipm_f64_phase(build_dsp, lh5, _cuda, wf, want, card):
    """The SiPM chain on ``wf`` widened to float64 (the rows of the float32
    SiPM path): ``build_dsp`` on the card, Table -> Table, twice (a
    chain-cache hit); one chunk: its one generic group lowered as a float64
    program (K7's float64 kernel) and launched once, ``peakdet_scan`` once
    on its float64 current, no split. Widening is exact and both chains
    take the same float64 products and sums, so every VoV column equals the
    float32 path's (``want``) bit for bit on every event. Returns the
    launch counts and rates."""
    import torch

    from dspeed_tpu_torch.processing_chain import GroupStep
    from dspeed_tpu_torch.processors import _tile_program

    cfg = sipm_config()
    tb = sipm_table(lh5, wf.astype(np.float64))
    n_ev = len(wf)
    bdsp = sys.modules[build_dsp.__module__]
    bdsp._CHAIN_CACHE.clear()

    def timed():
        torch.cuda.synchronize()
        t_0 = time.time()
        out = build_dsp(tb, dsp_config=cfg, n_entries=n_ev, buffer_len=n_ev,
                        device=DEVICE)
        torch.cuda.synchronize()
        return out, time.time() - t_0

    _cuda.reset_launches()
    _tile_program.reset_splits()
    out, cold_s = timed()
    launches = dict(_cuda.LAUNCHES)
    splits = dict(_tile_program.SPLITS)
    with counted_builds(build_dsp) as builds:
        _, warm_s = timed()
    if builds.n:
        raise AssertionError("[float64 SiPM] the second build_dsp call built a chain")
    ((chain, *_),) = bdsp._CHAIN_CACHE.values()
    progs = [p for st in chain._steps if isinstance(st, GroupStep)
             for p in st._programs.values()]
    if splits or len(progs) != 1 or not progs[0].f64:
        raise AssertionError(f"[float64 SiPM] splits {splits}; programs "
                             f"{[p.f64 for p in progs]}, not one float64 program")
    for name in ("generic_rows", "peakdet_scan"):
        if launches.get(name, 0) != 1:
            raise AssertionError(f"[float64 SiPM] {name} launched "
                                 f"{launches.get(name, 0)} times on one chunk")
    for k, arrs in want.items():
        got = column_arrays(out[k], n_ev)
        for q, w in arrs.items():
            if got[q].dtype != w.dtype or got[q].tobytes() != w.tobytes():
                raise AssertionError(f"[float64 SiPM] {k} {q} differs from the "
                                     f"float32 SiPM path's")
    print(f"build_dsp [float64 SiPM] Table -> Table, {n_ev} events x {wf.shape[1]} "
          f"float64 samples: launches {launches} (one float64 K7 program, no "
          f"split); every VoV column of every event equal to the float32 SiPM "
          f"path's bit for bit; first call {cold_s:.3f} s ({n_ev / cold_s:.0f} "
          f"wf/s), second call {warm_s:.3f} s ({n_ev / warm_s:.0f} wf/s, a "
          f"chain-cache hit) on {card}", flush=True)
    return dict(launches=launches, first_wfps=n_ev / cold_s, warm_wfps=n_ev / warm_s)


# the examples' steps that read or write LH5 files or draw: the modules
# each needs (the card's machine may lack them)
EXAMPLE_FILE_STEPS = (
    ("quickstart steps 1, 3, 4 (raw and DSP LH5 files)", ("h5py",)),
    ("quickstart step 5 on files", ("h5py",)),
    ("quickstart step 6 (the browser drawn to PNG)", ("h5py", "matplotlib")),
    ("SiPM tutorial steps 2 to 4 on files", ("h5py",)),
    ("browse_waveforms_torch.main (raw file, PNGs)", ("h5py", "matplotlib")),
)
EXAMPLE_CPU_EVENTS = 1024  # events of each example held against the CPU run
EXAMPLE_BAD = 12345  # the quickstart's checked table: its bad pick-off (of 16384)


def example_columns(name, got, want, n, exact=()) -> float:
    """The first ``n`` events of an example's columns (arrays, or a VoV's
    dict of arrays) against the CPU run's: NaN positions and counts (a
    VoV's cumulative lengths, the ``exact`` columns) equal, every float
    value within REL_TOL of its column's scale. Returns the worst error
    over scale."""
    worst = 0.0
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            if g["cumulative_length"].tobytes() != w["cumulative_length"].tobytes():
                raise AssertionError(f"examples [{name}] {k}: counts differ from "
                                     f"the CPU run's")
            g, w = g["flattened_data"], w["flattened_data"]
        g, w = np.asarray(g[:n], np.float64), np.asarray(w[:n], np.float64)
        if g.shape != w.shape or not np.array_equal(np.isnan(g), np.isnan(w)):
            raise AssertionError(f"examples [{name}] {k}: NaN positions differ")
        ok = ~np.isnan(w)
        if not ok.any():
            continue
        err = float(np.abs(g[ok] - w[ok]).max())
        if k in exact and err:
            raise AssertionError(f"examples [{name}] {k}: not the CPU run's")
        scale = max(float(np.abs(w[ok]).max()), 1e-30)
        if err > REL_TOL * scale:
            raise AssertionError(f"examples [{name}] {k}: {err:.3e} > REL_TOL of "
                                 f"its scale {scale:.3e}")
        worst = max(worst, err / scale)
    return worst


def examples_phase(_cuda, card, n_ev=N_EVENTS):
    """The port's examples (``examples/*_torch.py``) on the card, each step
    that needs neither ``h5py`` nor ``matplotlib``, at full width, through
    the examples' own functions: the quickstart's in-memory chain
    (``step7_in_memory``) on ``n_ev`` x 4096 events with its ``trapEmax``
    check and its checked mode on an in-memory table (``checked_in_memory``,
    the bad event at ``EXAMPLE_BAD``: its exact ``wf_range``), the hand
    kernels K1 to K5 once on its one chunk; the browser
    example's two browsers on that table, entries found, not drawn; the SiPM
    tutorial's production Table -> Table on ``n_ev`` x 1024 events with its
    efficiency and energy checks (``check_pulses``), then checked mode; the
    multi-channel example on 4 channels x ``n_ev / 4`` events under NCCL at
    world size 1 (one dispatch: K1 once), ``trapEmax`` equal to the
    unsharded chain bit for bit.
    The first ``EXAMPLE_CPU_EVENTS`` events of each against the CPU run
    within REL_TOL of each column's scale, counts exactly. Each path's
    launches counted around it. The steps that read or write files or
    draw run where their modules are installed; one line names those that
    did not, and the module that stopped each. Returns the figures."""
    import importlib.util

    import torch

    sys.path.insert(0, os.path.join(REPO, "examples"))
    import browse_waveforms_torch as bw
    import multichannel_torch as mc
    import quickstart_torch as qs
    import sipm_pulse_finding_torch as sp

    from dspeed_tpu_torch.processing_chain import build_processing_chain

    n_cpu = EXAMPLE_CPU_EVENTS
    figs = {}

    def run(label, fn):
        torch.cuda.synchronize()
        _cuda.reset_launches()
        t_0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        figs[label] = dict(seconds=time.time() - t_0, launches=dict(_cuda.LAUNCHES))
        return out

    # the quickstart: the in-memory chain, at full width
    wf, amp, bl = events = qs.make_waveforms(n_ev)
    tb_out = run("quickstart step 7", lambda: qs.step7_in_memory(DEVICE, events=events))
    if any(figs["quickstart step 7"]["launches"].get(k, 0) != 1
           for k in FLAGSHIP_KERNELS):
        raise AssertionError(f"examples [quickstart]: launches "
                             f"{figs['quickstart step 7']['launches']}")
    chain, _, cpu_out = build_processing_chain(
        qs.CONFIG, qs.raw_table(wf[:n_cpu], bl[:n_cpu]), db_dict=qs.DB, device="cpu")
    chain(qs.raw_table(wf[:n_cpu], bl[:n_cpu]), cpu_out)
    cols = {k: np.asarray(tb_out[k].nda) for k in tb_out.keys()}
    n_ex, worst = compare_columns(cols, {k: np.asarray(v.nda) for k, v in cpu_out.items()},
                                  wf, bl, n_cpu)
    figs["quickstart step 7"].update(worst_rel=worst, excused=n_ex)
    bad = EXAMPLE_BAD * n_ev // N_EVENTS  # a Table is one chunk
    err = run("quickstart checked", lambda: qs.checked_in_memory(
        qs.checked_table(n_ev, bad, wf=wf), DEVICE, bad=bad))
    figs["quickstart checked"]["wf_range"] = list(err.wf_range)
    # the browser example's two browsers on the same events, not drawn
    tb = bw.raw_table(wf, bl)

    def browse():
        wb = bw.curves_browser(tb, DEVICE)
        wb.find_entry(17)
        wb2 = bw.aligned_browser(tb, DEVICE)
        wb2.find_next()
        return wb, wb2

    wb, wb2 = run("browser", browse)
    cpu_wb = bw.curves_browser(bw.raw_table(wf[:n_cpu], bl[:n_cpu]), "cpu")
    cpu_wb.find_entry(17)
    for k, lines in wb.lines.items():
        g = np.asarray(lines[0].get_ydata(), np.float64)
        w = np.asarray(cpu_wb.lines[k][0].get_ydata(), np.float64)
        ok = np.isfinite(w)
        if not np.array_equal(np.isfinite(g), ok) or np.abs(g[ok] - w[ok]).max() > (
                REL_TOL * max(np.abs(w[ok]).max(), 1e-30)):
            raise AssertionError(f"examples [browser] {k}: entry 17 differs from "
                                 f"the CPU browser's")
    peaks = [float(np.nanmax(line.get_ydata())) for line in wb2.lines["wf_pz"]]
    if not all(abs(p - 1) < 0.01 for p in peaks):
        raise AssertionError(f"examples [browser] the aligned browser's peaks {peaks}")
    del events, wf, amp, bl, tb, tb_out, wb, wb2
    # the SiPM tutorial: production Table -> Table, then checked mode
    swf, truth = sp.make_sipm_waveforms(n_ev)
    stb = sp.raw_table(swf)
    out = run("SiPM production", lambda: sp.produce(stb, DEVICE))
    n_found = sp.check_pulses(out, truth)
    la = figs["SiPM production"]["launches"]
    if la.get("generic_rows") != 1 or la.get("peakdet_scan") != 1:
        raise AssertionError(f"examples [SiPM] launches {la}: not one K7 and one "
                             f"sweep on the table's one chunk")
    cpu = sp.produce(sp.raw_table(swf[:n_cpu]), "cpu")
    keys = ("trigger_pos", "energies")
    figs["SiPM production"].update(
        pulses=int(n_found.sum()),
        worst_rel=example_columns("SiPM", {k: column_arrays(out[k], n_cpu) for k in keys},
                                  {k: column_arrays(cpu[k], n_cpu) for k in keys},
                                  n_cpu, exact=("trigger_pos",)))
    run("SiPM checked", lambda: sp.checked_in_memory(stb, DEVICE))
    del swf, stb, out
    # the multi-channel example: 4 channels stacked, NCCL at world size 1
    n_chan, per = 4, n_ev // 4
    te, mamp, shape = run("multi-channel", lambda: mc.run(DEVICE, n_chan, per))
    flat = mc.unsharded(DEVICE, n_chan, per)
    if te.tobytes() != flat.tobytes():
        raise AssertionError("examples [multi-channel] the stacked mesh run differs "
                             "from the unsharded chain")
    m = min(n_cpu, per)  # channel 0's first events
    mwf, _, mbl = mc.make_channels(n_chan, per)
    mtb = mc.table(mwf[:m], mbl[:m])
    mch, _, _ = build_processing_chain(mc.CONFIG, mtb, device="cpu")
    figs["multi-channel"].update(
        mesh=shape, mean_rel_err=float(np.nanmean(np.abs(te - mamp) / mamp)),
        worst_rel=example_columns("multi-channel", {"trapEmax": te[0]},
                                  {"trapEmax": np.asarray(mch(mtb)["trapEmax"].nda)}, m))
    if figs["multi-channel"]["launches"].get("fused_energy", 0) != 1:
        raise AssertionError(f"examples [multi-channel] launches "
                             f"{figs['multi-channel']['launches']}")
    # the file and drawing steps, where their modules are installed
    missing = {m for _, mods in EXAMPLE_FILE_STEPS for m in mods
               if importlib.util.find_spec(m) is None}
    skipped = [f"{step} (no {', no '.join(m for m in mods if m in missing)})"
               for step, mods in EXAMPLE_FILE_STEPS if missing & set(mods)]
    if not missing:
        with tempfile.TemporaryDirectory() as tmp:
            raw, qamp = qs.step1_write_raw(tmp, n=n_cpu)
            qs.step4_read_back(qs.step3_production(raw, tmp, DEVICE), qamp)
            qs.step5_checked_mode(tmp, DEVICE)
            qs.step6_browser(raw, tmp, DEVICE)
            sp.step3_read_vov(*sp.step2_production(tmp, DEVICE, n=n_cpu))
            sp.step4_checked_mode(tmp, DEVICE)
            bw.main(["--device", DEVICE])
    for label, f in figs.items():
        print(f"examples [{label}] on {DEVICE}: {f['seconds']:.3f} s, launches "
              f"{f['launches']}" + "".join(f", {k} {v}" for k, v in f.items()
                                           if k not in ("seconds", "launches")),
              flush=True)
    print(f"examples: {n_ev} x 4096 quickstart events (trapEmax within 2%, checked "
          f"wf_range {tuple(err.wf_range)}), {n_ev} x 1024 SiPM events "
          f"({int(n_found.sum())} pulses, efficiency above 85%, energies "
          f"positive), {n_chan} x {per} stacked channels over the mesh {shape}; "
          f"the first {n_cpu} events of each within REL_TOL of the CPU run's; "
          f"on {card}", flush=True)
    print("examples: steps that did not run on the card: "
          + ("; ".join(skipped) if skipped else "none"), flush=True)
    figs["not_run"] = skipped
    return figs


def f64_columns(cols, cpu, n_cpu, label) -> float:
    """A float64 chain's first ``n_cpu`` events against the port's CPU run:
    NaN positions equal, every column within F64_ATOL + F64_REL of its
    scale (the golden replay's tolerance); returns the worst error over
    scale."""
    worst = 0.0
    for k, v in cols.items():
        g, w = v[:n_cpu].astype(np.float64), np.asarray(cpu[k], np.float64)
        if not np.array_equal(np.isnan(g), np.isnan(w)):
            raise AssertionError(f"[{label}] {k}: NaN positions differ from the CPU run")
        ok = np.isfinite(w)
        if not ok.any():
            continue
        err = float(np.abs(g[ok] - w[ok]).max())
        scale = float(np.abs(w[ok]).max())
        if err > F64_ATOL + F64_REL * scale:
            raise AssertionError(f"[{label}] {k}: card vs CPU max diff {err:.3e} > "
                                 f"{F64_ATOL + F64_REL * scale:.3e}")
        worst = max(worst, err / max(scale, 1e-30))
    return worst


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


def bilevel_bound(B, n, m, itemsize=4) -> float:
    """The sweep's least time: each row read once, the slots, counts and
    per-row parameters moved once, over the card's memory rate."""
    nbytes = B * (n * itemsize + 2 * m * itemsize + 4 + 2 * itemsize + 2 * 4)
    return nbytes / PEAK_BYTES_S * 1e3


def bilevel_rows(wf, bl, dev):
    """The flagship extras' ``rc_cr2`` rows (``EXTRAS_RC_TAU``) of ``wf``
    on ``dev`` with the chain's thresholds (+-500) and gate (200), and rows
    made to hit the state machine's corners: a NaN sample (row 3), an
    infinite one (row 4), a sine that crosses more often than the slots hold
    (row 5), a start in the middle of the pulse (row 6), a gate of 5 samples
    (row 7). Returns ``(rows, pos, neg, gate, start)``."""
    import torch

    import dspeed_tpu_torch.processors as tp

    x = torch.from_numpy(wf).to(dev) - torch.from_numpy(bl.astype(np.float32)).to(dev)[:, None]
    rc = tp.rc_cr2(x, float(EXTRAS_RC_TAU))[0].contiguous()
    del x
    B, n = rc.shape
    rc[3, 700] = float("nan")
    rc[4, 2000] = float("inf")
    i = torch.arange(n, device=dev, dtype=torch.float32)
    rc[5] = 3000 * torch.sin(2 * np.pi * i / 64)
    pos = torch.full((B,), 500.0, device=dev)
    gate = torch.full((B,), 200, dtype=torch.int32, device=dev)
    gate[7] = 5
    start = torch.zeros(B, dtype=torch.int32, device=dev)
    start[6] = 1000
    return rc, pos, -pos, gate, start


def bilevel_edge_check(_cuda, dev) -> str:
    """The sweep on ``bilevel_edge_rows`` (4096 samples) in float32 and
    float64, rows aligned (16-byte loads) and from an offset of 3 at a
    stride of 2n, with 8 and 40 slots: every output equal to the plain
    version's bit for bit. Returns a summary."""
    import torch

    w, (pos, neg), (gate, start) = bilevel_edge_rows(N_SAMPLES)
    B, n = w.shape
    gate_t, start_t = (torch.from_numpy(a).to(dev) for a in (gate, start))
    counts = []
    for dt in (torch.float32, torch.float64):
        rows = torch.from_numpy(w).to(dev, dt)
        wide = torch.cat([rows, rows], 1)
        wide[:, 3:3 + n] = rows
        p, q = (torch.from_numpy(a).to(dev, dt) for a in (pos, neg))
        # the plain version once, on the CPU, at the most slots: the first m
        # of them are m's
        ref = _cuda.bilevel_scan_plain(rows.cpu(), p.cpu(), q.cpu(), gate_t.cpu(),
                                       start_t.cpu(), 40)
        for layout, x, m in (("aligned", rows, EXTRAS_SLOTS),
                             ("strided", wide[:, 3:3 + n], 40)):
            got = _cuda.bilevel_scan(x, p, q, gate_t, start_t, m)
            want = (ref[0], ref[1][:, :m], ref[2][:, :m])
            for name, g, r in zip(("n_crossings", "polarity", "trigger"), got, want):
                if not same_bits(g.cpu(), r.contiguous()):
                    raise AssertionError(f"bilevel_scan edge rows ({dt}, {layout}) "
                                         f"{name}: not the plain version's bits")
            counts.append(int(got[0].sum()))
    return (f"{B} edge rows (float32 and float64, aligned and strided: {counts} "
            f"triggers) bit for bit")


def bilevel_phase(_cuda, wf, bl, dev, ptxas_log):
    """The bi-level trigger's sweep (``csrc/bilevel_scan.cu``) on
    ``bilevel_rows`` of every event with ``EXTRAS_SLOTS`` slots. Every
    count, polarity and sample equal to the plain version's bit for bit on
    the whole chunk, in float32 and on the same rows widened to float64, and
    on ``bilevel_edge_rows`` (``bilevel_edge_check``); times through the wrapper, on the device
    alone and of the plain version (a PyTorch loop over the samples, on the
    card), against the byte bound, and the float64 instance on the device
    alone."""
    import torch

    rc, pos, neg, gate, start = bilevel_rows(wf, bl, dev)
    B, n = rc.shape
    m = EXTRAS_SLOTS
    before = _cuda.LAUNCHES["bilevel_scan"]
    got = _cuda.bilevel_scan(rc, pos, neg, gate, start, m)
    if _cuda.LAUNCHES["bilevel_scan"] != before + 1:
        raise AssertionError("bilevel_scan: the wrapper did not launch its kernel once")
    torch.cuda.synchronize()
    t_0 = time.time()
    want = _cuda.bilevel_scan_plain(rc, pos, neg, gate, start, m)
    torch.cuda.synchronize()
    plain_ms = (time.time() - t_0) * 1e3
    for name, g, w in zip(("n_crossings", "polarity", "trigger"), got, want):
        if not same_bits(g, w):
            raise AssertionError(f"bilevel_scan {name}: not the plain version's bits")
    nc = got[0].cpu().numpy()
    if nc[5] <= m or not (nc > 0).mean() > 0.9:
        raise AssertionError(f"bilevel_scan: counts {np.bincount(nc)[:12]} (row 5 {nc[5]})")
    rc64, pos64, neg64 = rc.double(), pos.double(), neg.double()
    got64 = _cuda.bilevel_scan(rc64, pos64, neg64, gate, start, m)
    for name, g, w in zip(("n_crossings", "polarity", "trigger"), got64, got):
        if not same_bits(g, w.double() if w.is_floating_point() else w):
            raise AssertionError(f"bilevel_scan float64 {name}: not the float32 rows' "
                                 f"result on the same rows widened")
    edges = bilevel_edge_check(_cuda, dev)
    ms = time_ms(lambda: _cuda.bilevel_scan(rc, pos, neg, gate, start, m), 20)
    dev_ms = device_ms(lambda: _cuda.bilevel_scan(rc, pos, neg, gate, start, m))
    dev64_ms = device_ms(lambda: _cuda.bilevel_scan(rc64, pos64, neg64, gate, start, m))
    bound = bilevel_bound(B, n, m)
    bound64 = bilevel_bound(B, n, m, itemsize=8)
    launch = _cuda.bilevel_scan_launch()
    ptxas = scan_ptxas(ptxas_log, "bilevel_scan_kernel")
    print(
        f"bilevel_scan {B} rows x {n} f32 samples, {m} slots: counts, polarities "
        f"and samples equal to the plain version bit for bit on every row (counts "
        f"{np.bincount(nc)[:6].tolist()}..., row 5 {int(nc[5])} past its {m} "
        f"slots), and the float64 instance's on the rows widened; {edges}; kernel "
        f"{ms:.4f} ms ({dev_ms:.4f} ms on the device alone), plain "
        f"{plain_ms:.1f} ms, byte bound {bound:.4f} ms, {bound / ms:.1%} of it "
        f"({bound / dev_ms:.1%} on the device alone); float64 {dev64_ms:.4f} ms on "
        f"the device alone, {bound64 / dev64_ms:.1%} of its {bound64:.4f} ms bound; "
        f"launch: {launch['rows']} rows and {launch['threads']} threads a block, "
        f"{launch['smem_bytes']} B of shared memory, {launch['blocks_per_sm']} "
        f"blocks per SM, {launch['registers']} registers and {launch['local_bytes']} "
        f"local bytes a thread; ptxas {' | '.join(ptxas)}; on {card_line()}",
        flush=True)
    return dict(max_abs_err=0.0, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by="bytes", bound_share=bound / ms,
                device_bound_share=bound / dev_ms, f64_device_ms=dev64_ms,
                f64_bound_ms=bound64, launch=launch, ptxas=ptxas)


def extras_card_phase(wf, bl, dev, n_cmp=1024):
    """The extras' processors called alone on the card against the same
    calls on the CPU (their plain versions; the sweep and K7's ops are held
    by their own phases), on the first ``n_cmp`` events of the flagship
    generator: ``poly_fit``, ``poly_diff``, ``poly_exp_rms``,
    ``soft_pileup_corr(_bl)``, ``interpolated_time_point_thresh``,
    ``multi_time_point_thresh``, ``wf_correction``, ``wf_alignment``,
    ``get_wf_centroid`` and ``inl_correction`` (the rows as integer ADC codes,
    with a shared 16-bit INL table and one a event; the extras config cannot
    give it codes). Float outputs within REL_TOL of their scale, indices,
    counts and codes exactly. Returns the worst float error over scale."""
    import torch

    import dspeed_tpu_torch.processors as tp

    rng = np.random.default_rng(16)
    w = wf[:n_cmp]
    x = (w - bl[:n_cmp, None].astype(np.float32)).astype(np.float32)
    x[NAN_SAMPLE_ROW, 500] = np.nan
    lo, hi = EXTRAS_TAIL
    codes = np.nan_to_num(np.rint(w), nan=0).astype(np.int32)
    codes[7, 100] = 70000  # out of the table: the event is poisoned
    inl = rng.uniform(-0.5, 0.5, 65536).astype(np.float32)
    inl_ev = rng.uniform(-0.5, 0.5, (64, 65536)).astype(np.float32)
    corr = np.linspace(-1, 1, EXTRAS_STEP).astype(np.float32)
    thr = (np.nanmax(x, 1, keepdims=True) * [[0.1, 0.5, 0.9]]).astype(np.float32)
    ts = np.full(n_cmp, 900.0, np.float32)
    fit = tp.poly_fit(EXTRAS_BL, 1)
    tail = tp.poly_fit(hi - lo, 1)

    def calls(t):
        """Each call on tensors made by ``t`` (CPU or card)."""
        X = t(x)
        pars = fit(X[:, :EXTRAS_BL])[0]
        # the chain's log: float32 through float64, alike on both devices
        tpars = tail(torch.log(X[:, lo:hi].double()).float())[0]
        cen = tp.get_wf_centroid(X, t(np.float32(2.0)))[0]
        return {
            "poly_fit": pars,
            "poly_diff": tp.poly_diff(X[:, :EXTRAS_BL], pars),
            "poly_exp_rms": tp.poly_exp_rms(X[:, lo:hi], tpars),
            "soft_pileup_corr": tp.soft_pileup_corr(X, EXTRAS_BL, TAU),
            "soft_pileup_corr_bl": tp.soft_pileup_corr_bl(X, EXTRAS_BL, TAU, 0.5),
            "interpolated_time_point_thresh": tp.interpolated_time_point_thresh(
                X, t(thr[:, 1].copy()), t(ts), 1, ord("l")),
            "multi_time_point_thresh": tp.multi_time_point_thresh(
                X, t(thr), t(ts), 1, ord("l")),
            "wf_correction": tp.wf_correction(X, t(corr), 100, 100 + EXTRAS_STEP),
            "get_wf_centroid": cen,
            "wf_alignment": tp.wf_alignment(X, cen, 5.0, EXTRAS_ALIGN,
                                            dims={"m": EXTRAS_ALIGN}),
            "inl_correction": tp.inl_correction(t(codes), t(inl)),
            "inl_correction per event": tp.inl_correction(t(codes[:64]), t(inl_ev)),
        }

    with torch.no_grad():
        card = calls(lambda a: torch.as_tensor(a).to(dev))
        torch.cuda.synchronize()
        cpu = calls(lambda a: torch.as_tensor(a))
    worst = 0.0
    for name in card:
        outs_g = card[name] if isinstance(card[name], tuple) else (card[name],)
        outs_w = cpu[name] if isinstance(cpu[name], tuple) else (cpu[name],)
        for q, (g, wv) in enumerate(zip(outs_g, outs_w)):
            exact = name in ("get_wf_centroid", "wf_alignment", "wf_correction")
            compare(f"{name} [{q}] card vs CPU", g.cpu(), wv, exact=exact)
            ok = ~torch.isnan(wv)
            if ok.any():
                scale = float(wv[ok].double().abs().max())
                worst = max(worst, float((g.cpu()[ok].double() - wv[ok].double()).abs()
                                         .max()) / max(scale, 1e-30))
    if not torch.isnan(card["inl_correction"][0][7]).all():
        raise AssertionError("inl_correction: an event with a code past the table "
                             "was not poisoned")
    print(f"the extras' processors on the card vs the CPU ({n_cmp} events, "
          f"{len(card)} calls, inl_correction on the rows' integer codes): worst "
          f"|diff|/max|col| {worst:.3e}", flush=True)
    return worst


def extras_checks(cols, cpu, wf, bl, n_cpu, good, t0):
    """The flagship extras' own columns: each finite on at least 90% of the
    events (the first slot of an (m) column; each share printed), one
    trigger of polarity 1 on nearly every good event, the centroid on the
    rise; the first ``n_cpu`` events against the port's CPU run, counts,
    polarities, trigger samples and centroids exactly, the others within
    REL_TOL of their scale. Excused, and counted: the crossing times of an
    event whose ``tp_0_est`` (their start) moved by one sample or whose
    ``wf_pz`` sits on a threshold at the crossing, and a
    centroid whose step product holds a near-tie of its extremes or a sample
    within REL_TOL of zero (``check_generic``'s rule for an extremum), and
    the maximum of the window aligned on such a centroid."""
    import torch

    import dspeed_tpu_torch.processors as tp

    shares = {}
    for k in EXTRAS_OUTPUTS:
        v = np.asarray(cols[k], np.float64).reshape(len(good), -1)[:, 0]
        shares[k] = float(np.isfinite(v).mean())
    print("flagship extras, finite share of each new column: "
          + json.dumps({k: round(v, 4) for k, v in shares.items()}), flush=True)
    low = [k for k, v in shares.items() if v < 0.9]
    if low:
        raise AssertionError(f"extras columns finite on < 90% of the events: {low}")
    one = float((cols["bl_ncross"][good] == 1).mean())
    rise = cols["centroid"][good] / DT - t0[good]
    print(f"[flagship extras] events with one bi-level trigger: {one:.4f}; "
          f"centroid - injected t0: median {np.nanmedian(rise):.1f} samples",
          flush=True)
    if one < 0.99 or np.nanmax(np.abs(rise)) > 64:
        raise AssertionError("extras: the trigger or the centroid is off the pulses")
    moved = np.isfinite(cpu["tp_0_est"]) & (cols["tp_0_est"][:n_cpu] != cpu["tp_0_est"])
    excused = 0
    centroid_moved: set = set()  # and so the window aligned on it

    def crossing_tie(k, r):
        """Whether ``wf_pz`` (the plain version's, on the CPU) sits within
        REL_TOL of its scale from a threshold of column ``k`` next to the
        card's or the CPU's crossing (``near_crossing``'s rule)."""
        x = torch.from_numpy(wf[r : r + 1] - bl[r : r + 1, None].astype(np.float32))
        pz = tp.pole_zero(x, TAU)[0][0].numpy()
        fr = [0.5] if k == "tp_50_interp" else [0.1, 0.5, 0.9]
        per = DT if k == "tp_50_interp" else 1.0
        g = np.atleast_1d(np.asarray(cols[k][r], np.float64)) / per
        w = np.atleast_1d(np.asarray(cpu[k][r], np.float64)) / per
        return any(near_crossing(pz, np.float32(f) * np.float32(cpu["trapTmax"][r]),
                                 (np.floor(gi), np.floor(wi)))
                   for f, gi, wi in zip(fr, g, w))
    for k in EXTRAS_OUTPUTS:
        g = np.asarray(cols[k][:n_cpu], np.float64).reshape(n_cpu, -1)
        w = np.asarray(cpu[k], np.float64).reshape(n_cpu, -1)
        same = ((g == w) | (np.isnan(g) & np.isnan(w))).all(1)
        exact = k in ("bl_ncross", "bl_pol", "bl_trig", "centroid")
        ok = ~np.isnan(w)
        scale = np.abs(w[ok]).max() if ok.any() else 0.0
        within = ((np.isnan(g) == np.isnan(w)).all(1)
                  & (np.nan_to_num(np.abs(g - w)) <= REL_TOL * scale).all(1))
        near = same if exact else same | within
        for r in np.flatnonzero(~near):
            if k in ("tp_50_interp", "tp_multi") and (moved[r] or crossing_tie(k, r)):
                excused += 1
                continue
            if k == "aligned_max" and r in centroid_moved:
                excused += 1
                continue
            if k == "centroid":
                x = torch.from_numpy(wf[r : r + 1] - bl[r : r + 1, None].astype(np.float32))
                kern = tp.step(16.0, dims={"n": EXTRAS_STEP})[0]
                st = tp.convolve_wf(x, np.asarray(kern, np.float32), ord("v"),
                                    dims={"p": x.shape[-1] - EXTRAS_STEP + 1})[0][0].numpy()
                tol = REL_TOL * np.abs(st).max()
                # the extremes' samples, or a sample in the window between them
                # that sits on 0 no later than its first positive sample or
                # no earlier than its last negative one
                lo, hi = int(np.argmin(st)), int(np.argmax(st))
                win = np.arange(lo, hi)
                pos, neg = win[st[lo:hi] > 0], win[st[lo:hi] < 0]
                zero = win[np.abs(st[lo:hi]) <= tol]
                ties = (np.sort(st)[1] - st.min() <= tol or st.max() - np.sort(st)[-2] <= tol
                        or (pos.size and (zero <= pos[0]).any())
                        or (neg.size and (zero >= neg[-1]).any()))
                if ties:
                    centroid_moved.add(int(r))
                    excused += 1
                    continue
            raise AssertionError(f"{k}: event {r} differs from the CPU run "
                                 f"({g[r][:3]} against {w[r][:3]})")
    print(f"[flagship extras] first {n_cpu} events vs the port's CPU run: new "
          f"columns equal within the rules, {excused} events excused", flush=True)
    return shares



def inject_ml_checks(cols, cpu, amp, good, n_cpu, label):
    """The injection + ML path's own columns: each finite on at least 99%
    of the events (every slot of ``nnls_coef``; each share printed); on the
    first ``n_cpu`` events against the port's CPU run, NaN positions equal
    and each within REL_TOL of its scale; the spread of ``dplmsEmax`` and
    ``trapEmax`` over the injected amplitudes, printed side by side."""
    shares = {}
    for k in INJECT_ML_OUTPUTS:
        v = np.asarray(cols[k], np.float64).reshape(len(good), -1)
        shares[k] = float(np.isfinite(v).all(1).mean())
    print(f"[{label}] finite share of each new column: "
          + json.dumps({k: round(v, 4) for k, v in shares.items()}), flush=True)
    low = [k for k, v in shares.items() if v < 0.99]
    if low:
        raise AssertionError(f"{label}: columns finite on < 99% of the events: {low}")
    worst = 0.0
    for k in INJECT_ML_OUTPUTS:
        g = np.asarray(cols[k][:n_cpu], np.float64)
        w = np.asarray(cpu[k], np.float64)
        if not np.array_equal(np.isnan(g), np.isnan(w)):
            raise AssertionError(f"{label} {k}: NaN events differ from the CPU run")
        ok = ~np.isnan(w)
        scale = np.abs(w[ok]).max()
        err = np.abs(g[ok] - w[ok]).max()
        worst = max(worst, err / scale)
        if err > REL_TOL * scale:
            raise AssertionError(f"{label} {k}: max |card - CPU| {err:.3e} > "
                                 f"{REL_TOL * scale:.3e} on the first {n_cpu} events")
    spread = {}
    for k in ("dplmsEmax", "trapEmax"):
        r = np.asarray(cols[k], np.float64)[good] / amp[good]
        spread[k] = (float(np.std(r)), float(np.percentile(r, 1)),
                     float(np.percentile(r, 99)))
    print(f"[{label}] new columns, first {n_cpu} events vs the port's CPU run: worst "
          f"|diff|/max|col| {worst:.3e}; over the generator's amplitude, dplmsEmax: std "
          f"{spread['dplmsEmax'][0]!r}, 1st-99th percentile {spread['dplmsEmax'][1]!r} "
          f"to {spread['dplmsEmax'][2]!r}; trapEmax: std {spread['trapEmax'][0]!r}, "
          f"{spread['trapEmax'][1]!r} to {spread['trapEmax'][2]!r}; nn_score median "
          f"{float(np.nanmedian(cols['nn_score'])):.4f}", flush=True)
    return shares, spread


def column_checks(cols, cpu, n_cpu, label, outputs, exact, skip, why):
    """A path's own columns ``outputs``: each finite on at least 90% of the
    events (each share printed); on the first ``n_cpu`` events against the
    port's CPU run, NaN positions equal and each within REL_TOL of its
    scale, those of ``exact`` exactly. ``skip`` (column -> bool mask of the
    first ``n_cpu`` events) excuses events, counted and printed with
    ``why``. Returns the finite shares."""
    shares = {k: float(np.isfinite(np.asarray(cols[k], np.float64)).mean())
              for k in outputs}
    print(f"[{label}] finite share of each new column: "
          + json.dumps({k: round(v, 4) for k, v in shares.items()}), flush=True)
    low = [k for k, v in shares.items() if v < 0.9]
    if low:
        raise AssertionError(f"{label}: columns finite on < 90% of the events: {low}")
    excused, worst = {}, 0.0
    for k in outputs:
        g = np.asarray(cols[k][:n_cpu], np.float64)
        w = np.asarray(cpu[k], np.float64)
        same = (g == w) | (np.isnan(g) & np.isnan(w))
        keep = ~skip.get(k, np.zeros(n_cpu, bool))
        excused[k] = int((~same & ~keep).sum())
        if not np.array_equal(np.isnan(g[keep]), np.isnan(w[keep])):
            raise AssertionError(f"{label} {k}: NaN events differ from the CPU run")
        ok = keep & ~np.isnan(w)
        if not ok.any():
            continue
        err = np.abs(g[ok] - w[ok]).max()
        scale = max(np.abs(w[ok]).max(), 1e-30)
        if (k in exact and err > 0) or err > REL_TOL * scale:
            raise AssertionError(f"{label} {k}: max |card - CPU| {err:.3e} on the first "
                                 f"{n_cpu} events (scale {scale:.3e})")
        worst = max(worst, err / scale)
    print(f"[{label}] new columns, first {n_cpu} events vs the port's CPU run: worst "
          f"|diff|/max|col| {worst:.3e}; excused ({why}): "
          f"{json.dumps({k: v for k, v in excused.items() if v})}", flush=True)
    return shares


def t0_moved(cols, cpu, n_cpu):
    """The first ``n_cpu`` events where the card's ``tp_0_est`` is not the
    CPU run's finite one (a sample apart on a near-tie)."""
    return (cols["tp_0_est"][:n_cpu] != cpu["tp_0_est"]) & np.isfinite(cpu["tp_0_est"])


def cover_checks(cols, cpu, wf, bl, n_cpu, good, label):
    """The coverage path's own columns by :func:`column_checks` (counts
    exactly). Excused, and counted: ``pz_at_t0`` and ``trapEpick`` (they
    read ``tp_0_est``) where ``tp_0_est`` moved by a sample; ``t_over``
    where the CPU's trapezoid holds a sample within REL_TOL of its scale
    from the threshold; a rounded ``trapTmax`` where the card's and the
    CPU's ``trapTmax`` differ (it must then be the card's own ``trapTmax``
    rounded). ``trapT_sel`` must be ``trapTmax`` where ``t_over`` >
    COVER_TOT_MIN, else 0, on every event."""
    import torch

    import dspeed_tpu_torch.processors as tp

    sel = np.where(cols["t_over"] > COVER_TOT_MIN, cols["trapTmax"], np.float32(0.0))
    if not np.array_equal(cols["trapT_sel"], sel, equal_nan=True):
        raise AssertionError(f"{label}: trapT_sel is not where(t_over > "
                             f"{COVER_TOT_MIN}, trapTmax, 0)")
    moved = t0_moved(cols, cpu, n_cpu)
    e_moved = cols["trapTmax"][:n_cpu] != cpu["trapTmax"]
    skip = {"pz_at_t0": moved, "trapEpick": moved}
    for k, fn in (("E_round", np.rint), ("E_floor", np.floor), ("E_ceil", np.ceil),
                  ("E_trunc", np.trunc)):
        skip[k] = e_moved
        r = np.float32(COVER_ROUND)
        own = (r * fn(cols["trapTmax"][:n_cpu] / r)).astype(np.float32)
        if not np.array_equal(cols[k][:n_cpu][e_moved], own[e_moved], equal_nan=True):
            raise AssertionError(f"{label} {k}: not the card's trapTmax rounded")
    g, w = cols["t_over"][:n_cpu], cpu["t_over"]
    skip["t_over"] = np.zeros(n_cpu, bool)
    for r in np.flatnonzero(~((g == w) | (np.isnan(g) & np.isnan(w)))):
        x = torch.from_numpy(wf[r:r + 1] - bl[r:r + 1, None].astype(np.float32))
        trap = tp.trap_norm(tp.pole_zero(x, TAU)[0], 625, 188)[0][0].numpy()
        thr = np.float32(cpu["trapTmax"][r]) * np.float32(0.5)
        tie = np.abs(trap - thr) <= REL_TOL * np.nanmax(np.abs(trap))
        skip["t_over"][r] = bool(tie.any())
    exact = {"t_over", "sat_lo", "sat_hi", "ps_fact"} | {k for k in COVER_OUTPUTS
                                                         if k.startswith("E_")}
    return column_checks(cols, cpu, n_cpu, label, COVER_OUTPUTS, exact, skip,
                         "tp_0_est moved a sample, a trapezoid sample on the "
                         "threshold, trapTmax rounded across a multiple")


def plane_checks(cols, cpu, n_cpu, label):
    """The plane path's own columns by :func:`column_checks` (the counts
    and int64 indices exactly). Excused, and counted, the columns of
    ``PLANE_READS_T0`` where ``tp_0_est`` moved by a sample."""
    moved = t0_moved(cols, cpu, n_cpu)
    return column_checks(cols, cpu, n_cpu, label, PLANE_OUTPUTS,
                         {"ok_sum", "t0_idx", "sg_sum"},
                         {k: moved for k in PLANE_READS_T0},
                         "tp_0_est moved a sample")


def e2e_phase(build_dsp, lh5, _cuda, cfg, wf, amp, t0, bl, card, label,
              expect, rt=None, device="cuda", fuse=True, forbid=(),
              aoe_geometry=AOE_GEOMETRY, trap_tol=0.005, extras=False,
              inject_ml=False, cover=False, plane=False, db=None, n_cpu=256,
              f64=False, smem_splits=False):
    """A main path: ``build_dsp`` of ``cfg`` with fusion mode ``fuse`` over
    every event of ``wf`` on ``device``, file -> file where ``h5py`` is
    installed, else Table -> Table; launch counts and generic-group splits
    read around the first run: each kernel of ``expect`` must have been
    launched, none of ``forbid``, and no group split; physics and CPU
    cross-checks (the CPU run in the same mode) on the output. Event
    ``NAN_SAMPLE_ROW`` gets a NaN sample and event ``NAN_BASELINE_ROW`` a
    NaN baseline, so the NaN rules are checked end to end;
    ``aoe_geometry`` is the current front's (its window length picks the A/E
    reference of ``AOE_RATIO``); ``trapEmax`` must lie within ``trap_tol``
    of the injected amplitudes. With ``extras`` the flagship extras' own
    columns are held by :func:`extras_checks`, with ``inject_ml`` the
    injection + ML path's by :func:`inject_ml_checks`, with ``cover`` the
    coverage path's by :func:`cover_checks`, with ``plane`` the plane path's
    by :func:`plane_checks` (the flagship's by the rules above). ``db`` is the database (default: the flagship's
    ``pz.tau``); the first ``n_cpu`` events are held against the CPU run
    (with ``f64``, a float64 chain: every column at the golden replay's
    tolerance, F64_REL and F64_ATOL of its scale). With ``smem_splits`` a
    group may split, where its plan is over one block's shared memory, and
    for no other reason. Records the calls' wf/s in ``E2E_RATES[label]``.
    Returns the launch counts."""
    import importlib.util

    import torch

    from dspeed_tpu_torch.processors import _tile_program

    outputs = list(cfg["outputs"])
    wf = wf.copy()
    bl = bl.copy()
    wf[NAN_SAMPLE_ROW, 500] = np.nan
    bl[NAN_BASELINE_ROW] = np.nan
    n_ev = wf.shape[0]
    n_cpu = min(n_cpu, n_ev)
    database = db or {"pz": {"tau": TAU}}
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
                build_dsp(raw, out, cfg, database={"ch001": database},
                          n_entries=n, buffer_len=n, device=dev, write_mode="r",
                          fuse=fuse, stats=stats)
                with h5py.File(out, "r") as f:
                    return {k: f[f"ch001/dsp/{k}"][()] for k in outputs}
        else:
            def run(dev, n, stats=None):
                out = build_dsp(tb, dsp_config=cfg, database=database,
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
        E2E_RATES[label] = (n_ev / cold_s, n_ev / warm_s)
        if builds.n:
            raise AssertionError(f"[{label}] the second build_dsp call built "
                                 f"{builds.n} chain(s): no chain-cache hit")
        cpu = run("cpu", n_cpu)
    searches = ("tp_0_est", *READS_TP0)
    not_found = {}
    new_cols = (EXTRAS_OUTPUTS if extras else []) + (
        INJECT_ML_OUTPUTS if inject_ml else []) + (COVER_OUTPUTS if cover else []) + (
        PLANE_OUTPUTS if plane else [])
    for k, v in cols.items():
        if k in new_cols:
            continue
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
    if rel.max() > trap_tol:
        raise AssertionError(f"trapEmax misses the injected amplitudes by > "
                             f"{trap_tol:.4%}")
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
    if f64:
        worst = f64_columns(cols, cpu, n_cpu, label)
        print(f"[{label}] first {n_cpu} events vs the port's CPU run, every column "
              f"within {F64_REL:g} of its scale: worst |diff|/max|col| {worst:.3e}",
              flush=True)
    else:
        n_ex, worst = compare_columns(
            {k: v for k, v in cols.items() if k not in new_cols}, cpu, wf, bl, n_cpu,
            aoe_geometry)
        print(f"[{label}] first {n_cpu} events vs the port's CPU run: worst "
              f"|diff|/max|col| {worst:.3e}, {n_ex} events excused", flush=True)
    if extras:
        extras_checks(cols, cpu, wf, bl, n_cpu, good, t0)
    if inject_ml:
        inject_ml_checks(cols, cpu, amp, good, n_cpu, label)
    if cover:
        cover_checks(cols, cpu, wf, bl, n_cpu, good, label)
    if plane:
        plane_checks(cols, cpu, n_cpu, label)
    for name in expect:
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"{name} was not launched on the {label} path")
    for name in forbid:
        if launches.get(name, 0) != 0:
            raise AssertionError(f"{name} was launched on the {label} path")
    if any("float32 planes only" in k or not (smem_splits and "shared memory" in k)
           for k in group_splits):
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


FLAGSHIP_KERNELS = ("fused_energy", "cascade_tp", "fused_t0", "banded_conv_multi",
                    "fused_current_poly")


def same_columns(got: dict, want: dict) -> bool:
    """Every column equal bit for bit (dtype, shape and bytes)."""
    return set(got) == set(want) and all(
        got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        and got[k].tobytes() == want[k].tobytes() for k in want)


def hpge_table(lh5, wf, bl, **cols):
    tb = lh5.Table({
        "waveform": lh5.WaveformTable(values=wf, t0=0.0, t0_units="ns", dt=DT,
                                      dt_units="ns"),
        "baseline": lh5.Array(bl.astype(np.float32)),
    })
    for k, v in cols.items():
        tb.add_field(k, v)
    return tb


# the browser phase: the JAX package's vis test's DSP view of the flagship
VIS_LINES = ["wf_blsub", "tp_50", "trapEmax"]
VIS_LEGEND = ["trapEmax", "tp_0_est"]
VIS_FETCH = 64  # entries fetched, spread over the table


def vis_phase(build_dsp, lh5, _cuda, wf, bl, card):
    """The waveform browser (``dspeed_tpu_torch.vis.WaveformBrowser``) on the
    card at the flagship's full width: built over an in-memory table of all
    the events (the card machine has no ``h5py``: the ``LH5Iterator`` path
    is tested on the CPU only), the flagship's chain with ``lines``
    ``VIS_LINES``, a legend, ``x_unit`` us, ``norm="trapEmax"`` and
    ``align="tp_50"``. Its chain must launch K1, K3 and K2 once each. It
    fetches ``VIS_FETCH`` entries spread over the table (``find_entry``,
    then ``find_next``); every stored line's x and y data and legend value
    is held against the same columns of ``build_dsp`` on the card and
    against a browser on the CPU over those events, y within REL_TOL of its
    scale, x within one sample (the alignment on a time point). Where
    matplotlib is installed it draws under ``Agg`` and saves a PNG; else it
    says that drawing did not run. Returns the figures."""
    import importlib.util

    import torch

    from dspeed_tpu_torch.units import Quantity
    from dspeed_tpu_torch.vis import WaveformBrowser

    wf = wf.copy()
    bl = bl.copy()
    wf[NAN_SAMPLE_ROW, 500] = np.nan
    bl[NAN_BASELINE_ROW] = np.nan
    n_ev = len(wf)
    kw = dict(dsp_config=CONFIG, database={"pz": {"tau": TAU}}, lines=VIS_LINES,
              legend=VIS_LEGEND, x_unit="us", norm="trapEmax", align="tp_50")
    _cuda.reset_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    wb = WaveformBrowser(hpge_table(lh5, wf, bl), device="cuda", **kw)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    launches = {k: v for k, v in _cuda.LAUNCHES.items() if v}
    want = {"fused_energy": 1, "fused_t0": 1, "cascade_tp": 1}
    if {k: launches.get(k, 0) for k in want} != want:
        raise AssertionError(f"vis: the browser's chain launched {launches}, not K1, K3 "
                             f"and K2 once each")
    entries = [int(e) for e in np.linspace(0, n_ev - 1, VIS_FETCH - 8)]
    t0 = time.time()
    wb.find_entry(entries)
    wb.find_entry(n_ev // 2)
    wb.find_next(7, append=True)
    fetch_s = time.time() - t0
    entries += list(range(n_ev // 2, n_ev // 2 + 8))
    if wb.n_stored != len(entries):
        raise AssertionError(f"vis: {wb.n_stored} entries stored, not {len(entries)}")
    # the same columns from build_dsp on the card, and a browser on the CPU
    # over the fetched events
    cfg = config(sorted(set(VIS_LINES) | set(VIS_LEGEND)))
    cols = build_dsp(hpge_table(lh5, wf, bl), dsp_config=cfg, database=kw["database"],
                     device="cuda")
    sub = np.asarray(entries)
    cpu = WaveformBrowser(hpge_table(lh5, wf[sub], bl[sub]), device="cpu", **kw)
    cpu.find_entry(range(len(sub)))
    us = 1e-3  # us a ns
    worst_y = worst_x = 0.0
    # line by line: the card's browser against the CPU's and the columns
    for name in VIS_LINES:
        tl, cl = wb.lines[name], cpu.lines[name]
        if len(tl) != len(cl):
            raise AssertionError(f"vis {name}: {len(tl)} lines stored on the card, "
                                 f"{len(cl)} on the CPU")
        for t, c in zip(tl, cl):
            tx, ty = np.asarray(t.get_xdata(), np.float64), np.asarray(t.get_ydata(),
                                                                       np.float64)
            cx, cy = np.asarray(c.get_xdata(), np.float64), np.asarray(c.get_ydata(),
                                                                       np.float64)
            if not (np.array_equal(np.isnan(tx), np.isnan(cx))
                    and np.array_equal(np.isnan(ty), np.isnan(cy))):
                raise AssertionError(f"vis {name}: NaN samples differ from the CPU")
            fy = np.isfinite(cy)
            if fy.any():
                err = np.abs(ty[fy] - cy[fy]).max()
                worst_y = max(worst_y, err / np.abs(cy[fy]).max())
                if err > REL_TOL * np.abs(cy[fy]).max():
                    raise AssertionError(f"vis {name}: y off the CPU's by {err:.3e}")
            fx = np.isfinite(cx)
            if fx.any():
                err = np.abs(tx[fx] - cx[fx]).max()
                worst_x = max(worst_x, err)
                if err > DT * us:
                    raise AssertionError(f"vis {name}: x off the CPU's by {err:.3e} us")
    # against build_dsp's columns on the card: the wf_blsub line of each
    # entry, and the legend values
    for i, e in enumerate(entries):
        norm = float(cols["trapEmax"].nda[e])
        ref = float(cols["tp_50"].nda[e]) * us
        line = wb.lines["wf_blsub"][i]
        y = cols["wf_blsub"].values.nda[e] / norm
        x = DT * us * np.arange(N_SAMPLES) - ref
        gy, gx = np.asarray(line.get_ydata()), np.asarray(line.get_xdata())
        if not (np.array_equal(np.isnan(gy), np.isnan(y))
                and np.array_equal(np.isnan(gx), np.isnan(x))):
            raise AssertionError(f"vis: entry {e}: NaN samples differ from build_dsp's")
        ok = np.isfinite(y)
        if ok.any() and np.abs(gy[ok] - y[ok]).max() > REL_TOL * np.abs(y[ok]).max():
            raise AssertionError(f"vis: entry {e}: y off build_dsp's wf_blsub / trapEmax")
        ok = np.isfinite(x)
        if ok.any() and np.abs(gx[ok] - x[ok]).max() > DT * us:
            raise AssertionError(f"vis: entry {e}: x off build_dsp's tp_50 alignment")
        for name in VIS_LEGEND:
            v = wb.legend_vals[name][i]
            g = float(v.m if isinstance(v, Quantity) else v)
            w = float(cols[name].nda[e])
            c = cpu.legend_vals[name][i]
            c = float(c.m if isinstance(c, Quantity) else c)
            for other in (w, c):
                if np.isnan(g) != np.isnan(other) or (
                        not np.isnan(g) and abs(g - other) > (
                            DT if name.startswith("tp_") else REL_TOL * abs(other))):
                    raise AssertionError(f"vis: entry {e}: legend {name} {g!r} against "
                                         f"{other!r}")
    drawn = "did not run: matplotlib is not installed on this machine"
    if importlib.util.find_spec("matplotlib") is not None:
        import matplotlib

        matplotlib.use("Agg")
        wb.draw_current()
        n_lines = sum(len(v) for v in wb.lines.values())
        texts = wb.ax.get_legend().get_texts()
        if len(wb.ax.get_lines()) != n_lines or len(texts) != wb.n_stored * len(VIS_LEGEND):
            raise AssertionError("vis: the figure's lines or legend miss stored data")
        with tempfile.TemporaryDirectory() as tmp:
            png = os.path.join(tmp, "vis.png")
            wb.save_figure(png)
            size = os.path.getsize(png)
        drawn = (f"{n_lines} lines and {len(texts)} legend entries under Agg, a PNG of "
                 f"{size} bytes")
    print(f"vis: WaveformBrowser over {n_ev} events (Table; the LH5Iterator path is "
          f"tested on the CPU only, this machine has no h5py: "
          f"{importlib.util.find_spec('h5py') is None}), lines {VIS_LINES}: built in "
          f"{build_s * 1e3:.1f} ms (its chain: {launches}), {len(entries)} entries "
          f"fetched in {fetch_s * 1e3:.2f} ms ({fetch_s * 1e3 / len(entries):.4f} ms an "
          f"entry); against the CPU browser: worst y {worst_y:.3e} of scale, worst x "
          f"{worst_x:.3e} us; against build_dsp on the card: within REL_TOL and one "
          f"sample; drawing {drawn}; on {card}", flush=True)
    if "did not run" in drawn:
        print("vis: drawing did not run here (no matplotlib); the chain and the data "
              "path ran on the card", flush=True)
    return dict(build_ms=build_s * 1e3, fetch_ms_per_entry=fetch_s * 1e3 / len(entries),
                entries=len(entries), launches=launches, worst_y=worst_y,
                worst_x_us=worst_x, drawn="did not run" not in drawn)


def checked_phase(build_dsp, build_processing_chain, lh5, _cuda, wf, bl, card):
    """Checked mode on the card, at the flagship's full width. (1) The fused
    flagship through ``build_dsp(checked=True)``: every column equal bit for
    bit to the unchecked call, the flagged steps ``CHECKED_FLAGSHIP_STEPS``,
    K1 to K5 once a chunk; warm wf/s of both. (2) The generic flagship
    checked: no ``generic_rows`` launch, its columns within REL_TOL of the
    unchecked generic run (the card-vs-CPU rule of ``compare_columns``),
    then unchecked again on the same cached chain: ``generic_rows`` twice.
    (3) A raise through the production loop: ``checked_raise_config``'s
    chain over four chunks of 4096 events (``_process_chunks``, read-ahead
    on): ``DSPFatal`` with the JAX package's message, the processor string
    of the CPU run and ``wf_range == (PICK_BAD, PICK_BAD)``; the same chain
    unchecked then gives NaN at ``PICK_BAD`` alone. Returns the figures."""
    import torch

    from dspeed_tpu_torch.errors import DSPFatal

    bdsp = sys.modules[build_dsp.__module__]
    n_ev = wf.shape[0]
    cfg = config()
    tb = hpge_table(lh5, wf, bl)
    db = {"pz": {"tau": TAU}}

    def run(checked, fuse=True):
        torch.cuda.synchronize()
        t_0 = time.time()
        out = build_dsp(tb, dsp_config=cfg, database=db, buffer_len=n_ev,
                        device=DEVICE, fuse=fuse, checked=checked)
        cols = {k: np.array(out[k].nda) for k in cfg["outputs"]}
        torch.cuda.synchronize()
        return cols, n_ev / (time.time() - t_0)

    # (1) the fused flagship
    bdsp._CHAIN_CACHE.clear()
    plain, _ = run(False)
    _cuda.reset_launches()
    checked, first_wfps = run(True)
    launches = dict(_cuda.LAUNCHES)
    (chain, _, _), = bdsp._CHAIN_CACHE.values()
    flagged = [str(s) for _, s in chain._check_steps]
    rates = {"checked": [], "unchecked": []}
    for _ in range(2):
        rates["unchecked"].append(run(False)[1])
        rates["checked"].append(run(True)[1])
    if not same_columns(checked, plain):
        raise AssertionError("checked flagship: columns differ from the unchecked run")
    if flagged != CHECKED_FLAGSHIP_STEPS:
        raise AssertionError(f"checked flagship flags {flagged}")
    for name in FLAGSHIP_KERNELS:
        if launches.get(name, 0) != 1:
            raise AssertionError(f"checked flagship: {name} launched "
                                 f"{launches.get(name, 0)} times on one chunk")
    print(f"checked [flagship] {n_ev} events: columns equal to the unchecked run "
          f"bit for bit; flagged steps {flagged}; launches {launches}; first "
          f"checked call {first_wfps:.0f} wf/s; warm checked "
          f"{max(rates['checked']):.0f} wf/s, warm unchecked "
          f"{max(rates['unchecked']):.0f} wf/s (best of 2 each, alternating) on "
          f"{card}", flush=True)

    # (2) the generic flagship: checked runs its groups member by member
    bdsp._CHAIN_CACHE.clear()
    gen_plain, _ = run(False, "generic")
    _cuda.reset_launches()
    gen_checked, gen_checked_wfps = run(True, "generic")
    gen_launches = dict(_cuda.LAUNCHES)
    _cuda.reset_launches()
    gen_again, _ = run(False, "generic")
    again_launches = dict(_cuda.LAUNCHES)
    if len(bdsp._CHAIN_CACHE) != 1:
        raise AssertionError("checked generic flagship: the toggle built a chain")
    if gen_launches.get("generic_rows", 0) != 0:
        raise AssertionError(f"checked generic flagship launched generic_rows: "
                             f"{gen_launches}")
    if again_launches.get("generic_rows", 0) != 2:
        raise AssertionError(f"generic flagship unchecked again: {again_launches}")
    if not same_columns(gen_again, gen_plain):
        raise AssertionError("generic flagship unchecked again differs from the "
                             "first unchecked run")
    n_ex, worst = compare_columns(gen_checked, gen_plain, wf, bl, n_ev)
    print(f"checked [flagship generic] no generic_rows launch ({gen_launches}); "
          f"columns vs the unchecked generic run: worst |diff|/max|col| "
          f"{worst:.3e}, {n_ex} events excused; unchecked again on the cached "
          f"chain: generic_rows {again_launches.get('generic_rows', 0)}; checked "
          f"{gen_checked_wfps:.0f} wf/s on {card}", flush=True)

    # (3) a raise through the production loop
    t_pick = pickoff_times(n_ev)
    tables = [hpge_table(lh5, wf[i:i + 4096], bl[i:i + 4096],
                         t_pick=lh5.Array(t_pick[i:i + 4096]))
              for i in range(0, n_ev, 4096)]
    rcfg = checked_raise_config()
    chain, _, tb_out = build_processing_chain(rcfg, tables[0], db_dict=db,
                                              device=DEVICE)
    chain.set_checked(True)
    written = {}

    def write(n, i_entry):
        written[i_entry] = np.array(tb_out["pick_i"].nda[:n])

    try:
        bdsp._process_chunks(chain, Chunks(tables), write, read_ahead=True)
    except DSPFatal as e:
        got = (e.args[0], e.processor, e.wf_range)
    else:
        raise AssertionError("checked run over the bad pick-off time did not raise")
    want = (PICK_MESSAGE, PICK_PROCESSOR, (PICK_BAD, PICK_BAD))
    if got != want:
        raise AssertionError(f"checked raise {got}, not {want}")
    chain.set_checked(False)
    written.clear()
    bdsp._process_chunks(chain, Chunks(tables), write, read_ahead=True)
    pick = np.concatenate([written[i] for i in sorted(written)])
    nan_at = np.flatnonzero(np.isnan(pick)).tolist()
    if nan_at != [PICK_BAD]:
        raise AssertionError(f"unchecked pick_i is NaN at {nan_at[:8]}, not "
                             f"[{PICK_BAD}]")
    print(f"checked [raise] {len(tables)} chunks of 4096 through the production "
          f"loop: DSPFatal {got[0]!r} by {got[1]} at wf_range {got[2]}; the same "
          f"chain unchecked: NaN at event {PICK_BAD} alone", flush=True)
    return dict(checked_wfps=max(rates["checked"]),
                unchecked_wfps=max(rates["unchecked"]),
                first_checked_wfps=first_wfps, flagged=flagged,
                generic_checked_wfps=gen_checked_wfps)


def stacked_phase(build_dsp, lh5, _cuda, wf, bl, card, n_chan=4):
    """``build_dsp_stacked``'s chunk step (``parallel.bulk``) on ``n_chan``
    in-memory channel tables of ``len(wf) / n_chan`` events of the
    flagship (one dispatch of ``len(wf)`` rows): each channel's columns
    equal bit for bit to its own ``build_dsp`` call; K1 to K5 launched
    once a stacked chunk; first and warm wf/s against the sequential
    calls. Returns the figures."""
    import copy

    import torch

    from dspeed_tpu_torch.parallel import bulk

    n_ev = wf.shape[0]
    per = n_ev // n_chan
    db = {"pz": {"tau": TAU}}
    cfg = config()
    tables = [hpge_table(lh5, wf[c * per:(c + 1) * per], bl[c * per:(c + 1) * per])
              for c in range(n_chan)]
    bdsp = sys.modules[build_dsp.__module__]
    bdsp._CHAIN_CACHE.clear()

    def stacked():
        torch.cuda.synchronize()
        t_0 = time.time()
        chain, _, tb_out = bulk.stacked_chain(cfg, tables[0], database=db,
                                              device=DEVICE)
        pending, n = bulk.stacked_dispatch(chain, tables, per)
        tb_outs = [copy.deepcopy(tb_out) for _ in tables]
        bulk.write_channels(chain, bulk.stacked_results(chain, pending), tb_outs, n)
        cols = [{k: np.array(t[k].nda[:n]) for k in cfg["outputs"]} for t in tb_outs]
        return cols, n_ev / (time.time() - t_0)

    def sequential():
        torch.cuda.synchronize()
        t_0 = time.time()
        cols = []
        for tb in tables:
            out = build_dsp(tb, dsp_config=cfg, database=db, buffer_len=per,
                            device=DEVICE)
            cols.append({k: np.array(out[k].nda) for k in cfg["outputs"]})
        return cols, n_ev / (time.time() - t_0)

    _cuda.reset_launches()
    got, first_wfps = stacked()
    launches = dict(_cuda.LAUNCHES)
    want, seq_first = sequential()
    warm = {"stacked": [], "sequential": []}
    for _ in range(2):
        warm["stacked"].append(stacked()[1])
        warm["sequential"].append(sequential()[1])
    for c in range(n_chan):
        if not same_columns(got[c], want[c]):
            bad = [k for k in cfg["outputs"] if got[c][k].tobytes() != want[c][k].tobytes()]
            raise AssertionError(f"stacked: channel {c} differs from its build_dsp "
                                 f"call in {bad}")
    for name in FLAGSHIP_KERNELS:
        if launches.get(name, 0) != 1:
            raise AssertionError(f"stacked: {name} launched {launches.get(name, 0)} "
                                 f"times on one stacked chunk")
    print(f"stacked [flagship] {n_chan} channel tables x {per} events ({n_ev} rows "
          f"a dispatch): every column equal to {n_chan} build_dsp calls bit for "
          f"bit; launches {launches}; first {first_wfps:.0f} wf/s (the chain "
          f"build included), warm {max(warm['stacked']):.0f} wf/s; the sequential "
          f"calls first {seq_first:.0f} wf/s, warm {max(warm['sequential']):.0f} "
          f"wf/s (best of 2 each, alternating) on {card}", flush=True)
    return dict(first_wfps=first_wfps, warm_wfps=max(warm["stacked"]),
                sequential_first_wfps=seq_first,
                sequential_warm_wfps=max(warm["sequential"]), launches=launches)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def mesh_checks(lh5, wf, bl, mesh_data, mesh_sp, device):
    """On the ranks of a mesh (NCCL on the card, gloo on the CPU): the
    flagship sharded over ``mesh_data`` (``{"data": W}``) and
    ``sp_convolve_same`` over ``mesh_sp`` (``{"sp": W}``) with the
    flagship's t0 kernel in mode 's'. Returns ``(columns, conv)``."""
    from dspeed_tpu_torch.parallel import shard_chain, sp_convolve_same
    from dspeed_tpu_torch.processing_chain import build_processing_chain

    tb = hpge_table(lh5, wf, bl)
    chain, _, _ = build_processing_chain(config(), tb, db_dict={"pz": {"tau": TAU}},
                                         device=device)
    shard_chain(chain, mesh_data)
    out = chain(tb)
    cols = {k: np.array(v.nda[: len(wf)]) for k, v in out.items()}
    taps = chain._vars_dict["t0_kernel"].const_value
    conv = sp_convolve_same(wf, np.asarray(taps, np.float32), mesh_sp)
    return cols, conv.cpu().numpy(), np.asarray(taps, np.float32)


def mesh_phase(build_processing_chain, lh5, _cuda, wf, bl, card, n_ev=4096):
    """The ``parallel`` package on the card: ``initialize_distributed`` with
    NCCL at world size 1; the flagship sharded over ``make_mesh({"data":
    1})`` equal bit for bit to the unsharded chain; ``sp_convolve_same``
    over ``{"sp": 1}`` against the port's 'same' convolution of the same
    rows (``convolve_wf``'s route: K4 on float32 rows), within REL_TOL of its
    scale (bit equality printed); with two cards or more, two NCCL ranks
    (``--mesh-rank``) run the data split and the halo exchange and are held
    to these one-card results, else one line says so. Returns the
    figures."""
    import tempfile as _tempfile

    import torch
    import torch.distributed as dist

    from dspeed_tpu_torch.parallel import make_mesh
    from dspeed_tpu_torch.parallel.mesh import initialize_distributed
    from dspeed_tpu_torch.processors.convolutions import _convolve_mode

    wf, bl = wf[:n_ev], bl[:n_ev]
    initialize_distributed(device=DEVICE, init_method=f"tcp://localhost:{free_port()}",
                           rank=0, world_size=1)
    try:
        mesh_data = make_mesh({"data": 1}, device=DEVICE)
        mesh_sp = make_mesh({"sp": 1}, device=DEVICE)
        tb = hpge_table(lh5, wf, bl)
        chain, _, _ = build_processing_chain(config(), tb, db_dict={"pz": {"tau": TAU}},
                                             device=DEVICE)
        plain = {k: np.array(v.nda[:n_ev]) for k, v in chain(tb).items()}
        _cuda.reset_launches()
        cols, conv, taps = mesh_checks(lh5, wf, bl, mesh_data, mesh_sp, DEVICE)
        launches = dict(_cuda.LAUNCHES)
        if not same_columns(cols, plain):
            raise AssertionError("mesh: the flagship over {'data': 1} differs from "
                                 "the unsharded chain")
        w = torch.from_numpy(wf).to(DEVICE)
        m = len(taps)
        ref, _ = _convolve_mode(w, taps, "s", w.shape[-1], m)
        ref = ref.cpu().numpy()
        err = float(np.nanmax(np.abs(conv - ref)))
        scale = float(np.nanmax(np.abs(ref)))
        if not err <= REL_TOL * scale:
            raise AssertionError(f"sp_convolve_same over {{'sp': 1}}: {err:.3e} from "
                                 f"the 'same' convolution (scale {scale:.3e})")
        print(f"mesh [NCCL, world 1] the flagship over {{'data': 1}} ({n_ev} "
              f"events) equal to the unsharded chain bit for bit; sp_convolve_same "
              f"over {{'sp': 1}} ({m} taps): max |diff| {err:.3e} of scale "
              f"{scale:.3e} against convolve_wf's route, bit for bit: "
              f"{conv.tobytes() == ref.tobytes()}; launches {launches}", flush=True)
    finally:
        dist.destroy_process_group()
    two = None
    if torch.cuda.device_count() >= 2:
        with _tempfile.TemporaryDirectory() as tmp:
            np.savez(os.path.join(tmp, "one.npz"), wf=wf, bl=bl, conv=conv,
                     **{f"col_{k}": v for k, v in plain.items()})
            two = spawn_mesh_ranks(tmp, 2, DEVICE)
        print(f"mesh [NCCL, 2 cards] data split and halo exchange equal to the "
              f"one-card results: {two}", flush=True)
    else:
        print(f"mesh: the two-card check did not run: "
              f"{torch.cuda.device_count()} card on this machine", flush=True)
    return dict(launches=launches, sp_max_abs_err=err, two_cards=two)


def spawn_mesh_ranks(tmp, world, device) -> dict:
    """Run ``world`` ranks of ``--mesh-rank`` on ``tmp/one.npz``'s inputs;
    each checks itself against the one-rank results there. Returns their
    verdicts."""
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--mesh-rank", str(r),
         str(world), str(port), tmp, device],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            p.kill()
    if any(p.returncode for p in procs):
        raise AssertionError("mesh ranks failed:\n" + "\n".join(
            o[1][-2000:] for o in outs))
    return {r: json.loads(o[0].strip().splitlines()[-1]) for r, o in enumerate(outs)}


def mesh_rank_main(rank, world, port, tmp, device) -> int:
    """One rank of :func:`spawn_mesh_ranks`: the flagship over ``{"data":
    world}`` and ``sp_convolve_same`` over ``{"sp": world}`` on the
    inputs of ``tmp/one.npz``, each equal bit for bit to its one-rank
    result. Prints one JSON line."""
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    from dspeed_tpu_torch import lh5
    from dspeed_tpu_torch.parallel import make_mesh
    from dspeed_tpu_torch.parallel.mesh import initialize_distributed

    if device == "cuda":
        os.environ["LOCAL_RANK"] = str(rank)
    one = np.load(os.path.join(tmp, "one.npz"))
    initialize_distributed(device=device, init_method=f"tcp://localhost:{port}",
                           rank=rank, world_size=world)
    try:
        cols, conv, _ = mesh_checks(lh5, one["wf"], one["bl"],
                                    make_mesh({"data": world}, device=device),
                                    make_mesh({"sp": world}, device=device), device)
    finally:
        dist.destroy_process_group()
    want = {k[4:]: one[k] for k in one.files if k.startswith("col_")}
    verdict = {"columns_equal": same_columns(cols, want),
               "sp_max_abs_err": float(np.nanmax(np.abs(conv - one["conv"])))}
    print(json.dumps(verdict))
    ok = verdict["columns_equal"] and verdict["sp_max_abs_err"] <= REL_TOL * float(
        np.nanmax(np.abs(one["conv"])))
    return 0 if ok else 1


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
    t_all = time.time()
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

    # -- the flagship DPZ: the recurrence kernel's clients, then K7 on its --
    # -- two groups (the energy front with double_pole_zero, and the second) --
    t0 = time.time()
    dwf, damp, dt0, dbl, drt = make_hpge_dpz_waveforms(N_EVENTS)
    print(f"DPZ inputs: {N_EVENTS}x{N_SAMPLES} f32 made in {time.time() - t0:.2f} s",
          flush=True)
    w = (torch.from_numpy(dwf).to(dev)
         - torch.from_numpy(dbl.astype(np.float32)).to(dev)[:, None])
    w[7, 123] = float("nan")
    rec = recurrence_phase(_cuda, w, logs["recurrence"])
    del w
    torch.cuda.empty_cache()
    k7["dpz_groups"] = k7_phase(build_processing_chain, lh5, _cuda, dwf, dbl, dev,
                                logs["generic_rows"], cfg=dpz_config(), fuse=True,
                                members=(10, 17), path="flagship DPZ")
    torch.cuda.empty_cache()

    # -- the SiPM chain's K7 group, then the peak finder's sweep on its curr --
    t0 = time.time()
    swf, n_pulses = make_sipm_waveforms(N_EVENTS)
    print(f"SiPM inputs: {N_EVENTS}x{SIPM_SAMPLES} f32 made in "
          f"{time.time() - t0:.2f} s", flush=True)
    k7["sipm_group"], curr = sipm_k7_phase(
        build_processing_chain, lh5, _cuda, sipm_edge_rows(swf), dev)
    scan = sipm_scan_phase(_cuda, curr, logs["peakdet_scan"])
    del curr
    torch.cuda.empty_cache()

    # -- the flagship extras: their processors alone, the bi-level sweep ---
    # -- sweep on the extras' rc_cr2 rows, K7 on the extras' three groups -----
    extras_card_phase(wf, bl, dev)
    bls = bilevel_phase(_cuda, wf, bl, dev, logs["bilevel_scan"])
    torch.cuda.empty_cache()
    k7["extras_groups"] = k7_phase(build_processing_chain, lh5, _cuda, wf, bl, dev,
                                   logs["generic_rows"], cfg=extras_config(),
                                   fuse=True, members=(9, 2, 22),
                                   path="flagship extras")
    torch.cuda.empty_cache()

    # -- the flagship injection + ML path: K7 on its two groups (the inject --
    # -- and dense ops among them), then each new op alone -------------------
    t0 = time.time()
    ml_db = inject_ml_db()
    print(f"injection + ML database (DPLMS noise matrix and reference, NNLS "
          f"templates, seeded weights) made in {time.time() - t0:.2f} s", flush=True)
    k7["inject_ml_groups"] = k7_phase(build_processing_chain, lh5, _cuda, wf, bl, dev,
                                      logs["generic_rows"], cfg=inject_ml_config(),
                                      fuse=True, members=(28, 22),
                                      path="flagship injection + ML", db=ml_db)
    k7.update(new_ops_phase(build_processing_chain, lh5, _cuda, wf, bl, dev, ml_db))
    torch.cuda.empty_cache()

    # -- the coverage path: K7 on its four generic groups, each of slice ----
    # -- 19's ops alone on the values its group gave it (bit for bit against --
    # -- the plain walk, timed against its bound) --------------------------
    k7["cover_groups"] = k7_phase(build_processing_chain, lh5, _cuda, wf, bl, dev,
                                  logs["generic_rows"], cfg=coverage_config(),
                                  members=(34, 19, 24, 26), path="coverage",
                                  pick=cover_op_label)
    held_alone(k7["cover_groups"], COVER_OPS, "coverage")
    torch.cuda.empty_cache()

    # -- the plane path: K7 on its three generic groups, each of its plane --
    # -- ops alone on the values its group gave it (bit for bit against the --
    # -- plain walk, within REL_TOL of its member, timed against its bound) ---
    k7["plane_groups"] = k7_phase(build_processing_chain, lh5, _cuda, wf, bl, dev,
                                  logs["generic_rows"], cfg=plane_config(),
                                  members=PLANE_MEMBERS, path="plane",
                                  pick=plane_op_label)
    held_alone(k7["plane_groups"], PLANE_OPS, "plane")
    torch.cuda.empty_cache()

    # -- the float64 paths: K7's float64 kernel on the groups of the float64 --
    # -- flagship, DPZ, extras, injection + ML, coverage and plane paths -------
    # -- (float64 rows), every stored output bit for bit against the plain ----
    # -- walk, each float64 op alone (bit for bit, within F64_REL of its ------
    # -- member's own body, timed against its bound) --------------------------
    wf64 = wf.astype(np.float64)
    held: dict = {"ops_alone": {}}
    k7f64 = {}
    f64_rows = {"float64 DPZ": lambda: (dwf.astype(np.float64), dbl),
                "float64 SiPM": lambda: (sipm_edge_rows(swf).astype(np.float64),
                                         np.zeros(len(swf)))}
    for path, make, members, may_split in F64_PATHS:
        rows, base = f64_rows.get(path, lambda: (wf64, bl))()
        k7f64[path] = figs = k7_phase(
            build_processing_chain, lh5, _cuda, rows, base, dev, logs["generic_rows"],
            cfg=make("float64"), members=members, path=path, pick=f64_op_label,
            db=ml_db if "injection" in path else None, may_split=may_split)
        held["ops_alone"].update(figs["ops_alone"])
        del rows
        torch.cuda.empty_cache()
    held_alone(held, F64_HELD, "float64")

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
    # the flagship DPZ: K7 carries the energy front (double_pole_zero in
    # its first group), K1 never; the recurrence kernel does not run, since
    # double_pole_zero stands inside the group
    dpz_launches = e2e_phase(
        build_dsp, lh5, _cuda, dpz_config(), dwf, damp, dt0, dbl, card,
        "flagship DPZ",
        expect=("generic_rows", "fused_t0", "cascade_tp", "fused_current_poly",
                "banded_conv_multi"),
        rt=drt, device=DEVICE, forbid=("fused_energy", "fused_current", "recurrence"),
        trap_tol=DPZ_TRAP_TOL,
    )
    per_chunk = {"generic_rows": 2, "fused_t0": 1, "cascade_tp": 1,
                 "fused_current_poly": 1, "banded_conv_multi": 1}
    if {k: dpz_launches[k] for k in per_chunk} != per_chunk:
        raise AssertionError(f"flagship DPZ launches {dpz_launches}, not {per_chunk}")
    del dwf
    # the flagship extras: the flagship's hand fronts, K7 on its three
    # groups, rc_cr2's three stages on the recurrence kernel and the
    # bi-level sweep
    extras_launches = e2e_phase(
        build_dsp, lh5, _cuda, extras_config(), wf, amp, inj_t0, bl, card,
        "flagship extras",
        expect=("fused_energy", "cascade_tp", "fused_t0", "banded_conv_multi",
                "fused_current_poly", "generic_rows", "recurrence", "bilevel_scan"),
        rt=rt, device=DEVICE, forbid=("fused_current",), extras=True,
    )
    per_chunk = {"generic_rows": 3, "recurrence": 3, "bilevel_scan": 1}
    if {k: extras_launches[k] for k in per_chunk} != per_chunk:
        raise AssertionError(f"flagship extras launches {extras_launches}, not "
                             f"{per_chunk} of those")
    # the flagship injection + ML path: the flagship's hand fronts, K7 on its
    # two groups (the injectors, the DPLMS convolution, the layers), the
    # NNLS fit in plain tensor ops; the first 1024 events against the CPU
    iml_launches = e2e_phase(
        build_dsp, lh5, _cuda, inject_ml_config(), wf, amp, inj_t0, bl, card,
        "flagship injection + ML",
        expect=("fused_energy", "cascade_tp", "fused_t0", "banded_conv_multi",
                "fused_current_poly", "generic_rows"),
        rt=rt, device=DEVICE, forbid=("fused_current", "recurrence"), inject_ml=True,
        db=ml_db, n_cpu=1024,
    )
    if iml_launches["generic_rows"] != 2:
        raise AssertionError(f"flagship injection + ML launches {iml_launches}: "
                             f"generic_rows not twice a chunk")
    # the coverage path in the generic mode: four K7 groups, the peak
    # finder's sweep between the third and the fourth, CUSP and ZAC on K4;
    # no group splits; the first 1024 events against the CPU
    cover_launches = e2e_phase(
        build_dsp, lh5, _cuda, coverage_config(), wf, amp, inj_t0, bl, card,
        "coverage", expect=("generic_rows", "banded_conv_multi", "peakdet_scan"),
        rt=rt, device=DEVICE, fuse="generic",
        forbid=("fused_energy", "cascade_tp", "fused_t0", "fused_current_poly",
                "fused_current"),
        cover=True, n_cpu=1024,
    )
    if cover_launches["generic_rows"] != 4:
        raise AssertionError(f"coverage launches {cover_launches}: generic_rows not "
                             f"four times a chunk")
    # the plane path in the generic mode: three K7 groups, CUSP and ZAC on
    # K4; no group splits; the first 1024 events against the CPU
    plane_launches = e2e_phase(
        build_dsp, lh5, _cuda, plane_config(), wf, amp, inj_t0, bl, card,
        "plane", expect=("generic_rows", "banded_conv_multi"),
        rt=rt, device=DEVICE, fuse="generic",
        forbid=("fused_energy", "cascade_tp", "fused_t0", "fused_current_poly",
                "fused_current"),
        plane=True, n_cpu=1024,
    )
    if plane_launches["generic_rows"] != len(PLANE_MEMBERS):
        raise AssertionError(f"plane launches {plane_launches}: generic_rows not "
                             f"{len(PLANE_MEMBERS)} times a chunk")
    # the float64 flagship: no hand kernel takes a float64 plane, so the
    # default mode forms the generic groups too; each mode two K7 launches
    # (its float64 kernel) a chunk and no split; the first 1024 events
    # against the CPU run at the golden replay's tolerance
    hand = ("fused_energy", "cascade_tp", "fused_t0", "banded_conv_multi",
            "fused_current_poly", "fused_current")
    f64_launches = {}
    for mode in (True, "generic"):
        label = "float64 flagship" + (" generic" if mode == "generic" else "")
        f64_launches[label] = e2e_phase(
            build_dsp, lh5, _cuda, flagship_config("float64"), wf64, amp, inj_t0, bl,
            card, label, expect=("generic_rows",), rt=rt, device=DEVICE, fuse=mode,
            forbid=hand, f64=True, n_cpu=1024)
        if f64_launches[label]["generic_rows"] != 2:
            raise AssertionError(f"{label} launches {f64_launches[label]}: "
                                 f"generic_rows not twice a chunk")
    print(f"float64 flagship warm: {E2E_RATES['float64 flagship'][1]:.0f} wf/s "
          f"(default mode), {E2E_RATES['float64 flagship generic'][1]:.0f} wf/s "
          f"(generic), against the float32 flagship's {E2E_RATES['flagship'][1]:.0f} "
          f"(default) and {E2E_RATES['flagship generic'][1]:.0f} (generic) in this "
          f"call, on {card}", flush=True)
    # the float64 plane path in the generic mode (16384 events of 4096
    # float64 samples, 512 MiB of rows a chunk): K7 on groups A and B and on
    # group C's three parts, which it bisects into on shared memory alone
    f64_launches["float64 plane"] = e2e_phase(
        build_dsp, lh5, _cuda, plane_config("float64"), wf64, amp, inj_t0, bl, card,
        "float64 plane", expect=("generic_rows",), rt=rt,
        device=DEVICE, fuse="generic", forbid=hand, plane=True, f64=True,
        n_cpu=1024, smem_splits=True)
    if f64_launches["float64 plane"]["generic_rows"] != F64_PLANE_LAUNCHES:
        raise AssertionError(f"float64 plane launches {f64_launches['float64 plane']}: "
                             f"generic_rows not {F64_PLANE_LAUNCHES} times a chunk")
    del wf64
    # the waveform browser: its chain (K1, K3, K2) and its data path
    vis = vis_phase(build_dsp, lh5, _cuda, wf, bl, card)
    torch.cuda.empty_cache()
    # the optimisers through build_dsp: optimize_2pz's pole on the recurrence
    # kernel
    opt = opt_phase(build_dsp, lh5, _cuda, wf, bl, card)
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
    # checked mode, stacked production and the mesh at the flagship's width
    chk = checked_phase(build_dsp, build_processing_chain, lh5, _cuda, wf, bl, card)
    stk = stacked_phase(build_dsp, lh5, _cuda, wf, bl, card)
    mesh = mesh_phase(build_processing_chain, lh5, _cuda, wf, bl, card)
    torch.cuda.empty_cache()
    # the SiPM path: VoV outputs, K7's group and the sweep
    sipm = sipm_e2e_phase(build_dsp, lh5, _cuda, swf, n_pulses, card)
    scan["sipm_wfps"] = {"first": sipm["first_wfps"], "warm": sipm["warm_wfps"]}
    scan["pipeline"] = sipm_pipeline_phase(build_dsp, build_processing_chain, lh5,
                                           _cuda, swf, card)
    # the SiPM chain on its rows widened to float64: one float64 K7 launch
    sipm64 = sipm_f64_phase(build_dsp, lh5, _cuda, swf, sipm.pop("cols"), card)
    del swf
    torch.cuda.empty_cache()
    # the port's examples, each step that needs neither h5py nor matplotlib
    examples = examples_phase(_cuda, card)
    torch.cuda.empty_cache()

    kernels = [
        dict(
            name="fused_energy", route="cuda",
            source="dspeed_tpu_torch/csrc/fused_energy.cu",
            replaces="dspeed_tpu/processors/_pallas.py:287",
            launches=launches["fused_energy"],
            stacked_launches=stk["launches"].get("fused_energy", 0), library_ms=None, **k1,
        ),
        dict(
            name="cascade_tp", route="cuda",
            source="dspeed_tpu_torch/csrc/cascade_tp.cu",
            replaces="dspeed_tpu/processors/_pallas.py:1528",
            launches=launches["cascade_tp"],
            stacked_launches=stk["launches"].get("cascade_tp", 0), library_ms=None, **k2,
        ),
        dict(
            name="fused_t0", route="cuda",
            source="dspeed_tpu_torch/csrc/fused_t0.cu",
            replaces="dspeed_tpu/processors/_pallas.py:1140",
            launches=launches["fused_t0"],
            stacked_launches=stk["launches"].get("fused_t0", 0), library_ms=None, **k3,
        ),
        dict(
            name="banded_conv_multi", route="cuda",
            source="dspeed_tpu_torch/csrc/banded_conv.cu",
            replaces="dspeed_tpu/processors/_pallas.py:999",
            launches=launches["banded_conv_multi"],
            stacked_launches=stk["launches"].get("banded_conv_multi", 0),
            sp_mesh_launches=mesh["launches"].get("banded_conv_multi", 0), **k4,
        ),
        dict(
            name="fused_current_poly", route="cuda",
            source="dspeed_tpu_torch/csrc/fused_current.cu",
            replaces="dspeed_tpu/processors/_pallas.py:804",
            launches=launches["fused_current_poly"],
            stacked_launches=stk["launches"].get("fused_current_poly", 0), library_ms=None, **k5,
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
            launches=gen_launches["generic_rows"], library_ms=None,
            sipm_example_launches=examples["SiPM production"]["launches"][
                "generic_rows"],
            inject_ml_launches=iml_launches["generic_rows"],
            cover_launches=cover_launches["generic_rows"],
            plane_launches=plane_launches["generic_rows"], **k7,
        ),
        dict(
            name="generic_rows_f64", route="cuda",
            source="dspeed_tpu_torch/csrc/generic_rows.cu",
            replaces="dspeed_tpu/processors/_pallas.py:1782 (on float64 rows)",
            launches=f64_launches["float64 flagship"]["generic_rows"],
            generic_launches=f64_launches["float64 flagship generic"]["generic_rows"],
            plane_launches=f64_launches["float64 plane"]["generic_rows"],
            sipm_launches=sipm64["launches"]["generic_rows"],
            library_ms=None, **{**k7f64["float64 flagship"],
                                "ops_alone": held["ops_alone"]},
            sipm_group=k7f64["float64 SiPM"],
            dpz_groups=k7f64["float64 DPZ"], extras_groups=k7f64["float64 extras"],
            inject_ml_groups=k7f64["float64 injection + ML"],
            cover_groups=k7f64["float64 coverage"], plane_groups=k7f64["float64 plane"],
        ),
        dict(
            name="recurrence", route="cuda",
            source="dspeed_tpu_torch/csrc/recurrence.cu",
            replaces="dspeed_tpu/processors/_numerics.py:250 (iir_first_order), "
                     "rc_cr2.py:39 (_one_pole_scan), recursive_filter.py:41 "
                     "(iir_companion), _spline.py:27 (affine_recurrence); no "
                     "pallas_call",
            launches=extras_launches["recurrence"], library_ms=None,
            optimize_2pz_launches=opt["optimize_2pz"]["recurrence_launches"],
            optimize_2pz_events=opt["optimize_2pz"]["events"], **rec,
        ),
        dict(
            name="peakdet_scan", route="cuda",
            source="dspeed_tpu_torch/csrc/peakdet_scan.cu",
            replaces="dspeed_tpu/processors/peak_finding.py:49 (lax.scan)",
            launches=sipm["launches"]["peakdet_scan"], library_ms=None, **scan,
        ),
        dict(
            name="bilevel_scan", route="cuda",
            source="dspeed_tpu_torch/csrc/bilevel_scan.cu",
            replaces="dspeed_tpu/processors/time_point_thresh.py:400 (lax.scan)",
            launches=extras_launches["bilevel_scan"], library_ms=None, **bls,
        ),
    ]
    print(f"chip_smoke: every phase passed in {time.time() - t_all:.1f} s", flush=True)
    print(json.dumps({"paths": {
        "vis": vis,
        "checked": chk,
        "stacked": {k: v for k, v in stk.items() if k != "launches"},
        "mesh": mesh,
        "float64 SiPM": sipm64,
        "examples": examples,
    }}))
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
    if len(sys.argv) > 1 and sys.argv[1] == "--mesh-rank":
        sys.exit(mesh_rank_main(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
                                sys.argv[5], sys.argv[6]))
    sys.exit(main())
