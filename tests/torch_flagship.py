"""The flagship configuration, ``configs/hpge-energy-timing.yaml``, and the
rule its columns are held to, for the port's tests. It imports neither JAX
nor the JAX package, so the ``gpu`` tests can take it on a machine that has
neither."""

import os

import numpy as np
import yaml

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "configs", "hpge-energy-timing.yaml")


def flagship_config(dtype="float32"):
    """The flagship as the YAML holds it. With ``dtype="float64"`` its float32
    declarations (the filter kernels, the convolved and windowed planes, the
    ``amax`` types) are widened to float64, so a float64 waveform stays
    float64 through the chain."""
    with open(CONFIG) as f:
        txt = f.read()
    if dtype == "float64":
        for f32, f64 in (("'f')", "'d')"), ("'f', grid", "'d', grid"),
                         ('"fi->f"', '"di->d"')):
            txt = txt.replace(f32, f64)
    cfg = yaml.safe_load(txt)
    assert len(cfg["outputs"]) == 34
    return cfg


REL = 1e-5
CASCADE = ["tp_100", "tp_99", "tp_95", "tp_90", "tp_80", "tp_50", "tp_20",
           "tp_10", "tp_01"]
# columns that read tp_0_est (directly, through the cascade, or through the
# A/E current's window)
READS_TP0 = ("trapEftp", "QDrift", "dt_eff", "tp_0_atrap", *CASCADE,
             "A_max", "tp_aoe_max", "tp_aoe_samp")


def assert_timing_columns(got: dict, want: dict) -> int:
    """The column rule of the flagship and its timing cut: float columns
    within ``REL`` of their scale, index columns (``tp_*``) exactly, NaN
    positions equal; an event whose ``tp_0_est`` moves by one sample (two
    float32 convolutions rounding differently) excuses the columns that
    read it. Returns the number of excused events."""
    assert set(got) == set(want)
    g0 = np.asarray(got["tp_0_est"], np.float64)
    w0 = np.asarray(want["tp_0_est"], np.float64)
    moved = np.isfinite(g0) & np.isfinite(w0) & (g0 != w0)
    assert (np.abs(g0 - w0)[moved] == 16.0).all(), "tp_0_est moved > 1 sample"
    if moved.any():
        print(f"tp_0_est moved one sample on events {np.flatnonzero(moved)}")
    for k in got:
        g, w = np.asarray(got[k], np.float64), np.asarray(want[k], np.float64)
        assert g.shape == w.shape, k
        if k in READS_TP0:
            g, w = g[~moved], w[~moved]
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=f"{k}: NaN")
        ok = ~np.isnan(w)
        if k.startswith("tp_"):
            np.testing.assert_array_equal(g[ok], w[ok], err_msg=k)
            continue
        err = np.abs(g[ok] - w[ok]).max()
        scale = np.abs(w[ok]).max()
        assert err <= REL * scale, f"{k}: {err:.3e} > {REL:g} * {scale:.3e}"
    return int(moved.sum())


DPZ = {"tau1": 27460.5, "tau2": 250.0, "frac": 0.04}  # samples, samples, 1


def dpz_config(dtype="float32"):
    """The flagship with its pole-zero step changed to the two-pole
    correction of HPGe production chains, ``double_pole_zero(wf_blsub,
    db.pz2.tau1, db.pz2.tau2, db.pz2.frac)``, with the defaults of ``DPZ``
    (chosen for the synthetic tail, no published source); every other step
    and all 34 outputs are the flagship's."""
    cfg = flagship_config(dtype)
    cfg["processors"]["wf_pz"] = {
        "function": "double_pole_zero",
        "module": "dspeed_tpu.processors",
        "args": ["wf_blsub", "db.pz2.tau1", "db.pz2.tau2", "db.pz2.frac", "wf_pz"],
        "unit": "ADC",
        "defaults": {f"db.pz2.{k}": repr(v) for k, v in DPZ.items()},
    }
    return cfg


def make_hpge_dpz_waveforms(n, nsamp=4096, seed=11):
    """The flagship's synthetic HPGe pulses (flat baseline, linear rise over
    ``rt`` samples at ``t0``, noise of 3 ADC) with the two-exponential tail
    ``(1 - frac) exp(-t/tau1) + frac exp(-t/tau2)`` that ``double_pole_zero``
    inverts. Returns ``(wf, amp, t0, bl, rt)``."""
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
