"""The polynomial fits (``poly_fit``, ``poly_diff``, ``poly_exp_rms``) and the
soft pile-up correction (``soft_pileup_corr``, ``soft_pileup_corr_bl``) of the
port against the JAX package's, on the same seeded inputs (at most 64
events), and K7's ``poly_residual`` and ``soft_pileup`` ops alone.

The JAX side runs on the CPU in x64 under ``jax.jit``
(``test_torch_filters._jax``). Tolerances are ``test_torch_filters``'s:
float64 outputs within ``1e-9`` of their scale, float32 within ``2e-6``,
NaN and infinite positions identical. One known difference: the JAX
package sums a float32 row's fit moments in float32, which the normal
equations amplify to ~1e-5 of the coefficients' scale (its own
``tests/ref_oracle/test_parity_misc.py`` allows ``f32_rtol=1e-4`` there);
the port sums them in float64, so its float32 ``poly_fit`` is held to the
float64 fit (the JAX package's, on the widened rows) at the float32
tolerance, and no further from it than the JAX package's float32 fit.
"""

import os
import sys

import numpy as np
import pytest
import torch

import dspeed_tpu_torch.processors as tp
from dspeed_tpu_torch.errors import DSPFatal, ProcessingChainError

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_filters import REL, _check, _jax, _t  # noqa: E402
from torch_k7_ops import (  # noqa: E402
    check_against_pallas, check_float64_body, events, one_op,
)


def _jp():
    import dspeed_tpu.processors as jp

    return jp


def _rows(dtype, n=256, n_ev=16, seed=3, offset=0.0):
    """A baseline with a slope and noise (row 2 holds a NaN sample)."""
    rng = np.random.default_rng(seed)
    w = offset + rng.normal(0, 3, (n_ev, n)) + np.arange(n) * rng.uniform(
        -0.02, 0.02, (n_ev, 1))
    w[2, n // 3] = np.nan
    return w.astype(dtype)


# ---------------------------------------------------------------------------
# poly_fit


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("deg, offset", [(1, 0.0), (2, 0.0), (1, 15000.0), (3, 50.0)])
def test_poly_fit_matches_jax(deg, offset, dtype):
    jp = _jp()
    w = _rows(dtype, offset=offset)
    n = w.shape[-1]
    got = tp.poly_fit(n, deg)(_t(w))
    want = _jax(jp.poly_fit(n, deg), w)
    if dtype == "float64":
        _check(got, want, dtype)
        return
    # float32: against the float64 fit, and no further than the JAX fit
    oracle = np.asarray(_jax(jp.poly_fit(n, deg), w.astype(np.float64))[0])
    g, j = got[0].numpy().astype(np.float64), np.asarray(want[0]).astype(np.float64)
    np.testing.assert_array_equal(np.isnan(g), np.isnan(oracle))
    ok = ~np.isnan(oracle)
    scale = np.abs(oracle[ok]).max()
    err, jerr = np.abs(g[ok] - oracle[ok]).max(), np.abs(j[ok] - oracle[ok]).max()
    assert err <= REL["float32"] * scale, (err, scale)
    assert err <= jerr, (err, jerr)


# ---------------------------------------------------------------------------
# poly_diff, poly_exp_rms


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", ["poly_diff", "poly_exp_rms"])
@pytest.mark.parametrize("pars", ["per_event", "shared", "nan"])
def test_poly_residual_matches_jax(name, pars, dtype):
    """The residual's mean and rms against the same coefficients: per event
    (row 5's NaN), one set for every event, or a NaN among them. Row 7
    holds an infinite sample."""
    jp = _jp()
    rng = np.random.default_rng(7)
    n = 300
    if name == "poly_diff":
        w = _rows(dtype, n=n, offset=40.0)
        p = np.stack([rng.uniform(30, 50, 16), rng.uniform(-0.02, 0.02, 16),
                      rng.uniform(-1e-5, 1e-5, 16)], 1)
    else:
        # a decay exp(p0 + p1 i) with noise, the curve within ~15x the
        # noise: the residual is the difference of two float32 values, and
        # XLA's and PyTorch's float32 exp round differently in ~8% of the
        # samples, so where the curve is ~800x the noise one ulp of it is
        # ~1e-5 of the residual's sums, in both packages alike (each ~3e-5
        # from the float64 value)
        p = np.stack([rng.uniform(1, 2, 16), rng.uniform(-0.01, -1e-3, 16)], 1)
        w = np.exp(p[:, :1] + p[:, 1:] * np.arange(n)) + rng.normal(0, 0.5, (16, n))
        w[2, 100] = np.nan
    w = w.astype(dtype)
    w[7, 200] = np.inf
    p = p.astype(dtype)
    if pars == "per_event":
        p[5, 1] = np.nan
        args = (w, p)
    else:
        args = (w, np.array(p[0]))
        if pars == "nan":
            args[1][0] = np.nan
    want = _jax(getattr(jp, name), *args)
    got = getattr(tp, name)(*(_t(a) for a in args))
    _check(got, want, dtype)


# ---------------------------------------------------------------------------
# soft_pileup_corr, soft_pileup_corr_bl


def _pileup_rows(dtype, n=512, n_ev=16, seed=5):
    """The tail of an earlier pulse, A exp(-i / 300) + B, under noise; row
    3 holds a NaN sample and row 9 an infinite one."""
    rng = np.random.default_rng(seed)
    i = np.arange(n)
    w = (rng.uniform(20, 200, (n_ev, 1)) * np.exp(-i / 300.0)
         + rng.uniform(-5, 5, (n_ev, 1)) + rng.normal(0, 1, (n_ev, n)))
    w[3, 400] = np.nan
    w[9, 450] = np.inf
    return w.astype(dtype)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", ["soft_pileup_corr", "soft_pileup_corr_bl"])
@pytest.mark.parametrize("tau", ["static", "per_event"])
def test_soft_pileup_matches_jax(name, tau, dtype):
    jp = _jp()
    w = _pileup_rows(dtype)
    t = 300.0
    if tau == "per_event":
        t = np.linspace(250.0, 350.0, len(w)).astype(dtype)
        t[11] = np.nan
    args = [w, 200, t]
    if name == "soft_pileup_corr_bl":
        b = np.linspace(-3.0, 3.0, len(w)).astype(dtype)
        b[13] = np.nan
        args.append(b if tau == "per_event" else 1.5)
    want = _jax(getattr(jp, name), *args)
    got = getattr(tp, name)(*(_t(a) for a in args))
    _check(got, want, dtype)


@pytest.mark.parametrize("n_in, err", [(1, "not enough"), (600, "more than")])
def test_soft_pileup_n_in_limits_raise_as_jax(n_in, err):
    jp = _jp()
    w = _pileup_rows("float32")
    for kern, jkern in ((tp.soft_pileup_corr, jp.soft_pileup_corr),
                        (tp.soft_pileup_corr_bl, jp.soft_pileup_corr_bl)):
        args = [w, n_in, 300.0] + ([0.0] if kern is tp.soft_pileup_corr_bl else [])
        with pytest.raises(DSPFatal, match=err):
            kern(*(_t(a) for a in args))
        with pytest.raises(Exception, match=err) as e:
            jkern(*args)
        assert type(e.value).__name__ == "DSPFatal"


def test_soft_pileup_per_event_n_in_is_refused():
    """``n_in`` must be static in both packages."""
    w = _pileup_rows("float32")
    with pytest.raises(ProcessingChainError, match="n_in"):
        tp.soft_pileup_corr(_t(w), torch.full((len(w),), 200.0), 300.0)


def test_tile_safe_flags_match_jax():
    jp = _jp()
    for name in ("poly_fit", "poly_diff", "poly_exp_rms", "soft_pileup_corr",
                 "soft_pileup_corr_bl", "interpolated_time_point_thresh",
                 "multi_time_point_thresh", "bi_level_zero_crossing_time_points",
                 "inl_correction", "wf_correction", "wf_alignment", "get_wf_centroid",
                 "fft", "ifft", "psd", "abs2norm", "discrete_wavelet_transform"):
        assert getattr(getattr(tp, name), "tile_safe", False) == getattr(
            getattr(jp, name), "tile_safe", False), name


# ---------------------------------------------------------------------------
# K7's poly_residual and soft_pileup ops


POLY = {
    "bl_poly": {"function": "poly_fit", "module": "dspeed_tpu.processors",
                "init_args": ["100", "2"], "args": ["wf_blsub[0:100]", "bl_poly(3, 'f')"]},
    "p_mean, p_rms": {"function": "poly_diff", "module": "dspeed_tpu.processors",
                      "args": ["wf_blsub[0:100]", "bl_poly", "p_mean", "p_rms"],
                      "unit": ["ADC", "ADC"]},
    # a line fitted to the tail scaled down, so that its exponential is of
    # the tail's order
    "e_poly": {"function": "poly_fit", "module": "dspeed_tpu.processors",
               "init_args": ["106", "1"],
               "args": ["wf_blsub[150:256] * 0.01", "e_poly(2, 'f')"]},
    "e_mean, e_rms": {"function": "poly_exp_rms", "module": "dspeed_tpu.processors",
                      "args": ["wf_blsub[150:256]", "e_poly", "e_mean", "e_rms"],
                      "unit": ["ADC", "ADC"]},
}
PILEUP = {
    "wf_spc": {"function": "soft_pileup_corr", "module": "dspeed_tpu.processors",
               "args": ["wf_blsub", "90", "300.0", "wf_spc"], "unit": "ADC"},
    "wf_spcbl": {"function": "soft_pileup_corr_bl", "module": "dspeed_tpu.processors",
                 "args": ["wf_blsub", "90", "300.0", "bmean", "wf_spcbl"], "unit": "ADC"},
    "wf_spc_ev": {"function": "soft_pileup_corr", "module": "dspeed_tpu.processors",
                  "args": ["wf_blsub", "90", "tau_ev", "wf_spc_ev"], "unit": "ADC"},
    "tau_ev": "baseline * 2.0",
    "bmean": "baseline * 0.01",
}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name, outputs", [
    ("poly_diff", ["p_mean", "p_rms"]),
    ("poly_exp_rms", ["e_mean", "e_rms"]),
])
def test_poly_residual_op_matches_pallas_generic_rows(name, outputs, dtype):
    """On float64 rows the parameters are float64 too (a float32 parameter
    plane read as float64 splits its group: K7 reads a plane in its own
    type)."""
    jp = _jp()
    wf, bl = events(dtype)
    cfg = POLY if dtype == "float32" else {
        k: {**v, "args": [a.replace("'f'", "'d'") for a in v["args"]]}
        for k, v in POLY.items()}
    step, vals, _, _ = one_op(cfg, name, wf, bl, outputs)
    if dtype == "float64":
        check_float64_body(step, vals, getattr(jp, name), "poly_residual")
        return
    prog = check_against_pallas(step, vals, getattr(jp, name), "poly_residual")
    op = prog.ops[-1]
    assert op.ip[0] == int(name == "poly_exp_rms") and op.plan == 1


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name, outputs", [
    ("soft_pileup_corr", ["wf_spc"]),
    ("soft_pileup_corr_bl", ["wf_spcbl"]),  # a per-event baseline
])
def test_soft_pileup_op_matches_pallas_generic_rows(name, outputs, dtype):
    jp = _jp()
    wf, bl = events(dtype)
    step, vals, _, _ = one_op(PILEUP, name, wf, bl, outputs)
    if dtype == "float64":
        check_float64_body(step, vals, getattr(jp, name), ("soft_pileup", "soft_pileup_out"))
        return
    prog = check_against_pallas(step, vals, getattr(jp, name),
                                ("soft_pileup", "soft_pileup_out"))
    assert prog.ops[-2].ip[:2] == [90, int(name == "soft_pileup_corr_bl")]


def test_soft_pileup_op_takes_a_constant_tau():
    """The op reads exp(-i/tau) from the host: a per-event tau has no op, so
    its group splits around it (and runs it unfused)."""
    from dspeed_tpu_torch.processors import _tile_program

    wf, bl = events()
    step, vals, _, _ = one_op(PILEUP, "soft_pileup_corr", wf, bl, ["wf_spc_ev"])
    with pytest.raises(_tile_program.LoweringError, match="a constant tau"):
        _tile_program.lower([step], vals, [step.out_specs[0].key])
