"""The port's processors against the JAX package's, on the same inputs.

Every case hands one batch of numpy arrays (made from a seed, with a NaN row
and a NaN baseline) to a JAX processor (x64 CPU) and to its counterpart in
``dspeed_tpu_torch`` on the CPU. Float outputs must agree within
``1e-6 * max|jax| + 1e-6 * |jax|``, index outputs exactly, and the NaN
positions must be identical.
"""

import numpy as np
import pytest
import torch

import dspeed_tpu.processors as jp
import dspeed_tpu_torch.processors as tp
from dspeed_tpu.processors import convolutions as jconv
from dspeed_tpu_torch.processors import convolutions as tconv

TAU = 500.0
N = 1024


def _batch(n_ev=16, n=N, seed=7, dtype="float32"):
    """HPGe-like steps with an exponential tail, noise, one NaN sample row
    and one NaN baseline."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)[None, :]
    t0 = rng.integers(250, 350, (n_ev, 1))
    amp = rng.uniform(100, 4000, (n_ev, 1))
    bl = rng.uniform(900, 1100, n_ev)
    wf = bl[:, None] + np.where(t >= t0, amp * np.exp(-(t - t0) / TAU), 0.0)
    wf = wf + rng.normal(0, 2, (n_ev, n))
    wf[3, 100] = np.nan
    bl[5] = np.nan
    return wf.astype(dtype), bl.astype(dtype)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _check(got, want, exact=()):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.shape == w.shape, (i, g.shape, w.shape)
        gn, wn = np.isnan(g), np.isnan(w)
        np.testing.assert_array_equal(gn, wn, err_msg=f"output {i}: NaN positions")
        g64, w64 = g[~wn].astype(np.float64), w[~wn].astype(np.float64)
        if i in exact:
            np.testing.assert_array_equal(g64, w64, err_msg=f"output {i}")
            continue
        if w64.size == 0:
            continue
        tol = 1e-6 * np.abs(w64).max() + 1e-6 * np.abs(w64)
        bad = np.abs(g64 - w64) > tol
        assert not bad.any(), (
            f"output {i}: {int(bad.sum())} entries off, worst "
            f"{np.abs(g64 - w64).max():.3e} at scale {np.abs(w64).max():.3e}"
        )


def _pz_input(dtype="float32"):
    wf, bl = _batch(dtype=dtype)
    return (wf - bl[:, None]).astype(dtype)


def _kern(m, seed=3):
    return np.random.default_rng(seed).normal(0, 1, m)


def _case_bl_subtract():
    wf, bl = _batch()
    return jp.bl_subtract(wf, bl), tp.bl_subtract(_t(wf), _t(bl)), ()


def _case_pole_zero(dtype):
    x = _pz_input(dtype)
    return jp.pole_zero(x, TAU), tp.pole_zero(_t(x), TAU), ()


def _case_trap(name, *params):
    x = _pz_input()
    j, p = getattr(jp, name), getattr(tp, name)
    return j(x, *params), p(_t(x), *params), ()


def _case_min_max():
    wf, _ = _batch()
    wf[7, 40:60] = wf[7].max()  # a tied maximum: the first one wins
    return jp.min_max(wf), tp.min_max(_t(wf)), (0, 1)


def _case_slope_fit(a0, b0):
    x = _pz_input()[:, a0:b0]
    return jp.linear_slope_fit(x), tp.linear_slope_fit(_t(x)), ()


def _case_conv(name, m, mode, dtype="float32"):
    x = _pz_input(dtype)
    k = _kern(m)
    n = x.shape[-1]
    p = {"f": n + m - 1, "v": n - m + 1, "s": max(n, m)}[mode]
    j = getattr(jp, name)(x, k, ord(mode), dims={"p": p})
    g = getattr(tp, name)(_t(x), k, ord(mode), dims={"p": p})
    return j, g, ()


def _case_conv_fft(mode, monkeypatch):
    # with the banded route's limit at zero both packages take the FFT
    monkeypatch.setattr(jconv, "_MATMUL_MAC_LIMIT", 0)
    monkeypatch.setattr(tconv, "_MATMUL_MAC_LIMIT", 0)
    return _case_conv("fft_convolve_wf", 200, mode, "float64")


def _case_pickoff(mode, static):
    wf, _ = _batch()
    if static:
        t = 301.0 if mode != "i" else 301
        return (
            jp.fixed_time_pickoff(wf, t, ord(mode)),
            tp.fixed_time_pickoff(_t(wf), t, ord(mode)),
            (),
        )
    rng = np.random.default_rng(1)
    t = rng.uniform(0, N - 1, 16).astype("float32")
    t[0], t[1], t[2], t[4] = 0.0, N - 1, np.nan, N + 3  # edges, NaN, outside
    t[6], t[8] = 17.0, 0.25  # integral (mode 'i' keeps it), near the start
    return (
        jp.fixed_time_pickoff(wf, t, ord(mode)),
        tp.fixed_time_pickoff(_t(wf), _t(t), ord(mode)),
        (),
    )


def _case_energy_kernel(name):
    args = (20.0, 16.0, 27460.5) if name == "cusp_filter" else (20.0, 8.0, 27460.5)
    j = getattr(jp, name)(*args, dims={"n": 700})
    g = getattr(tp, name)(*args, dims={"n": 700})
    return j, [torch.from_numpy(np.asarray(x)) for x in g], ()


CASES = {
    "bl_subtract": _case_bl_subtract,
    "pole_zero_f32": lambda: _case_pole_zero("float32"),
    "pole_zero_f64": lambda: _case_pole_zero("float64"),
    "trap_norm": lambda: _case_trap("trap_norm", 100, 30),
    "trap_norm_short": lambda: _case_trap("trap_norm", 8, 2),
    "trap_filter": lambda: _case_trap("trap_filter", 100, 30),
    "asym_trap_filter": lambda: _case_trap("asym_trap_filter", 8, 4, 60),
    "min_max": _case_min_max,
    "linear_slope_fit_head": lambda: _case_slope_fit(0, 250),
    "linear_slope_fit_tail": lambda: _case_slope_fit(600, N),
    "convolve_wf_direct_s": lambda: _case_conv("convolve_wf", 17, "s"),
    "convolve_wf_direct_f": lambda: _case_conv("convolve_wf", 17, "f"),
    "convolve_wf_direct_v": lambda: _case_conv("convolve_wf", 17, "v"),
    "convolve_wf_banded_s": lambda: _case_conv("convolve_wf", 133, "s"),
    "fft_convolve_wf_banded_v": lambda: _case_conv("fft_convolve_wf", 400, "v"),
    "fft_convolve_wf_banded_v_f64": lambda: _case_conv(
        "fft_convolve_wf", 400, "v", "float64"
    ),
    **{
        f"pickoff_{m}": (lambda m=m: _case_pickoff(m, static=False))
        for m in "infclh"
    },
    "pickoff_i_static": lambda: _case_pickoff("i", static=True),
    "pickoff_l_static": lambda: _case_pickoff("l", static=True),
    "cusp_filter": lambda: _case_energy_kernel("cusp_filter"),
    "zac_filter": lambda: _case_energy_kernel("zac_filter"),
}


@pytest.mark.parametrize("case", sorted(CASES) + ["fft_route_v", "fft_route_s"])
def test_port_matches_jax(case, monkeypatch):
    if case.startswith("fft_route_"):
        want, got, exact = _case_conv_fft(case[-1], monkeypatch)
    else:
        want, got, exact = CASES[case]()
    _check(got, want, exact)


def test_pickoff_spline_mode_is_not_ported_yet():
    wf, _ = _batch()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tp.fixed_time_pickoff(_t(wf), 10.5, ord("s"))
