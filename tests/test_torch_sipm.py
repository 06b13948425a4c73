"""The SiPM pulse-finding path of the port (``configs/sipm-pulse-finding.yaml``)
against the JAX package (x64, CPU), on the same inputs made from a seed.

- Each of its 11 processors (``gaussian_filter1d``,
  ``reflected_convolve_wf``, ``histogram``, ``histogram_around_mode``,
  ``histogram_stats``, ``histogram_peakstats``, ``get_multi_local_extrema``,
  ``peak_snr_threshold``, ``remove_duplicates``, ``multi_t_filter``,
  ``multi_a_filter``): exact, except ``reflected_convolve_wf`` within rtol
  2e-6 and atol 2e-5 (the JAX package's CPU route is
  ``conv_general_dilated``, another summation order). The histogram's bin
  borders follow ``jnp.linspace`` bit for bit, which ``torch.linspace`` does
  not.
- The peak finder's sweep (``_cuda.peakdet_scan_plain``) against the JAX
  package's ``lax.scan`` in both directions; the processor in all four
  directions, with rows of NaN fwhm and a row that fills every slot.
- K7's ``reflected_conv`` op, alone and in the SiPM group, through the
  tape's plain walk against the Pallas ``generic_rows`` in interpret mode
  (``tests/test_tile_safety.py:91-122``'s tolerance); the default mode forms
  the JAX package's group and splits nothing.
- The whole chain (default, unfused, generic) against the JAX package's
  ``build_dsp`` and the golden ``tests/goldens/sipm_chain.npz``.

The ``gpu`` tests hold K7's SiPM group and the sweep on the card bit for bit
against their plain versions:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_sipm.py
"""

import os
import sys

import numpy as np
import pytest
import torch

import dspeed_tpu_torch
import dspeed_tpu_torch.processors as tp
from dspeed_tpu_torch.processing_chain import GroupStep
from dspeed_tpu_torch.processing_chain import build_processing_chain as torch_build
from dspeed_tpu_torch.processors import _cuda, _tile_program

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIPM = os.path.join(REPO, "configs", "sipm-pulse-finding.yaml")
GOLDEN = os.path.join(REPO, "tests", "goldens", "sipm_chain.npz")
# the tile contract of tests/test_tile_safety.py, and the reflected
# convolution's gap to the JAX package's CPU route (another summation order)
TOL = dict(rtol=2e-6, atol=2e-5)


@pytest.fixture(autouse=True)
def fresh_chain_cache():
    from dspeed_tpu_torch import build_dsp

    cache = sys.modules[build_dsp.__module__]._CHAIN_CACHE
    cache.clear()
    yield
    cache.clear()


def sipm_waveforms(n=48, nsamp=1024, seed=3):
    """``bench.py:73`` ``_build_sipm_inputs``: unit noise and Poisson(2)
    pulses of amplitude U(20, 200); returns ``(wf, n_pulses)``."""
    rng = np.random.default_rng(seed)
    t = np.arange(nsamp)[None, :]
    wf = rng.normal(0.0, 1.0, (n, nsamp))
    n_pulse = rng.poisson(2.0, n)
    for i in range(n):
        for t0 in rng.uniform(50, nsamp - 50, n_pulse[i]):
            a = rng.uniform(20, 200)
            wf[i] += a * np.exp(-np.abs(t[0] - t0) / np.where(t[0] > t0, 80, 3))
    return wf.astype("float32"), n_pulse


def spe_waveforms(n=24, nsamp=512, seed=21):
    """``tests/test_build_dsp.py:171``'s SPE-pulse trains on a noisy
    baseline."""
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 0.5, (n, nsamp))
    n_pulses = rng.integers(1, 5, n)
    for ev in range(n):
        for p in rng.choice(np.arange(30, nsamp - 60), n_pulses[ev], replace=False):
            t = np.arange(nsamp) - p
            w[ev] += np.where(t >= 0, 400.0 * (t / 8.0) * np.exp(-t / 8.0), 0.0)
    return w.astype("float32"), n_pulses


def _t(x):
    return torch.from_numpy(np.array(x, order="C"))


def _exact(got, want, what=""):
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.shape == w.shape, (what, i, g.shape, w.shape)
        assert g.dtype == w.dtype, (what, i, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f"{what} output {i}")


def _current(wf, dtype=np.float64):
    """The SiPM chain's ``curr``: its ``reflected_convolve_wf`` and
    ``avg_current``, from the port (equal to the JAX package's within the
    convolution's tolerance; each processor below gets the same array)."""
    kern = tp.gaussian_filter1d(1.0, 4.0, dims={"n": 9})[0]
    w = _t(wf.astype(dtype))
    (g,) = tp.reflected_convolve_wf(w, kern, dims={"p": w.shape[-1]})
    (c,) = tp.avg_current(g, 5.0, dims={"m": w.shape[-1] - 5})
    return c.numpy()


@pytest.fixture(scope="module")
def currents():
    wf, n_pulse = sipm_waveforms()
    wf[7, 400] = np.nan
    return _current(wf)


# ---------------------------------------------------------------------------
# the processors


@pytest.mark.parametrize("sigma, trunc", [(1.0, 4.0), (2.5, 3.0), (0.7, 4.0)])
def test_gaussian_filter1d_matches_jax(sigma, trunc):
    import dspeed_tpu.processors as jp

    n = 2 * int(trunc * sigma + 0.5) + 1
    got = tp.gaussian_filter1d(sigma, trunc, dims={"n": n})
    want = jp.gaussian_filter1d(sigma, trunc, dims={"n": n})
    _exact(got, want, "gaussian_filter1d")


def _reflected_case(case):
    wf, _ = sipm_waveforms(n=16, nsamp=256)
    wf[3, 100] = np.nan
    if case == "f64_taps_9":
        return wf.astype(np.float64), tp.gaussian_filter1d(1.0, 4.0, dims={"n": 9})[0]
    if case == "f32_taps_9":
        k = tp.gaussian_filter1d(1.0, 4.0, dims={"n": 9})[0]
        return wf, k.astype(np.float32)
    if case == "f32_taps_4":
        return wf, np.asarray([0.1, 0.4, 0.3, 0.2], np.float32)
    if case == "fft_taps_41":  # beyond 32 taps: the FFT route in both packages
        return wf.astype(np.float64), tp.gaussian_filter1d(4.0, 2.5, dims={"n": 21})[0][
            np.r_[0:21, 0:20]] / 2
    raise KeyError(case)


@pytest.mark.parametrize("case", ["f64_taps_9", "f32_taps_9", "f32_taps_4",
                                  "fft_taps_41"])
def test_reflected_convolve_wf_matches_jax(case):
    import dspeed_tpu.processors as jp

    w, k = _reflected_case(case)
    (got,) = tp.reflected_convolve_wf(_t(w), k, dims={"p": w.shape[-1]})
    (want,) = jp.reflected_convolve_wf(w, k, dims={"p": w.shape[-1]})
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, equal_nan=True, **TOL)
    assert np.isnan(got[3]).all() and np.isfinite(got[4]).all()


def test_reflected_convolve_wf_pads_like_numpy():
    """The port's reflected convolution is numpy's: ``np.pad(..., 'reflect')``
    then ``np.convolve`` in float64."""
    w, k = _reflected_case("f64_taps_9")
    (got,) = tp.reflected_convolve_wf(_t(w), k, dims={"p": w.shape[-1]})
    m, n = len(k), w.shape[-1]
    ext = m // 2 + 1
    for r in (0, 5, 15):
        full = np.convolve(np.pad(w[r], ext, mode="reflect"), k, "same")
        np.testing.assert_allclose(got[r].numpy(), full[ext:-ext], rtol=1e-13)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_histogram_matches_jax(currents, dtype):
    import dspeed_tpu.processors as jp

    c = currents.astype(dtype)
    c[9] = 1.5  # a flat row: no bin width, nothing counted
    dims = {"m": 100, "p": 101}
    got = tp.histogram(_t(c), dims=dims)
    want = jp.histogram(c, dims=dims)
    _exact(got, want, "histogram")
    assert got[0][7].sum() == 0 and torch.isnan(got[1][7]).all()
    # the row maximum is not counted
    ok = np.isfinite(c).all(1) & (c.max(1) > c.min(1))
    assert (got[0].numpy()[ok].sum(1) == (c[ok] != c[ok].max(1, keepdims=True)).sum(1)).all()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_histogram_borders_follow_jax_linspace(dtype):
    import jax.numpy as jnp

    from dspeed_tpu_torch.processors.histogram import linspace01

    tdt = {np.float32: torch.float32, np.float64: torch.float64}[dtype]
    for p in [*range(2, 260), 1001, 4097]:
        got = linspace01(p, tdt, "cpu").numpy()
        want = np.asarray(jnp.linspace(0.0, 1.0, p, dtype=dtype))
        np.testing.assert_array_equal(got, want, err_msg=f"p={p}")
    # what torch.linspace would have given (20 of 101 values in float32)
    assert (torch.linspace(0, 1, 101, dtype=tdt).numpy()
            != linspace01(101, tdt, "cpu").numpy()).any()


@pytest.mark.parametrize("center", ["auto", "given", "per_row"])
def test_histogram_around_mode_matches_jax(currents, center):
    import dspeed_tpu.processors as jp

    c = currents[:, :600]
    ctr = {"auto": np.nan, "given": 0.25,
           "per_row": np.linspace(-1, 1, len(c))}[center]
    bw = np.full(len(c), 0.5) if center == "per_row" else 0.5
    dims = {"m": 40, "p": 41}
    got = tp.histogram_around_mode(
        _t(c), _t(ctr) if np.ndim(ctr) else ctr, _t(bw) if np.ndim(bw) else bw,
        dims=dims)
    want = jp.histogram_around_mode(c, ctr, bw, dims=dims)
    _exact(got, want, "histogram_around_mode")
    flag = tp.histogram_around_mode.checker(_t(c), ctr, bw)
    want_flag = jp.histogram_around_mode.checker(c, ctr, bw)
    np.testing.assert_array_equal(flag.numpy(), np.asarray(want_flag))


def _hists(currents):
    import dspeed_tpu.processors as jp

    w, e = jp.histogram(currents, dims={"m": 100, "p": 101})
    return np.asarray(w), np.asarray(e)


@pytest.mark.parametrize("max_in", ["nan", "value", "beyond", "per_row"])
def test_histogram_stats_matches_jax(currents, max_in):
    import dspeed_tpu.processors as jp

    w, e = _hists(currents)
    mx = {"nan": np.nan, "value": 0.5, "beyond": 1e6,
          "per_row": np.where(np.arange(len(w)) % 3 == 0, np.nan, e[:, 40])}[max_in]
    got = tp.histogram_stats(_t(w), _t(e), _t(mx) if np.ndim(mx) else mx)
    want = jp.histogram_stats(w, e, mx)
    _exact(got, want, "histogram_stats")


@pytest.mark.parametrize("width_type", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("skip", [0, 1])
def test_histogram_peakstats_matches_jax(currents, width_type, skip):
    import dspeed_tpu.processors as jp

    w, e = _hists(currents)
    mx = np.where(np.arange(len(w)) % 4 == 0, e[:, 30] + 1e-3, np.nan)
    got = tp.histogram_peakstats(_t(w), _t(e), _t(mx), skip, width_type)
    want = jp.histogram_peakstats(w, e, mx, skip, width_type)
    _exact(got, want, "histogram_peakstats")
    flag = tp.histogram_peakstats.checker(_t(w), _t(e), _t(mx), skip, width_type)
    np.testing.assert_array_equal(
        flag.numpy(), np.asarray(jp.histogram_peakstats.checker(w, e, mx, skip,
                                                                width_type)))


def _extrema_inputs(currents):
    """The chain's peak-finder arguments, with a row of NaN ``amax`` and a
    row (a sine) that fills all 20 slots, whose ``amax`` is 0."""
    import dspeed_tpu.processors as jp

    c = currents.copy()
    c[11] = 15 * np.sin(2 * np.pi * np.arange(c.shape[1]) / 40)
    w, e = jp.histogram(c, dims={"m": 100, "p": 101})
    fwhm = np.asarray(jp.histogram_stats(w, e, np.nan)[2])
    amax = 3 * fwhm
    amax[11] = 0.0
    amax[12] = np.nan
    return c, amax


@pytest.mark.parametrize("reverse, rows", [
    (False, "currents"), (True, "currents"), (False, "edge float64"),
    (True, "edge float64"), (True, "edge float32")],
    ids=["False", "True", "edge-float64-False", "edge-float64-True",
         "edge-float32-True"])
def test_peakdet_scan_plain_matches_jax_scan(currents, reverse, rows):
    """The SiPM currents (a NaN sample, a row that fills every slot, a NaN
    ``amax``), and ``chip_smoke.peakdet_edge_rows`` (the rows that
    ``tools/scan_emu`` holds the kernel to: ties, infinite and NaN samples,
    signed zeros, declarations at every sample across the kernel's steps)."""
    from dspeed_tpu.processors.peak_finding import _peakdet_scan

    if rows == "currents":
        c, amax = _extrema_inputs(currents)
        pars = (np.full(len(c), 5.0), np.full(len(c), 0.1), amax, np.zeros(len(c)))
    else:
        sys.path.insert(0, REPO)
        import chip_smoke

        c, pars = chip_smoke.peakdet_edge_rows(1019)
        dt = rows.split()[1]
        c, pars = c.astype(dt), tuple(p.astype(dt) for p in pars)
    got = _cuda.peakdet_scan_plain(_t(c), *map(_t, pars), 20, 20, reverse)
    want = _peakdet_scan(c, *pars, 20, 20, reverse=reverse)
    _exact(got, [np.asarray(x) for x in want], f"sweep reverse={reverse}")
    if rows == "currents":
        assert int(got[2][11]) == 20 and int(got[2][12]) == 0 and int(got[3][12]) == 0
    else:  # the sine fills every slot; a NaN amax declares nothing
        assert int(got[2][3]) == 20 and int(got[2][2]) == 0 and int(got[3][2]) == 0
        assert (got[2] + got[3]).sum() > 200


@pytest.mark.parametrize("direction", [0, 1, 2, 3])
def test_get_multi_local_extrema_matches_jax(currents, direction):
    import dspeed_tpu.processors as jp

    c, amax = _extrema_inputs(currents)
    dims = {"m": 20, "p": 20}
    got = tp.get_multi_local_extrema(_t(c), 5.0, 0.1, direction, _t(amax), 0.0,
                                     dims=dims)
    want = jp.get_multi_local_extrema(c, 5.0, 0.1, direction, amax, 0.0, dims=dims)
    _exact(got, want, f"direction {direction}")
    assert torch.isnan(got[0][7]).all() and got[2][7] == 0  # the NaN sample's row
    assert got[2][12] == 0  # NaN amax: nothing declared
    if direction in (0, 1):
        assert got[2][11] == 20


@pytest.mark.parametrize("width", [10, 3, 1])
def test_peak_snr_threshold_matches_jax(currents, width):
    import dspeed_tpu.processors as jp

    c, amax = _extrema_inputs(currents)
    vt = np.asarray(jp.get_multi_local_extrema(c, 5.0, 0.1, 1, amax, 0.0,
                                               dims={"m": 20, "p": 20})[0])
    ratio = np.float32(0.8) if width else 0.5
    got = tp.peak_snr_threshold(_t(c), _t(vt), ratio, width)
    want = jp.peak_snr_threshold(c, vt, ratio, width)
    _exact(got, want, "peak_snr_threshold")


def test_remove_duplicates_matches_jax():
    import dspeed_tpu.processors as jp

    rng = np.random.default_rng(4)
    t = rng.integers(0, 6, (32, 8)).astype(np.float64)
    t[rng.random((32, 8)) < 0.2] = np.nan
    t[3] = np.nan
    vmin = rng.integers(0, 50, (32, 8)).astype(np.float64)
    vmin[3] = np.nan
    got = tp.remove_duplicates(_t(t), _t(vmin))
    want = jp.remove_duplicates(t, vmin)
    _exact(got, want, "remove_duplicates")


def test_multi_t_filter_matches_jax(currents):
    import dspeed_tpu.processors as jp

    c, amax = _extrema_inputs(currents)
    vmax, vmin = (np.asarray(x) for x in jp.get_multi_local_extrema(
        c, 5.0, 0.1, 0, amax, 0.0, dims={"m": 20, "p": 20})[:2])
    thr = np.where(np.arange(len(c)) == 5, np.nan, 2.0)
    got = tp.multi_t_filter(_t(c), _t(thr), _t(vmax), _t(vmin))
    want = jp.multi_t_filter(c, thr, vmax, vmin)
    _exact(got, want, "multi_t_filter")


def test_multi_a_filter_matches_jax(currents):
    import dspeed_tpu.processors as jp

    c, amax = _extrema_inputs(currents)
    vt = np.array(jp.get_multi_local_extrema(c, 5.0, 0.1, 1, amax, 0.0,
                                              dims={"m": 20, "p": 20})[0])
    vt[2, 0] = c.shape[1] + 3  # out of the row: NaN
    got = tp.multi_a_filter(_t(c), _t(vt))
    want = jp.multi_a_filter(c, vt)
    _exact(got, want, "multi_a_filter")


def test_registry_holds_the_sipm_processors():
    names = ["gaussian_filter1d", "reflected_convolve_wf", "histogram",
             "histogram_around_mode", "histogram_stats", "histogram_peakstats",
             "get_multi_local_extrema", "peak_snr_threshold", "remove_duplicates",
             "multi_t_filter", "multi_a_filter"]
    for n in names:
        assert isinstance(getattr(tp, n), tp.Kernel), n
    assert len(tp._modules) == 108  # 51, the recursive filters' 23, the extras' 18, slice 17's 16


# ---------------------------------------------------------------------------
# K7's reflected_conv op and the SiPM group


def _table(lh5, wf):
    return lh5.Table({"waveform": lh5.WaveformTable(
        values=wf, t0=0.0, t0_units="ns", dt=16.0, dt_units="ns")})


def _sipm_group(wf, cfg=None):
    """(chain, the group step, its inputs) of the port's SiPM chain on
    ``wf``, built on the CPU in the default mode."""
    chain, _, _ = torch_build(cfg or SIPM, _table(dspeed_tpu_torch.lh5, wf),
                              device="cpu")
    inputs, _ = chain._gather_inputs(0, len(wf))
    env = chain._to_device(inputs)
    env.update(chain._const_env())
    (step,) = [s for s in chain._steps if isinstance(s, GroupStep)]
    return chain, step, {k: env[k] for k in step.ext_in}


def _one_op_config(taps_dtype):
    return {
        "outputs": ["wf_g"],
        "processors": {
            "gk": {"function": "gaussian_filter1d", "module": "dspeed_tpu.processors",
                   "args": [1.5, 4.0, f"gk(13, '{taps_dtype}')"]},
            "wf_g": {"function": "reflected_convolve_wf",
                     "module": "dspeed_tpu.processors",
                     "args": ["waveform", "gk", "wf_g(len(waveform))"], "unit": "ADC"},
        },
    }


def _pallas_walk(prog, members, vals):
    """The same members traced into one Pallas row-tile program
    (``_pallas.generic_rows`` in interpret mode) on the same inputs."""
    import jax.numpy as jnp

    import dspeed_tpu.processors as jp
    from dspeed_tpu.processors import _pallas

    jdt = {torch.float32: jnp.float32, torch.float64: jnp.float64}
    ops = [op for op in prog.ops if op.code != 1]

    def body(jv):
        env = dict(jv)
        for op in ops:
            jargs = [env[prog.slots[a[1]].key].astype(jdt[a[2]]) if a[0] == "slot"
                     else a[1] for a in op.args]
            kern = getattr(jp, op.step.kernel.__name__)
            outs = kern(*jargs, dims=op.step.dims)
            for sid, o in zip(op.outs, outs):
                env[prog.slots[sid].key] = o
        return {k: env[k] for k in prog.escapes}

    jvals = {k: np.asarray(v) for k, v in vals.items()}
    return _pallas.generic_rows(body, jvals, {k: v.ndim - 1 for k, v in jvals.items()},
                                interpret=True)


def _check_tile(got, want, keys):
    assert want is not None, "generic_rows declined the geometry"
    for k in keys:
        a, b = got[k].numpy(), np.asarray(want[k])
        assert a.shape == b.shape and a.dtype == b.dtype, (k, a.dtype, b.dtype)
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=f"{k} NaN")
        np.testing.assert_allclose(np.nan_to_num(a, nan=-12345.0),
                                   np.nan_to_num(b, nan=-12345.0), err_msg=k,
                                   **TOL)


@pytest.mark.parametrize("taps", ["d", "f"])
def test_reflected_op_plain_walk_matches_pallas_generic_rows(taps):
    """The op alone at 8 x 256: float64 taps make a float64 plane, float32
    taps a float32 one."""
    wf, _ = sipm_waveforms(n=8, nsamp=256)
    wf[2, 17] = np.nan
    chain, _, _ = torch_build(_one_op_config(taps), _table(dspeed_tpu_torch.lh5, wf),
                              device="cpu", fuse=False)
    inputs, _ = chain._gather_inputs(0, len(wf))
    env = chain._to_device(inputs)
    env.update(chain._const_env())
    (step,) = [s for s in chain._steps if getattr(getattr(s, "kernel", None),
                                                  "__name__", "") == "reflected_convolve_wf"]
    out = step.out_specs[0].key
    vals = {k: env[k] for k in chain._step_env_reads(step)}
    prog = _tile_program.lower([step], vals, [out])
    assert [op.code for op in prog.ops] == [1, _tile_program.OPCODES["reflected_conv"]]
    assert prog.slots[prog.by_key[out]].dtype == (torch.float64 if taps == "d"
                                                  else torch.float32)
    got = _cuda.generic_rows_plain(prog, vals)
    _check_tile(got, _pallas_walk(prog, [step], vals), [out])
    # the plain walk is the unfused step
    step.run(env)
    assert torch.equal(torch.nan_to_num(got[out], nan=7.0),
                       torch.nan_to_num(env[out], nan=7.0))


def test_sipm_group_plain_walk_matches_pallas_generic_rows():
    wf, _ = sipm_waveforms(n=8, nsamp=256)
    wf[5, 0] = np.nan
    _, step, vals = _sipm_group(wf)
    prog = _tile_program.lower(step.members, vals, step.escapes)
    got = _cuda.generic_rows_plain(prog, vals)
    _check_tile(got, _pallas_walk(prog, step.members, vals), step.escapes)


def test_default_mode_forms_the_jax_group(monkeypatch):
    from dspeed_tpu import lh5 as jlh5
    from dspeed_tpu.processing_chain import GroupStep as JaxGroupStep
    from dspeed_tpu.processing_chain import build_processing_chain as jax_build

    monkeypatch.delenv("DSPEED_TPU_FUSE", raising=False)
    wf, _ = sipm_waveforms(n=16)
    jc, _, _ = jax_build(SIPM, _table(jlh5, wf))
    tc, _, _ = torch_build(SIPM, _table(dspeed_tpu_torch.lh5, wf), device="cpu")
    jg = [s for s in jc._steps if isinstance(s, JaxGroupStep)]
    tg = [s for s in tc._steps if isinstance(s, GroupStep)]
    kinds = [[m.kernel.__name__ for m in g.members] for g in tg]
    assert kinds == [[m.kernel.__name__ for m in g.members] for g in jg]
    assert kinds == [["reflected_convolve_wf", "avg_current"]]
    assert [k.split("#")[0] for k in tg[0].ext_in] == [k.split("#")[0] for k in jg[0].ext_in]
    assert [k.split("#")[0] for k in tg[0].escapes] == ["curr"]
    assert len(tc._steps) == len(jc._steps) == 9
    # the group lowers: the float64 planes of the SiPM chain stay in K7
    _tile_program.reset_splits()
    dspeed_tpu_torch.build_dsp(_table(dspeed_tpu_torch.lh5, wf), dsp_config=SIPM,
                               device="cpu")
    assert _tile_program.SPLITS == {}
    _, step, vals = _sipm_group(wf)
    prog = _tile_program.lower(step.members, vals, step.escapes)
    assert [str(s.dtype) for s in prog.slots if s.kind == "plane"] == [
        "torch.float32", "torch.float64", "torch.float64"]
    assert [op.plan for op in prog.ops] == [0, 1, 1]


@pytest.mark.parametrize("why, cfg_edit", [
    ("33 taps", lambda c: c["processors"]["gk"]["args"].__setitem__(2, "gk(33, 'd')")),
    ("NaN taps", None),
])
def test_reflected_op_refuses_what_it_cannot_run(why, cfg_edit):
    from dspeed_tpu_torch.processors._tile_program import LoweringError

    wf, _ = sipm_waveforms(n=4, nsamp=256)
    cfg = _one_op_config("d")
    if cfg_edit is not None:
        cfg["processors"]["gk"]["args"][0] = 4.0
        cfg_edit(cfg)
    chain, _, _ = torch_build(cfg, _table(dspeed_tpu_torch.lh5, wf), device="cpu",
                              fuse=False)
    inputs, _ = chain._gather_inputs(0, len(wf))
    env = chain._to_device(inputs)
    env.update(chain._const_env())
    (step,) = [s for s in chain._steps if getattr(getattr(s, "kernel", None),
                                                  "__name__", "") == "reflected_convolve_wf"]
    if why == "NaN taps":
        step.arg_specs[1].value = np.full(9, np.nan)
    vals = {k: env[k] for k in chain._step_env_reads(step)}
    with pytest.raises(LoweringError, match="direct route"):
        _tile_program.lower([step], vals, [step.out_specs[0].key])


def _edge_rows(n, nsamp, seed=3):
    """``chip_smoke.sipm_edge_rows`` on the generator's rows: a NaN sample,
    an infinite sample, extremes in the reflected edges."""
    sys.path.insert(0, REPO)
    import chip_smoke

    return chip_smoke.sipm_edge_rows(sipm_waveforms(n=n, nsamp=nsamp, seed=seed)[0])


def test_reflected_op_float64_rows():
    """The op alone on 8 x 256 float64 rows (the edge rows among them): a
    float64 program (K7's float64 kernel), its plain walk against the JAX
    package's ``_pallas.generic_rows`` in interpret mode at the golden
    replay's tolerance of the column's scale, and the member's own body
    equal to the plain walk bit for bit."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torch_k7_ops import check_group, member_outputs

    wf = _edge_rows(8, 256).astype(np.float64)
    chain, _, _ = torch_build(_one_op_config("d"), _table(dspeed_tpu_torch.lh5, wf),
                              device="cpu", fuse=False)
    inputs, _ = chain._gather_inputs(0, len(wf))
    env = chain._to_device(inputs)
    env.update(chain._const_env())
    (step,) = [s for s in chain._steps if getattr(getattr(s, "kernel", None),
                                                  "__name__", "") == "reflected_convolve_wf"]
    vals = {k: env[k] for k in chain._step_env_reads(step)}
    prog = check_group([step], vals, ["reflected_conv"], f64=True)
    assert prog.f64 and all(s.dtype == torch.float64 for s in prog.slots
                            if s.kind == "plane")
    plain = _cuda.generic_rows_plain(prog, vals)
    for k, v in member_outputs(step, vals).items():
        assert _same(v, plain[k]), k
    assert torch.isinf(plain[step.out_specs[0].key][1]).any()


def test_sipm_float64_rows_fuse_and_equal_the_float32_chain():
    """The SiPM chain on float64 rows forms the float32 chain's group, which
    lowers as one float64 program and splits nothing; widening is exact and
    both programs take the same float64 products and sums, so every column
    equals the float32 chain's bit for bit."""
    wf = _edge_rows(32, 1024)
    _, step, vals = _sipm_group(wf.astype(np.float64))
    assert [m.kernel.__name__ for m in step.members] == ["reflected_convolve_wf",
                                                          "avg_current"]
    prog = _tile_program.lower(step.members, vals, step.escapes)
    assert prog.f64 and [op.code for op in prog.ops] == [
        _tile_program.OPCODES[c] for c in ("load", "reflected_conv", "avg_current")]
    got = {}
    for dt in ("float32", "float64"):
        _tile_program.reset_splits()
        got[dt] = _run_port(wf.astype(dt))
        assert _tile_program.SPLITS == {}, dt
    for k in got["float32"]:
        for a, b in zip(got["float64"][k], got["float32"][k]):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k


@pytest.fixture(scope="module")
def sipm_f64_jax_run():
    import dspeed_tpu
    from dspeed_tpu import lh5 as jlh5

    wf = _edge_rows(64, 1024).astype(np.float64)
    return wf, _vov_columns(dspeed_tpu.build_dsp(_table(jlh5, wf), dsp_config=SIPM))


def test_sipm_float64_chain_matches_jax(sipm_f64_jax_run):
    """On float64 rows: lengths and ``trigger_pos`` exact, ``energies``
    within rtol 1e-9 of the JAX package's chain on the same rows."""
    wf, want = sipm_f64_jax_run
    got = _run_port(wf)
    for k in ("trigger_pos", "energies"):
        (gl, gf), (wl, wv) = got[k], want[k]
        np.testing.assert_array_equal(gl, wl, err_msg=f"{k} lengths")
        gf, wv = gf[: wl[-1]], wv[: wl[-1]]
        if k == "trigger_pos":
            np.testing.assert_array_equal(gf, wv)
        else:
            np.testing.assert_allclose(gf, wv, rtol=1e-9, atol=0)


# ---------------------------------------------------------------------------
# the whole chain


def _vov_columns(out, keys=("energies", "trigger_pos")):
    return {k: (np.asarray(out[k].cumulative_length.nda),
                np.asarray(out[k].flattened_data.nda)) for k in keys}


def _run_port(wf, fuse=True):
    return _vov_columns(dspeed_tpu_torch.build_dsp(
        _table(dspeed_tpu_torch.lh5, wf), dsp_config=SIPM, device="cpu", fuse=fuse))


@pytest.fixture(scope="module")
def sipm_jax_run():
    import dspeed_tpu
    from dspeed_tpu import lh5 as jlh5

    wf, n_pulse = sipm_waveforms(n=64)
    wf[6, 500] = np.nan
    return wf, n_pulse, _vov_columns(dspeed_tpu.build_dsp(_table(jlh5, wf),
                                                          dsp_config=SIPM))


@pytest.mark.parametrize("fuse", [True, False, "generic"])
def test_sipm_chain_matches_jax(sipm_jax_run, fuse):
    wf, n_pulse, want = sipm_jax_run
    got = _run_port(wf, fuse)
    for k in ("trigger_pos", "energies"):
        gl, gf = got[k]
        wl, wv = want[k]
        np.testing.assert_array_equal(gl, wl, err_msg=f"{k} lengths")
        assert gf.dtype == wv.dtype == np.float64
        if k == "trigger_pos":
            np.testing.assert_array_equal(gf[: wl[-1]], wv[: wl[-1]])
        else:
            np.testing.assert_allclose(gf[: wl[-1]], wv[: wl[-1]], **TOL)
    lens = np.diff(got["trigger_pos"][0].astype(np.int64), prepend=0)
    assert lens[6] == 0  # the NaN sample's event finds nothing
    assert np.abs(lens - n_pulse)[np.arange(len(wf)) != 6].mean() < 0.5


def test_sipm_modes_equal_bit_for_bit():
    wf, _ = sipm_waveforms(n=32)
    wf[2, 3] = np.inf
    unfused = _run_port(wf, False)
    for fuse in (True, "generic"):
        got = _run_port(wf, fuse)
        for k in unfused:
            for a, b in zip(got[k], unfused[k]):
                assert a.tobytes() == b.tobytes(), (fuse, k)


@pytest.mark.parametrize("fuse", [True, False, "generic"])
def test_sipm_chain_meets_golden(fuse):
    """``tests/goldens/sipm_chain.npz`` at the golden replay's tolerance
    (``tests/test_goldens.py``: rtol 1e-9, atol 1e-12, lengths exact)."""
    golden = np.load(GOLDEN)
    wf, _ = sipm_waveforms(n=32)  # tools/make_goldens.py:54
    got = _run_port(wf, fuse)
    for k, (cl, flat) in got.items():
        np.testing.assert_array_equal(cl, golden[f"{k}__cumlen"], err_msg=k)
        w = golden[f"{k}__flat"]
        assert flat.dtype == w.dtype
        np.testing.assert_allclose(flat[: len(w)], w, rtol=1e-9, atol=1e-12,
                                   equal_nan=True, err_msg=k)


def test_spe_trains_find_their_pulses():
    """``tests/test_build_dsp.py:171``'s generator through both packages."""
    import dspeed_tpu
    from dspeed_tpu import lh5 as jlh5

    wf, n_pulses = spe_waveforms()
    want = _vov_columns(dspeed_tpu.build_dsp(_table(jlh5, wf), dsp_config=SIPM))
    got = _run_port(wf)
    for k in got:
        np.testing.assert_array_equal(got[k][0], want[k][0], err_msg=k)
    np.testing.assert_array_equal(got["trigger_pos"][1], want["trigger_pos"][1])
    found = np.diff(got["trigger_pos"][0].astype(np.int64), prepend=0)
    assert np.abs(found - n_pulses).mean() < 1.5


# ---------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _same(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and bool(
        ((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [37, 1, 600])
def test_k7_sipm_group_on_the_card(cuda_device, rows):
    """K7 on the SiPM group equals the plain walk bit for bit: a NaN row,
    an infinite sample, extremes in the reflected edges."""
    sys.path.insert(0, REPO)
    import chip_smoke

    wf, _ = sipm_waveforms(n=max(rows, 5))
    wf = chip_smoke.sipm_edge_rows(wf)[:rows]
    _, step, vals = _sipm_group(wf)
    vals = {k: v.to(cuda_device) for k, v in vals.items()}
    prog = _tile_program.lower(step.members, vals, step.escapes)
    every = sorted(s.key for s in prog.slots if not s.ext)
    full = _tile_program.lower(step.members, vals, every)
    before = _cuda.LAUNCHES["generic_rows"]
    got = _cuda.generic_rows(full, vals)
    assert _cuda.LAUNCHES["generic_rows"] == before + 1
    want = _cuda.generic_rows_plain(full, vals)
    for k in every:
        assert _same(got[k], want[k]), k


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [37, 1, 600])
def test_k7_sipm_group_float64_on_the_card(cuda_device, rows):
    """K7's float64 kernel on the SiPM group over float64 rows (the edge
    rows among them) equals the plain walk bit for bit, every key it
    writes, and the float32 rows' launch on the same rows widened."""
    wf = _edge_rows(max(rows, 5), 1024)[:rows]
    out = {}
    for dt in (np.float64, np.float32):
        _, step, vals = _sipm_group(wf.astype(dt))
        vals = {k: v.to(cuda_device) for k, v in vals.items()}
        prog = _tile_program.lower(step.members, vals, step.escapes)
        every = sorted(s.key for s in prog.slots if not s.ext)
        full = _tile_program.lower(step.members, vals, every)
        assert full.f64 == (dt == np.float64)
        got = _cuda.generic_rows(full, vals)
        want = _cuda.generic_rows_plain(full, vals)
        for k in every:
            assert _same(got[k], want[k]), k
        out[dt] = got[step.escapes[0]]
    assert _same(out[np.float64], out[np.float32])


@pytest.mark.gpu
@pytest.mark.parametrize("taps", ["d", "f", "d on float64 rows"])
def test_k7_reflected_op_alone_on_the_card(cuda_device, taps):
    wf, _ = sipm_waveforms(n=40, nsamp=301)
    if taps.endswith("rows"):
        wf = wf.astype(np.float64)
    wf[1, 0] = np.nan
    wf[2, 150] = np.inf
    chain, _, _ = torch_build(_one_op_config(taps[0]), _table(dspeed_tpu_torch.lh5, wf),
                              device="cpu", fuse=False)
    inputs, _ = chain._gather_inputs(0, len(wf))
    env = chain._to_device(inputs)
    env.update(chain._const_env())
    (step,) = [s for s in chain._steps if getattr(getattr(s, "kernel", None),
                                                  "__name__", "") == "reflected_convolve_wf"]
    out = step.out_specs[0].key
    vals = {k: env[k].to(cuda_device) for k in chain._step_env_reads(step)}
    prog = _tile_program.lower([step], vals, [out])
    assert prog.f64 == taps.endswith("rows")
    assert _same(_cuda.generic_rows(prog, vals)[out],
                 _cuda.generic_rows_plain(prog, vals)[out])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("reverse", [False, True])
def test_peakdet_scan_on_the_card(cuda_device, dtype, reverse):
    c = torch.from_numpy(_current(sipm_waveforms(n=300)[0])).to(dtype)
    c[11] = (15 * torch.sin(2 * torch.pi * torch.arange(c.shape[1]) / 40)).to(dtype)
    c[13, 40] = float("nan")
    amax = torch.full((c.shape[0],), 30.0, dtype=dtype)
    amax[11] = 0.0
    amax[12] = float("nan")
    c, amax = c.to(cuda_device), amax.to(cuda_device)
    before = _cuda.LAUNCHES["peakdet_scan"]
    got = _cuda.peakdet_scan(c, 5.0, 0.1, amax, 0.0, 20, 20, reverse)
    assert _cuda.LAUNCHES["peakdet_scan"] == before + 1
    want = _cuda.peakdet_scan_plain(c, 5.0, 0.1, amax, 0.0, 20, 20, reverse)
    for g, w in zip(got, want):
        assert _same(g, w)
    assert int(got[2][11]) == 20 and int(got[2][12]) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("direction", [0, 1, 2, 3])
def test_get_multi_local_extrema_on_the_card(cuda_device, direction):
    c = torch.from_numpy(_current(sipm_waveforms(n=200)[0]))
    amax = torch.full((c.shape[0],), 30.0, dtype=c.dtype)
    amax[3] = float("nan")
    dims = {"m": 20, "p": 20}
    got = tp.get_multi_local_extrema(c.to(cuda_device), 5.0, 0.1, direction,
                                     amax.to(cuda_device), 0.0, dims=dims)
    want = tp.get_multi_local_extrema(c, 5.0, 0.1, direction, amax, 0.0, dims=dims)
    for g, w in zip(got, want):
        assert _same(g.cpu(), w)


@pytest.mark.gpu
def test_sipm_build_dsp_on_the_card(cuda_device):
    """One chunk: K7 once and the sweep once, no split; the VoV columns equal
    the CPU run's."""
    wf, _ = sipm_waveforms(n=256)
    tb = _table(dspeed_tpu_torch.lh5, wf)
    _cuda.reset_launches()
    _tile_program.reset_splits()
    got = _vov_columns(dspeed_tpu_torch.build_dsp(tb, dsp_config=SIPM,
                                                  device="cuda"))
    assert _cuda.LAUNCHES["generic_rows"] == 1 and _cuda.LAUNCHES["peakdet_scan"] == 1
    assert _tile_program.SPLITS == {}
    want = _vov_columns(dspeed_tpu_torch.build_dsp(tb, dsp_config=SIPM, device="cpu"))
    for k in want:
        for a, b in zip(got[k], want[k]):
            assert a.tobytes() == b.tobytes(), k
