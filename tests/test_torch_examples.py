"""The port's examples (``examples/*_torch.py``) run as integration tests on
the CPU, as ``tests/test_tutorial.py`` runs the JAX package's, and are held
to the JAX package on the same raw events:

- the quickstart's seven steps at 64 events: its DSP file's 34 columns
  against the JAX package's ``build_dsp`` (``tests/test_torch_chain.py``'s
  flagship rule: float columns within 1e-5 of their scale, ``tp_*``
  exactly; the CUSP/ZAC columns within 2e-6 of their scale, ROADMAP §3),
  ``wf_range == (27, 27)`` in checked mode, a browser PNG over 1000 bytes;
- the SiPM tutorial at 64 events: its VoV lengths and ``trigger_pos``
  exactly against the JAX package's chain;
- the browser example's two browsers, drawn to PNG and found without
  drawing;
- the multi-channel example under gloo at world size 1: ``trapEmax``
  within 1e-5 of its scale of the JAX package's unsharded chain on the same
  rows (the JAX example itself needs eight forced host devices, which a
  process cannot set once JAX is imported), and equal bit for bit to the
  port's unsharded chain.

Each JAX reference runs once, in a module-scoped fixture. Every step that
runs a chain raises when asked for the card on a machine without one.
"""

import os
import shutil
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
EXAMPLES = os.path.join(REPO, "examples")
sys.path.insert(0, HERE)
from torch_flagship import assert_timing_columns  # noqa: E402

N = 64  # events a run
CONV_COLUMNS = ("cuspEmax", "cuspEftp", "zacEmax", "zacEftp")
CONV_GAP = 2e-6  # tests/test_torch_chain.py: the banded products' order


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the examples' chains are small, and the test
    workers share the machine's cores, so a pool of threads a worker would
    mostly wait on the others'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def fresh_chain_cache():
    from dspeed_tpu_torch import build_dsp

    cache = sys.modules[build_dsp.__module__]._CHAIN_CACHE
    cache.clear()
    yield
    cache.clear()


def _example(name):
    sys.path.insert(0, EXAMPLES)
    try:
        return __import__(name)
    finally:
        sys.path.remove(EXAMPLES)


@pytest.fixture(scope="module")
def qs():
    return _example("quickstart_torch")


@pytest.fixture(scope="module")
def sp():
    return _example("sipm_pulse_finding_torch")


@pytest.fixture(scope="module")
def bw():
    return _example("browse_waveforms_torch")


@pytest.fixture(scope="module")
def mc():
    return _example("multichannel_torch")


def _jax_table(wf, bl=None):
    from dspeed_tpu import lh5 as jlh5

    cols = {"waveform": jlh5.WaveformTable(values=wf, t0=0.0, t0_units="ns", dt=16.0,
                                           dt_units="ns")}
    if bl is not None:
        cols["baseline"] = jlh5.Array(np.asarray(bl, "float32"))
    return jlh5.Table(cols)


# ---------------------------------------------------------------- quickstart
@pytest.fixture(scope="module")
def quickstart_run(qs, tmp_path_factory):
    """Steps 1 to 4 of the port's quickstart at 64 events (file -> file)."""
    workdir = str(tmp_path_factory.mktemp("quickstart_torch"))
    raw_file, amp = qs.step1_write_raw(workdir, n=N)
    cfg = qs.step2_inspect_config()
    dsp_file = qs.step3_production(raw_file, workdir, device="cpu")
    worst = qs.step4_read_back(dsp_file, amp)
    return workdir, raw_file, dsp_file, cfg, worst


@pytest.fixture(scope="module")
def quickstart_jax(qs):
    """The JAX package's chain on the quickstart's raw events."""
    import dspeed_tpu

    wf, _, bl = qs.make_waveforms(N)
    out = dspeed_tpu.build_dsp(_jax_table(wf, bl), dsp_config=qs.CONFIG,
                               database=qs.DB)
    return {k: np.asarray(out[k].nda) for k in out.keys()}


def test_quickstart_end_to_end(qs, quickstart_run):
    workdir, raw_file, dsp_file, cfg, worst = quickstart_run
    assert "trapEmax" in cfg["outputs"] and worst < 0.02
    err = qs.step5_checked_mode(workdir, device="cpu")
    assert err.wf_range == (27, 27)
    png = qs.step6_browser(raw_file, workdir, device="cpu")
    assert os.path.getsize(png) > 1000
    tb_out = qs.step7_in_memory(device="cpu")
    assert "trapEmax" in tb_out.keys()


def test_quickstart_columns_match_jax(quickstart_run, quickstart_jax):
    import h5py

    _, _, dsp_file, cfg, _ = quickstart_run
    with h5py.File(dsp_file, "r") as f:
        got = {k: f[f"det01/dsp/{k}"][()] for k in cfg["outputs"]}
        assert f["det01/dsp/tp_50"].attrs["units"] == "ns"
    want = {k: quickstart_jax[k] for k in cfg["outputs"]}
    assert_timing_columns(got, want)
    for k in CONV_COLUMNS:
        g, w = got[k].astype(np.float64), want[k].astype(np.float64)
        ok = ~np.isnan(w)
        assert np.abs(g[ok] - w[ok]).max() <= CONV_GAP * np.abs(w[ok]).max(), k


def test_quickstart_in_memory_steps(qs):
    """The steps the card runs without h5py: checked mode on an in-memory
    table (one chunk; ``test_quickstart_end_to_end`` reads a file in
    chunks of 16) and the in-memory chain on events the caller made."""
    err = qs.checked_in_memory(qs.checked_table(), device="cpu")
    assert err.wf_range == (27, 27)
    assert "out of range" in err.args[0]
    events = qs.make_waveforms(8)
    out = qs.step7_in_memory(device="cpu", events=events)
    assert len(out["trapEmax"].nda) == 8


# ---------------------------------------------------------------- SiPM
@pytest.fixture(scope="module")
def sipm_run(sp, tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("sipm_torch"))
    dsp_file, truth = sp.step2_production(workdir, device="cpu", n=N)
    return workdir, dsp_file, truth


def _vov(col):
    cl = np.asarray(col.cumulative_length.nda)
    return cl, np.asarray(col.flattened_data.nda)[: int(cl[-1]) if len(cl) else 0]


def test_sipm_tutorial_end_to_end(sp, sipm_run):
    workdir, dsp_file, truth = sipm_run
    n_found = sp.step3_read_vov(dsp_file, truth)
    assert n_found.sum() > 0
    sp.step4_checked_mode(workdir, device="cpu")


def test_sipm_tutorial_matches_jax(sp, sipm_run):
    import dspeed_tpu

    from dspeed_tpu_torch import lh5

    _, dsp_file, _ = sipm_run
    got = lh5.read("spm01/dsp", dsp_file)
    wf, _ = sp.make_sipm_waveforms(N)
    want = dspeed_tpu.build_dsp(_jax_table(wf), dsp_config=sp.CONFIG)
    for k in ("trigger_pos", "energies"):
        (gl, gf), (wl, wv) = _vov(got[k]), _vov(want[k])
        np.testing.assert_array_equal(gl, wl, err_msg=f"{k} lengths")
        if k == "trigger_pos":
            np.testing.assert_array_equal(gf, wv)
        else:
            np.testing.assert_allclose(gf, wv, rtol=2e-6, atol=2e-5)


def test_sipm_in_memory_steps(sp):
    """Production Table -> Table and checked mode, as the card runs them."""
    wf, truth = sp.make_sipm_waveforms(N)
    tb = sp.raw_table(wf)
    out = sp.produce(tb, device="cpu")
    assert sp.check_pulses(out, truth).sum() > 0
    sp.checked_in_memory(tb, device="cpu")


# ---------------------------------------------------------------- browser
def test_browse_waveforms_draws_its_pngs(bw):
    workdir = bw.main(["--device", "cpu"])
    try:
        for name in ("event_0003.png", "event_0017.png", "aligned_overlay.png"):
            assert os.path.getsize(os.path.join(workdir, name)) > 10000, name
    finally:
        shutil.rmtree(workdir)


def test_browsers_find_entries_without_drawing(bw):
    wf, _, bl = bw.make_waveforms(24)
    tb = bw.raw_table(wf, bl)
    wb = bw.curves_browser(tb, device="cpu")
    wb.find_entry(17)
    assert sorted(wb.lines) == ["tp_50", "trapEmax", "wf_blsub", "wf_trap"]
    assert len(wb.lines["wf_blsub"][0].get_ydata()) == wf.shape[1]
    wb2 = bw.aligned_browser(tb, device="cpu")
    assert list(wb2.find_next()) == [0, 1, 2]
    peaks = [float(np.nanmax(line.get_ydata())) for line in wb2.lines["wf_pz"]]
    np.testing.assert_allclose(peaks, 1.0, atol=2e-3)  # normalised by trapEmax


# ---------------------------------------------------------------- multi-channel
def test_multichannel_matches_jax(mc):
    import dspeed_tpu

    te, amp, shape = mc.run(device="cpu")
    assert shape == {"channel": 1, "data": 1} and te.shape == (2, N)
    assert np.nanmean(np.abs(te - amp) / amp) < 0.01
    wf, _, bl = mc.make_channels()
    want = np.asarray(dspeed_tpu.build_dsp(_jax_table(wf, bl),
                                           dsp_config=mc.CONFIG)["trapEmax"].nda)
    err = np.abs(te.reshape(-1) - want).max()
    assert err <= 1e-5 * np.abs(want).max(), err
    assert te.tobytes() == mc.unsharded(device="cpu").tobytes()


# ---------------------------------------------------------------- no card
@pytest.mark.parametrize("call", [
    lambda m: m["qs"].step7_in_memory(),
    lambda m: m["qs"].checked_in_memory(m["qs"].checked_table()),
    lambda m: m["sp"].produce(m["sp"].raw_table(m["sp"].make_sipm_waveforms(4)[0])),
    lambda m: m["bw"].curves_browser(m["bw"].raw_table(*m["bw"].make_waveforms(4)[::2])),
    lambda m: m["mc"].run(n_ev=4),
], ids=["quickstart", "quickstart_checked", "sipm", "browser", "multichannel"])
def test_examples_default_to_the_card(qs, sp, bw, mc, call):
    """On the card by default: without one, each example's chain step
    raises and does not carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call({"qs": qs, "sp": sp, "bw": bw, "mc": mc})
