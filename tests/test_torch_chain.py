"""The port's energy configuration end to end, against the JAX package.

The energy configuration is ``configs/hpge-energy-timing.yaml`` with its
``outputs`` cut to the 17 energy and baseline columns. It runs through the
port's ``build_dsp`` on the CPU (Table -> Table and file -> file) and through
the JAX package's ``build_dsp`` (x64 CPU) on the same synthetic HPGe events,
one of them with a NaN sample and one with a NaN baseline. Float columns
agree within ``1e-5 * max|column|`` with identical NaN positions; ``tp_min``
and ``tp_max`` agree exactly. The same columns are held against
``tests/goldens/hpge_chain.npz``, and the fusion pass must apply the JAX
package's substitutions.
"""

import os
import sys

import h5py
import numpy as np
import pytest
import yaml

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_build_dsp import DB_FLAT, make_hpge_waveforms  # noqa: E402

import dspeed_tpu  # noqa: E402
import dspeed_tpu_torch  # noqa: E402
from dspeed_tpu.processing_chain import (  # noqa: E402
    build_processing_chain as jax_build_chain,
)
from dspeed_tpu_torch.processing_chain import (  # noqa: E402
    build_processing_chain as torch_build_chain,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "hpge-energy-timing.yaml")
GOLDEN = os.path.join(REPO, "tests", "goldens", "hpge_chain.npz")
ENERGY_OUTPUTS = [
    "tp_min", "tp_max", "wf_min", "wf_max", "bl_mean", "bl_std", "bl_slope",
    "bl_intercept", "pz_mean", "pz_std", "pz_slope", "trapTmax", "trapEmax",
    "cuspEmax", "cuspEftp", "zacEmax", "zacEftp",
]
EXACT = ("tp_min", "tp_max")
REL = 1e-5


def _energy_config():
    with open(CONFIG) as f:
        cfg = yaml.safe_load(f)
    cfg["outputs"] = list(ENERGY_OUTPUTS)
    return cfg


def _events(n=32, nan_rows=True):
    wf, amp, _t0, bl = make_hpge_waveforms(n=n)
    bl = bl.astype("float32")
    if nan_rows:
        wf[3, 500] = np.nan
        bl[5] = np.nan
    return wf, bl, amp


def _table(lh5, wf, bl):
    return lh5.Table({
        "waveform": lh5.WaveformTable(
            values=wf, t0=0.0, t0_units="ns", dt=16.0, dt_units="ns"
        ),
        "baseline": lh5.Array(bl),
    })


def _columns(out) -> dict:
    return {k: np.asarray(out[k].nda) for k in ENERGY_OUTPUTS}


def _assert_columns(got: dict, want: dict):
    assert set(got) == set(want) == set(ENERGY_OUTPUTS)
    for k in ENERGY_OUTPUTS:
        g, w = np.asarray(got[k], np.float64), np.asarray(want[k], np.float64)
        assert g.shape == w.shape, k
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=f"{k}: NaN")
        ok = ~np.isnan(w)
        if k in EXACT:
            np.testing.assert_array_equal(g[ok], w[ok], err_msg=k)
            continue
        err = np.abs(g[ok] - w[ok]).max()
        scale = np.abs(w[ok]).max()
        assert err <= REL * scale, f"{k}: {err:.3e} > {REL:g} * {scale:.3e}"


@pytest.fixture(scope="module")
def events():
    return _events()


@pytest.fixture(scope="module")
def jax_columns(events):
    wf, bl, _ = events
    out = dspeed_tpu.build_dsp(
        _table(dspeed_tpu.lh5, wf, bl), dsp_config=_energy_config(),
        database=DB_FLAT,
    )
    return _columns(out)


def test_energy_chain_table_matches_jax(events, jax_columns):
    wf, bl, amp = events
    out = dspeed_tpu_torch.build_dsp(
        _table(dspeed_tpu_torch.lh5, wf, bl), dsp_config=_energy_config(),
        database=DB_FLAT, device="cpu",
    )
    got = _columns(out)
    _assert_columns(got, jax_columns)
    ok = np.isfinite(got["trapEmax"])
    assert ok.sum() == len(amp) - 2
    np.testing.assert_allclose(got["trapEmax"][ok], amp[ok], rtol=5e-3)


def test_energy_chain_file_matches_jax(events, jax_columns, tmp_path):
    wf, bl, _ = events
    raw = str(tmp_path / "energy_raw.lh5")
    dspeed_tpu_torch.lh5.write(_table(dspeed_tpu_torch.lh5, wf, bl), "geds/raw", raw)
    db = {"geds": DB_FLAT}
    cfg = _energy_config()
    out_t = str(tmp_path / "energy_dsp_torch.lh5")
    out_j = str(tmp_path / "energy_dsp_jax.lh5")
    # three chunks, the last one short: the loop writes each at its offset
    dspeed_tpu_torch.build_dsp(raw, out_t, cfg, database=db, device="cpu",
                               buffer_len=12)
    dspeed_tpu.build_dsp(raw, out_j, cfg, database=db)
    with h5py.File(out_t, "r") as ft, h5py.File(out_j, "r") as fj:
        got = {k: ft[f"geds/dsp/{k}"][()] for k in ENERGY_OUTPUTS}
        want = {k: fj[f"geds/dsp/{k}"][()] for k in ENERGY_OUTPUTS}
        for k in ENERGY_OUTPUTS:
            assert dict(ft[f"geds/dsp/{k}"].attrs) == dict(fj[f"geds/dsp/{k}"].attrs), k
    _assert_columns(got, want)
    _assert_columns(got, jax_columns)


def test_energy_chain_matches_golden():
    golden = np.load(GOLDEN)
    wf, bl, _ = _events(n=32, nan_rows=False)  # tools/make_goldens.py:35
    out = dspeed_tpu_torch.build_dsp(
        _table(dspeed_tpu_torch.lh5, wf, bl), dsp_config=_energy_config(),
        database=DB_FLAT, device="cpu",
    )
    _assert_columns(_columns(out), {k: golden[k] for k in ENERGY_OUTPUTS})


def _chains(monkeypatch, events):
    """The JAX package's and the port's chains, both built unfused."""
    wf, bl, _ = events
    cfg = _energy_config()
    monkeypatch.setenv("DSPEED_TPU_FUSE", "0")
    jc, _, _ = jax_build_chain(
        cfg, _table(dspeed_tpu.lh5, wf, bl), db_dict=DB_FLAT
    )
    tc, _, _ = torch_build_chain(
        cfg, _table(dspeed_tpu_torch.lh5, wf, bl), db_dict=DB_FLAT,
        device="cpu", fuse=False,
    )
    return jc, tc


def _kinds(chain):
    return [
        (type(s).__name__, str(s).split("(")[0] if type(s).__name__ == "KernelStep" else "")
        for s in chain._steps
    ]


def test_fusion_pass_matches_jax(monkeypatch, events):
    jc, tc = _chains(monkeypatch, events)
    assert _kinds(tc) == _kinds(jc)
    applied = tc.optimize_fusions()
    assert applied == jc.optimize_fusions()
    assert "fused_energy_front[1]" in applied and "fused_conv_bank[2]" in applied
    assert _kinds(tc) == _kinds(jc)
    assert len(tc._steps) == 11
    assert [k for _, k in _kinds(tc) if k] == [
        "fused_energy_front", "fused_conv_bank", "amax", "fixed_time_pickoff",
        "amax", "fixed_time_pickoff",
    ]


def test_unfused_chain_matches_fused(events):
    wf, bl, _ = events
    kw = dict(dsp_config=_energy_config(), database=DB_FLAT, device="cpu")
    tb = _table(dspeed_tpu_torch.lh5, wf, bl)
    fused = _columns(dspeed_tpu_torch.build_dsp(tb, fuse=True, **kw))
    unfused = _columns(dspeed_tpu_torch.build_dsp(tb, fuse=False, **kw))
    _assert_columns(unfused, fused)


@pytest.mark.parametrize("name", ["cusp_kernel", "zac_kernel"])
def test_constant_filter_arrays_match_jax(monkeypatch, events, name):
    jc, tc = _chains(monkeypatch, events)
    want = np.asarray(jc._vars_dict[name].const_value, np.float64)
    got = np.asarray(tc._vars_dict[name].const_value, np.float64)
    assert got.shape == want.shape == (1696,)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
