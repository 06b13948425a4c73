"""The port's energy and timing configurations and the whole flagship end to
end, against the JAX package.

The energy configuration is ``configs/hpge-energy-timing.yaml`` with its
``outputs`` cut to the 17 energy and baseline columns; the timing
configuration keeps every column but the three A/E ones (31); the flagship
configuration is the YAML as it stands (34 columns). Each runs
through the port's ``build_dsp`` on the CPU (Table -> Table and file -> file)
and through the JAX package's ``build_dsp`` (x64 CPU) on the same synthetic
HPGe events, one of them with a NaN sample and one with a NaN baseline.
Float columns agree within ``1e-5 * max|column|`` with identical NaN
positions; index columns (``tp_*``) agree exactly. One exception, counted
and printed: on an event whose ``tp_0_est`` moved by one sample (16 ns)
because two float32 convolutions rounded differently, the columns that read
it may differ. The same columns are held against
``tests/goldens/hpge_chain.npz`` at the golden replay's own tolerance, the
CUSP/ZAC columns at 2e-6 of scale (a summation-order gap, ROADMAP §3), and
the fusion pass must apply the JAX package's substitutions.
"""

import os
import sys

import h5py
import numpy as np
import pytest
import yaml

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_build_dsp import DB_FLAT, make_hpge_waveforms  # noqa: E402
from torch_flagship import (  # noqa: E402
    assert_timing_columns as _assert_timing_columns,
    flagship_config,
)

import torch  # noqa: E402

import dspeed_tpu  # noqa: E402
import dspeed_tpu_torch  # noqa: E402
from dspeed_tpu.processing_chain import (  # noqa: E402
    build_processing_chain as jax_build_chain,
)
from dspeed_tpu_torch.processing_chain import (  # noqa: E402
    build_processing_chain as torch_build_chain,
)
from dspeed_tpu_torch.processors import convolutions as tconv  # noqa: E402


@pytest.fixture(autouse=True)
def fresh_chain_cache():
    """Each test builds its own chains: one that another test cached (with
    other fusion passes or settings patched in) must not serve it."""
    from dspeed_tpu_torch import build_dsp

    cache = sys.modules[build_dsp.__module__]._CHAIN_CACHE
    cache.clear()
    yield
    cache.clear()


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
AOE = ("A_max", "tp_aoe_max", "tp_aoe_samp")
CASCADE = ["tp_100", "tp_99", "tp_95", "tp_90", "tp_80", "tp_50", "tp_20",
           "tp_10", "tp_01"]
# the four columns the banded f32 convolution decides, and the bound of
# their summation-order gap to the golden (twice the measured 9.6e-7)
CONV_COLUMNS = ("cuspEmax", "cuspEftp", "zacEmax", "zacEftp")
CONV_GAP = 2e-6
TIMING_FUSIONS = [
    "cse[trap_norm]", "cse[amax]", "cse[wf_blsub[:1996]]",
    "fused_energy_front[2+1m]", "chained_time_point_thresh[9]",
    "fused_t0_front", "fused_conv_bank[2]", "badrow:fused_t0_front",
    "badrow:chained_time_point_thresh", "badrow:fixed_time_pickoff",
    "badrow:fixed_time_pickoff", "badrow:fused_conv_bank",
    "badrow:fixed_time_pickoff", "badrow:fixed_time_pickoff",
]


def _energy_config():
    with open(CONFIG) as f:
        cfg = yaml.safe_load(f)
    cfg["outputs"] = list(ENERGY_OUTPUTS)
    return cfg


def _timing_config():
    with open(CONFIG) as f:
        cfg = yaml.safe_load(f)
    cfg["outputs"] = [o for o in cfg["outputs"] if o not in AOE]
    assert len(cfg["outputs"]) == 31
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


def _columns(out, outputs=ENERGY_OUTPUTS) -> dict:
    return {k: np.asarray(out[k].nda) for k in outputs}


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


def _chains(monkeypatch, events, cfg=None):
    """The JAX package's and the port's chains, both built unfused."""
    wf, bl, _ = events
    cfg = _energy_config() if cfg is None else cfg
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


@pytest.mark.parametrize(
    "name, taps", [("cusp_kernel", 1696), ("zac_kernel", 1696), ("t0_kernel", 133)]
)
def test_constant_filter_arrays_match_jax(monkeypatch, events, name, taps):
    jc, tc = _chains(monkeypatch, events, _timing_config())
    want = np.asarray(jc._vars_dict[name].const_value, np.float64)
    got = np.asarray(tc._vars_dict[name].const_value, np.float64)
    assert got.shape == want.shape == (taps,)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


# ---------------------------------------------------------------------------
# the timing configuration


@pytest.fixture(scope="module")
def jax_timing_columns(events):
    wf, bl, _ = events
    cfg = _timing_config()
    out = dspeed_tpu.build_dsp(
        _table(dspeed_tpu.lh5, wf, bl), dsp_config=cfg, database=DB_FLAT,
    )
    return _columns(out, cfg["outputs"])


def test_timing_chain_table_matches_jax(events, jax_timing_columns):
    wf, bl, amp = events
    cfg = _timing_config()
    out = dspeed_tpu_torch.build_dsp(
        _table(dspeed_tpu_torch.lh5, wf, bl), dsp_config=cfg,
        database=DB_FLAT, device="cpu",
    )
    got = _columns(out, cfg["outputs"])
    _assert_timing_columns(got, jax_timing_columns)
    # the NaN rows poison every column; the good events find their t0
    for k, v in got.items():
        assert np.isnan(v[3]), k
    tp0 = got["tp_0_est"]
    assert np.isfinite(tp0[[i for i in range(len(tp0)) if i not in (3, 5)]]).all()


def test_timing_chain_file_matches_jax(events, jax_timing_columns, tmp_path):
    wf, bl, _ = events
    raw = str(tmp_path / "timing_raw.lh5")
    dspeed_tpu_torch.lh5.write(_table(dspeed_tpu_torch.lh5, wf, bl), "geds/raw", raw)
    db = {"geds": DB_FLAT}
    cfg = _timing_config()
    out_t = str(tmp_path / "timing_dsp_torch.lh5")
    out_j = str(tmp_path / "timing_dsp_jax.lh5")
    # three chunks, the last one short
    dspeed_tpu_torch.build_dsp(raw, out_t, cfg, database=db, device="cpu",
                               buffer_len=12)
    dspeed_tpu.build_dsp(raw, out_j, cfg, database=db)
    with h5py.File(out_t, "r") as ft, h5py.File(out_j, "r") as fj:
        got = {k: ft[f"geds/dsp/{k}"][()] for k in cfg["outputs"]}
        want = {k: fj[f"geds/dsp/{k}"][()] for k in cfg["outputs"]}
        for k in cfg["outputs"]:
            assert dict(ft[f"geds/dsp/{k}"].attrs) == dict(fj[f"geds/dsp/{k}"].attrs), k
    _assert_timing_columns(got, want)
    _assert_timing_columns(got, jax_timing_columns)


def _f64_conv_columns(wf, bl):
    """CUSP/ZAC maxima and pickoffs from a float64 evaluation of the same
    'valid' convolutions of the same float32 ``wf_blsub[:1996]``, with the
    chain's own filter arrays."""
    chain, _, _ = torch_build_chain(
        _energy_config(), _table(dspeed_tpu_torch.lh5, wf[:2], bl[:2]),
        db_dict=DB_FLAT, device="cpu",
    )
    x = (wf - bl[:, None]).astype(np.float32)[:, :1996].astype(np.float64)
    cols = {}
    for name in ("cusp", "zac"):
        k = np.asarray(chain._vars_dict[f"{name}_kernel"].const_value, np.float64)
        conv = np.stack([np.convolve(r, k, "valid") for r in x])
        cols[f"{name}Emax"] = conv.max(axis=1)
        cols[f"{name}Eftp"] = conv[:, 50]
    return cols


@pytest.mark.parametrize("config", ["energy", "timing", "flagship"])
def test_chain_meets_golden_replay_tolerance(config):
    """Every column the port reproduces at the golden replay's own tolerance
    (rtol 1e-9, atol 1e-12; index columns exact); the four CUSP/ZAC columns
    within CONV_GAP of column scale, and both they and the golden within
    CONV_GAP of a float64 evaluation: the gap is the two libraries' float32
    summation order, not a fault of either."""
    golden = np.load(GOLDEN)
    wf, bl, _ = _events(n=32, nan_rows=False)  # tools/make_goldens.py:35
    cfg = {"energy": _energy_config, "timing": _timing_config,
           "flagship": flagship_config}[config]()
    out = dspeed_tpu_torch.build_dsp(
        _table(dspeed_tpu_torch.lh5, wf, bl), dsp_config=cfg,
        database=DB_FLAT, device="cpu",
    )
    got = _columns(out, cfg["outputs"])
    f64 = _f64_conv_columns(wf, bl)
    gaps = {}
    for k in cfg["outputs"]:
        g, w = np.asarray(got[k]), golden[k]
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if k.startswith("tp_"):
            np.testing.assert_array_equal(g, w, err_msg=k)
        elif k in CONV_COLUMNS:
            scale = np.abs(w).max()
            gaps[k] = np.abs(g.astype(np.float64) - w).max() / scale
            assert gaps[k] <= CONV_GAP, (k, gaps[k])
            for what, v in (("port", g), ("golden", w)):
                off = np.abs(v.astype(np.float64) - f64[k]).max() / scale
                assert off <= CONV_GAP, (k, what, off)
        else:
            np.testing.assert_allclose(
                g, w, rtol=1e-9, atol=1e-12, equal_nan=True, err_msg=k
            )
    print(f"{config}: CUSP/ZAC gap to the golden, |port - golden| / max|col|: "
          + ", ".join(f"{k} {v:.2e}" for k, v in gaps.items()))


CONV_ORDERS = {
    # the port's route: the padded row's window unfolded, one batched product
    "port": lambda w, A, k, lo, p: tconv._conv_banded_matmul(w, k, lo, p),
    "matmul": lambda w, A, k, lo, p: w @ A,
    "transposed": lambda w, A, k, lo, p: (A.T @ w.T).T,
    "rows_vm": lambda w, A, k, lo, p: torch.stack([r @ A for r in w]),
    "rows_mv": lambda w, A, k, lo, p: torch.stack([A.T.contiguous() @ r for r in w]),
    "einsum": lambda w, A, k, lo, p: torch.einsum("bs,si->bi", w, A),
    "numpy": lambda w, A, k, lo, p: torch.from_numpy(w.numpy() @ A.numpy()),
    "f64_rounded": lambda w, A, k, lo, p: (w.double() @ A.double()).float(),
    "sequential": lambda w, A, k, lo, p: torch.from_numpy(
        np.add.reduce(w.numpy()[:, :, None] * A.numpy()[None], axis=1,
                      dtype=np.float32)
    ),
}


@pytest.mark.parametrize("order", sorted(CONV_ORDERS))
def test_cusp_banded_product_orders_against_xla(order):
    """Arrangements of the CUSP filter's float32 banded product on the
    golden's inputs, with the band matrix laid out as ``_band_matrix`` lays
    it out, against XLA:CPU's product (the golden's): each agrees within
    CONV_GAP of scale. Prints how many outputs are bit-identical; the
    ROADMAP §3 known difference records that none reproduces XLA's bits."""
    import jax.numpy as jnp
    from dspeed_tpu.processors import convolutions as jconv

    wf, bl, _ = _events(n=32, nan_rows=False)
    chain, _, _ = torch_build_chain(
        _energy_config(), _table(dspeed_tpu_torch.lh5, wf[:2], bl[:2]),
        db_dict=DB_FLAT, device="cpu",
    )
    k = np.asarray(chain._vars_dict["cusp_kernel"].const_value)
    x = (wf - bl[:, None]).astype(np.float32)[:, :1996]
    m = k.shape[-1]
    lo, p = m - 1, 1996 - m + 1
    want = np.asarray(jconv._conv_banded_matmul(jnp.asarray(x), k, lo, p))
    A = torch.from_numpy(tconv._band_matrix([k], p).astype(np.float32))
    got = CONV_ORDERS[order](torch.from_numpy(x), A, k, lo, p).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    gap = np.abs(got.astype(np.float64) - want).max() / np.abs(want).max()
    print(f"{order}: max |torch - xla| / max|xla| {gap:.2e}, bit-identical "
          f"outputs {np.mean(got == want):.1%}")
    assert gap <= CONV_GAP


def test_timing_fusion_pass_matches_jax(monkeypatch, events):
    jc, tc = _chains(monkeypatch, events, _timing_config())
    assert _kinds(tc) == _kinds(jc)
    assert len(tc._steps) == 67
    applied = tc.optimize_fusions()
    assert applied == jc.optimize_fusions() == TIMING_FUSIONS
    assert _kinds(tc) == _kinds(jc)
    assert len(tc._steps) == 35
    kernels = [k for _, k in _kinds(tc) if k]
    # the t0 front takes the conv's slot; the cascade, which reads tp_0_est,
    # and tp_0_atrap's mask search, which reads tp_start, come after it
    assert kernels.index("fused_t0_front") < kernels.index("chained_time_point_thresh")
    assert kernels.index("fused_t0_front") < kernels.index("tp_from_cross_mask")
    assert kernels.count("fused_energy_front") == 1


def test_timing_unfused_chain_matches_fused(events):
    wf, bl, _ = events
    cfg = _timing_config()
    kw = dict(dsp_config=cfg, database=DB_FLAT, device="cpu")
    tb = _table(dspeed_tpu_torch.lh5, wf, bl)
    fused = _columns(dspeed_tpu_torch.build_dsp(tb, fuse=True, **kw), cfg["outputs"])
    unfused = _columns(dspeed_tpu_torch.build_dsp(tb, fuse=False, **kw), cfg["outputs"])
    assert _assert_timing_columns(unfused, fused) == 0
    for k in cfg["outputs"]:
        np.testing.assert_array_equal(unfused[k], fused[k], err_msg=k)


def _orphan_trap_config():
    """The JAX package's orphan-trap chain (``tests/processors/
    test_pallas.py:738``): a t0 front and a pileup trapezoid with its own
    backward search, and no energy front to claim the trap."""
    return {
        "outputs": ["tp_0_est", "tp_0_atrap"],
        "processors": {
            "t0_kernel": {
                "function": "t0_filter",
                "module": "dspeed_tpu.processors",
                "args": [
                    "8*ns/waveform.period", "128*ns/waveform.period",
                    "t0_kernel(round((8*ns+128*ns)/waveform.period), 'f')",
                ],
            },
            "wf_t0f": {
                "function": "convolve_wf",
                "module": "dspeed_tpu.processors",
                "args": [
                    "waveform", "t0_kernel", "'s'",
                    "wf_t0f(len(waveform), 'f', grid=waveform.grid)",
                ],
            },
            "conv_tmin, tp_start, conv_min, conv_max": {
                "function": "min_max",
                "module": "dspeed_tpu.processors",
                "args": ["wf_t0f", "conv_tmin", "tp_start", "conv_min", "conv_max"],
            },
            "tp_0_est": {
                "function": "time_point_thresh",
                "module": "dspeed_tpu.processors",
                "args": ["wf_t0f", "thr", "tp_start", 0, "tp_0_est"],
            },
            "wf_atr": {
                "function": "asym_trap_filter",
                "module": "dspeed_tpu.processors",
                "args": ["waveform", "8", "4", "32", "wf_atr"],
            },
            "tp_0_atrap": {
                "function": "time_point_thresh",
                "module": "dspeed_tpu.processors",
                "args": ["wf_atr", "thr", "tp_start", 0, "tp_0_atrap"],
            },
        },
    }


def test_t0_front_claims_orphan_trap_search(monkeypatch):
    rng = np.random.default_rng(7)
    wf = np.cumsum(rng.normal(0.2, 1.0, (16, 512)), axis=1).astype("float32")
    wf[4, 100] = np.nan
    thr = np.full(16, 0.4, "float32")  # the JAX test's 1.5 is crossed rarely

    def table(lh5):
        return lh5.Table({
            "waveform": lh5.WaveformTable(
                values=wf, t0=0.0, t0_units="ns", dt=16.0, dt_units="ns"
            ),
            "thr": lh5.Array(thr),
        })

    cfg = _orphan_trap_config()
    monkeypatch.setenv("DSPEED_TPU_FUSE", "0")
    jc, _, _ = jax_build_chain(cfg, table(dspeed_tpu.lh5))
    tc, _, _ = torch_build_chain(cfg, table(dspeed_tpu_torch.lh5), device="cpu",
                                 fuse=False)
    applied = tc.optimize_fusions()
    assert applied == jc.optimize_fusions()
    front = [s for s in tc._steps if "fused_t0_front" in str(s)]
    assert len(front) == 1
    assert any(o.key.startswith("tp_0_atrap") for o in front[0].out_specs)
    kw = dict(dsp_config=cfg, device="cpu")
    fused = dspeed_tpu_torch.build_dsp(table(dspeed_tpu_torch.lh5), fuse=True, **kw)
    unfused = dspeed_tpu_torch.build_dsp(table(dspeed_tpu_torch.lh5), fuse=False, **kw)
    for k in cfg["outputs"]:
        f, u = np.asarray(fused[k].nda), np.asarray(unfused[k].nda)
        np.testing.assert_array_equal(f, u, err_msg=k)
        assert np.isnan(f[4]) and np.isfinite(f).sum() >= 4, k


# ---------------------------------------------------------------------------
# the flagship configuration: the whole chain, A/E included

FLAGSHIP_FUSIONS = [
    "cse[trap_norm]", "cse[amax]", "cse[wf_blsub[:1996]]",
    "fused_energy_front[2+1m]", "chained_time_point_thresh[9]",
    "fused_current_front", "fused_t0_front", "fused_conv_bank[2]",
    "badrow:fused_t0_front", "badrow:chained_time_point_thresh",
    "badrow:fixed_time_pickoff", "badrow:fixed_time_pickoff",
    "badrow:fused_conv_bank", "badrow:fixed_time_pickoff",
    "badrow:fixed_time_pickoff",
]


@pytest.fixture(scope="module")
def jax_flagship_columns(events):
    wf, bl, _ = events
    cfg = flagship_config()
    out = dspeed_tpu.build_dsp(
        _table(dspeed_tpu.lh5, wf, bl), dsp_config=cfg, database=DB_FLAT,
    )
    return _columns(out, cfg["outputs"])


def test_flagship_chain_table_matches_jax(events, jax_flagship_columns):
    wf, bl, _ = events
    cfg = flagship_config()
    out = dspeed_tpu_torch.build_dsp(
        _table(dspeed_tpu_torch.lh5, wf, bl), dsp_config=cfg,
        database=DB_FLAT, device="cpu",
    )
    got = _columns(out, cfg["outputs"])
    _assert_timing_columns(got, jax_flagship_columns)
    for k, v in got.items():
        assert np.isnan(v[3]), k
    good = [i for i in range(len(v)) if i not in (3, 5)]
    for k in AOE:
        assert np.isfinite(got[k][good]).all(), k
        # the current's maximum lies inside the rise, after tp_0_est
        if k == "tp_aoe_samp":
            assert (got[k][good] > got["tp_0_est"][good]).all()


def test_flagship_chain_file_matches_jax(events, jax_flagship_columns, tmp_path):
    wf, bl, _ = events
    raw = str(tmp_path / "flagship_raw.lh5")
    dspeed_tpu_torch.lh5.write(_table(dspeed_tpu_torch.lh5, wf, bl), "geds/raw", raw)
    db = {"geds": DB_FLAT}
    cfg = flagship_config()
    out_t = str(tmp_path / "flagship_dsp_torch.lh5")
    out_j = str(tmp_path / "flagship_dsp_jax.lh5")
    # three chunks, the last one short
    dspeed_tpu_torch.build_dsp(raw, out_t, cfg, database=db, device="cpu",
                               buffer_len=12)
    dspeed_tpu.build_dsp(raw, out_j, cfg, database=db)
    with h5py.File(out_t, "r") as ft, h5py.File(out_j, "r") as fj:
        got = {k: ft[f"geds/dsp/{k}"][()] for k in cfg["outputs"]}
        want = {k: fj[f"geds/dsp/{k}"][()] for k in cfg["outputs"]}
        for k in cfg["outputs"]:
            assert dict(ft[f"geds/dsp/{k}"].attrs) == dict(fj[f"geds/dsp/{k}"].attrs), k
    _assert_timing_columns(got, want)
    _assert_timing_columns(got, jax_flagship_columns)


def test_flagship_fusion_pass_matches_jax(monkeypatch, events):
    jc, tc = _chains(monkeypatch, events, flagship_config())
    assert _kinds(tc) == _kinds(jc)
    assert len(tc._steps) == 76
    applied = tc.optimize_fusions()
    assert applied == jc.optimize_fusions() == FLAGSHIP_FUSIONS
    assert _kinds(tc) == _kinds(jc)
    assert len(tc._steps) == 40
    kernels = [k for _, k in _kinds(tc) if k]
    for gone in ("windower", "avg_current", "upsampler", "moving_window_multi"):
        assert gone not in kernels
    # the t0 front writes the current the current front reads
    assert kernels.index("fused_t0_front") < kernels.index("fused_current_front")
    front = next(s for s in tc._steps if "fused_t0_front" in str(s))
    assert [o.key for o in front.out_specs][5].startswith("curr")
    cur = next(s for s in tc._steps if "fused_current_front" in str(s))
    jcur = next(s for s in jc._steps if "fused_current_front" in str(s))
    assert str(cur) == str(jcur)
    # aoe_t_min and A_min have no readers: the minimum is elided
    reads = tc._env_read_counts()
    assert tuple(reads.get(o.key, 0) > 0 for o in cur.out_specs) == (
        False, True, False, True
    )


def test_flagship_unfused_chain_matches_fused(events):
    wf, bl, _ = events
    cfg = flagship_config()
    kw = dict(dsp_config=cfg, database=DB_FLAT, device="cpu")
    tb = _table(dspeed_tpu_torch.lh5, wf, bl)
    fused = _columns(dspeed_tpu_torch.build_dsp(tb, fuse=True, **kw), cfg["outputs"])
    unfused = _columns(dspeed_tpu_torch.build_dsp(tb, fuse=False, **kw), cfg["outputs"])
    for k in cfg["outputs"]:
        np.testing.assert_array_equal(unfused[k], fused[k], err_msg=k)


# the flagship with its A/E smoothing window at 128 upsampled samples, a
# geometry the polyphase plan rejects: the current front takes the
# up-domain route (K6 on the card)


def _l128_config():
    cfg = flagship_config()
    cfg["processors"]["curr_av"]["args"][1] = "128"
    return cfg


def test_flagship_l128_chain_takes_the_updomain_front(monkeypatch, events):
    from dspeed_tpu.processors import _pallas

    from dspeed_tpu_torch.processors._poly_plan import poly_plan

    cfg = _l128_config()
    jc, tc = _chains(monkeypatch, events, cfg)
    applied = tc.optimize_fusions()
    assert applied == jc.optimize_fusions() == FLAGSHIP_FUSIONS
    cur = next(s for s in tc._steps if "fused_current_front" in str(s))
    jcur = next(s for s in jc._steps if "fused_current_front" in str(s))
    assert str(cur) == str(jcur)
    # the current of 300 samples, x16 to 4784, three 128-sample windows: no
    # polyphase plan in either package
    geometry = (300, 16, 8, 4784, 128, 3, 0)
    assert poly_plan(*geometry) is None
    assert _pallas._poly_plan(*geometry) is None
    monkeypatch.delenv("DSPEED_TPU_FUSE")
    wf, bl, _ = events
    got = _columns(dspeed_tpu_torch.build_dsp(
        _table(dspeed_tpu_torch.lh5, wf, bl), dsp_config=cfg, database=DB_FLAT,
        device="cpu",
    ), cfg["outputs"])
    want = _columns(dspeed_tpu.build_dsp(
        _table(dspeed_tpu.lh5, wf, bl), dsp_config=cfg, database=DB_FLAT,
    ), cfg["outputs"])
    _assert_timing_columns(got, want)
    good = [i for i in range(len(wf)) if i not in (3, 5)]
    for k in AOE:
        assert np.isfinite(got[k][good]).all(), k
    # the wider window smooths the current's peak: below the 48-sample one's
    base = _columns(dspeed_tpu_torch.build_dsp(
        _table(dspeed_tpu_torch.lh5, wf, bl), dsp_config=flagship_config(),
        database=DB_FLAT, device="cpu",
    ), ["A_max"])
    assert (got["A_max"][good] < base["A_max"][good]).all()


# ---------------------------------------------------------------------------
# the error contract: a DSPFatal carries the entries it was thrown on

# a trapezoid wider than the 4096-sample waveform raises in its chunk
WIDE_TRAP_CONFIG = {
    "outputs": ["trapE"],
    "processors": {
        "wf_blsub": {
            "function": "bl_subtract", "module": "dspeed_tpu.processors",
            "args": ["waveform", "baseline", "wf_blsub"], "unit": "ADC",
        },
        "wf_trap": {
            "function": "trap_norm", "module": "dspeed_tpu.processors",
            "args": ["wf_blsub", 3000, 3000, "wf_trap"], "unit": "ADC",
        },
        "trapE": {
            "function": "fixed_time_pickoff", "module": "dspeed_tpu.processors",
            "args": ["wf_trap", 100, "'i'", "trapE"], "unit": "ADC",
        },
    },
}


def _fatal(pkg, wf, bl, **kw):
    with pytest.raises(pkg.errors.DSPFatal) as err:
        pkg.build_dsp(_table(pkg.lh5, wf, bl), dsp_config=WIDE_TRAP_CONFIG, **kw)
    return err.value


@pytest.mark.parametrize("fuse", [True, False])
def test_dsp_fatal_carries_the_chunk_entries(fuse):
    wf, bl, _ = _events(n=16, nan_rows=False)
    want = _fatal(dspeed_tpu, wf, bl)
    got = _fatal(dspeed_tpu_torch, wf, bl, device="cpu", fuse=fuse)
    assert want.wf_range == got.wf_range == (0, 16)
    lines = str(got).splitlines()
    assert lines[:2] == str(want).splitlines()[:2] == [
        "The trapezoid width is wider than the waveform",
        "Thrown while processing entries (0, 16)",
    ]


# ---------------------------------------------------------------------------
# float64 waveforms: the hand patterns fuse them on the CPU, not on the card

HAND_PATTERNS = (
    "fused_energy_front", "chained_time_point_thresh", "fused_current_front",
    "fused_t0_front", "fused_conv_bank",
)


@pytest.mark.parametrize("device, dtype, fused", [
    ("cuda", "float32", True),
    ("cuda", "float64", False),
    ("cpu", "float32", True),
    ("cpu", "float64", True),
])
def test_hand_patterns_take_float64_planes_only_on_the_cpu(
    events, device, dtype, fused
):
    wf, bl, _ = events
    tc, _, _ = torch_build_chain(
        flagship_config(dtype),
        _table(dspeed_tpu_torch.lh5, wf.astype(dtype), bl.astype(dtype)),
        db_dict=DB_FLAT, device="cpu", fuse=False,
    )
    # the pass decides from the device's type and the planes' dtypes only,
    # so a CPU-built chain stands for one on the card
    tc.device = torch.device(device)
    blsub = next(s for s in tc._steps if tc._kname(s) == "bl_subtract")
    assert np.dtype(blsub.arg_specs[0].dtype) == dtype
    assert tc._hand_kernel_plane(blsub.arg_specs[0]) is fused
    applied = tc.optimize_fusions()
    hand = [a for a in applied if a.split("[")[0] in HAND_PATTERNS]
    want = [a for a in FLAGSHIP_FUSIONS if a.split("[")[0] in HAND_PATTERNS]
    assert hand == (want if fused else [])
    kernels = {k for _, k in _kinds(tc) if k}
    assert kernels.isdisjoint(HAND_PATTERNS) != fused
    if fused and dtype == "float32":
        assert applied == FLAGSHIP_FUSIONS
