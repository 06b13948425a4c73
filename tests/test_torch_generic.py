"""The port's generic fusion (``fuse="generic"``): ``_fuse_generic``,
``GroupStep``, the tape lowering (``processors/_tile_program.py``) and the
row-tape kernel K7 (``csrc/generic_rows.cu``) through its plain walk
``_cuda.generic_rows_plain``, against the JAX package's generic mode
(``DSPEED_TPU_FUSE=generic``) on the CPU.

- The flagship (``configs/hpge-energy-timing.yaml``) forms the JAX
  package's two groups (34 and 19 members, the same inputs and escapes);
  the default mode keeps its pattern fusions and forms no group.
- The generic flagship equals the port's unfused chain bit for bit, and
  meets the JAX package's generic flagship and the golden at the tolerances
  of ``tests/test_torch_chain.py``.
- Each op kind of the flagship's groups, lowered alone at 8 x 256, agrees
  with the Pallas ``generic_rows`` in interpret mode within rtol 2e-6 and
  atol 2e-5 (``tests/test_tile_safety.py:91-122``), NaN positions exact.
- A refused lowering bisects the group; a member with no op splits it.

- The barrier plan orders every hazard between ops (planes, their flag
  words, scalars, the scratch and the reduction buffers), and sits in
  record fields the block-per-op kernel never read.
- ``tests/test_torch_k7_emulation.py`` runs the kernel itself on the CPU
  under ThreadSanitizer and AddressSanitizer (``tools/k7_emu``).

The JAX package is imported inside the CPU tests only. The ``gpu`` tests
run K7 on both flagship groups at 512 rows against the plain walk
(``chip_smoke.k7_phase``), on each op kind alone, on the small chain at
batches of 37 and 1, on reductions back to back, at 1001 and 5000
samples, on NaN rows, infinite samples, flat tails and exact ties, and
check its launch:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_generic.py
"""

import os
import sys

import numpy as np
import pytest
import torch
import yaml

import dspeed_tpu_torch
from dspeed_tpu_torch.processing_chain import (
    GroupStep,
    build_processing_chain as torch_build_chain,
)
from dspeed_tpu_torch.processors import _cuda, _tile_program


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
DB_FLAT = {"pz": {"tau": 27460.5}}
TILE_TOL = dict(rtol=2e-6, atol=2e-5)


def _flagship():
    with open(CONFIG) as f:
        return yaml.safe_load(f)


def _table(lh5, wf, bl):
    return lh5.Table({
        "waveform": lh5.WaveformTable(
            values=wf, t0=0.0, t0_units="ns", dt=16.0, dt_units="ns"
        ),
        "baseline": lh5.Array(bl),
    })


def _events(n=32, nsamp=4096, seed=11):
    """HPGe pulses (the generator of ``tests/test_build_dsp.py``, scaled to
    ``nsamp``), row 3 with a NaN sample and row 5 with a NaN baseline."""
    rng = np.random.default_rng(seed)
    tau = 27460.5 if nsamp == 4096 else 500.0
    amp = rng.uniform(500, 30000, n)
    t0 = rng.integers(950, 1050, n) if nsamp == 4096 else rng.integers(60, 100, n)
    rt = rng.integers(40, 150, n) if nsamp == 4096 else rng.integers(10, 40, n)
    bl = rng.uniform(14000, 16000, n)
    t = np.arange(nsamp)[None, :]
    rise = np.clip((t - t0[:, None]) / rt[:, None], 0, 1)
    decay = np.where(t > t0[:, None] + rt[:, None],
                     np.exp(-(t - t0[:, None] - rt[:, None]) / tau), 1.0)
    wf = (bl[:, None] + amp[:, None] * rise * decay
          + rng.normal(0, 3, (n, nsamp))).astype("float32")
    bl = bl.astype("float32")
    wf[3, nsamp // 8] = np.nan
    bl[5] = np.nan
    return wf, bl


def _kinds(steps):
    return [
        (type(s).__name__,
         s.kernel.__name__ if hasattr(s, "kernel") else getattr(s, "name", ""))
        for s in steps
    ]


def _groups(chain):
    return [s for s in chain._steps if isinstance(s, GroupStep)]


@pytest.fixture(scope="module")
def flagship_events():
    return _events()


# ---------------------------------------------------------------------------
# the groups


def test_generic_groups_match_jax(monkeypatch, flagship_events):
    import itertools

    from dspeed_tpu import lh5 as jlh5
    from dspeed_tpu.processing_chain import GroupStep as JaxGroupStep
    from dspeed_tpu.processing_chain import ProcChainVar as JaxVar
    from dspeed_tpu.processing_chain import build_processing_chain as jax_build
    from dspeed_tpu_torch.processing_chain import ProcChainVar as TorchVar

    wf, bl = flagship_events
    monkeypatch.setenv("DSPEED_TPU_FUSE", "generic")
    # both packages number their variables from one count per process: start
    # both here, whatever chains the process built before this test
    monkeypatch.setattr(JaxVar, "_counter", itertools.count())
    monkeypatch.setattr(TorchVar, "_counter", itertools.count())
    jc, _, _ = jax_build(_flagship(), _table(jlh5, wf, bl), db_dict=DB_FLAT)
    tc, _, _ = torch_build_chain(
        _flagship(), _table(dspeed_tpu_torch.lh5, wf, bl), db_dict=DB_FLAT,
        device="cpu", fuse="generic",
    )
    jg = [s for s in jc._steps if isinstance(s, JaxGroupStep)]
    tg = _groups(tc)
    assert [len(g.members) for g in tg] == [len(g.members) for g in jg] == [34, 19]
    assert len(tc._steps) == len(jc._steps) == 24
    for t, j in zip(tg, jg):
        assert _kinds(t.members) == _kinds(j.members)
        assert t.ext_in == j.ext_in
        assert t.escapes == j.escapes
    assert [k.split("#")[0] for k in tg[0].ext_in] == ["baseline", "waveform",
                                                      "waveform_dt"]
    assert len(tg[0].escapes) == 27 and len(tg[1].escapes) == 9
    # the CUSP/ZAC convolutions stay outside, after the second group
    kinds = _kinds(tc._steps)
    up = kinds.index(("KernelStep", "upsampler"))
    assert [k[0] for k in kinds[: up + 2]] == ["GroupStep", "KernelStep", "GroupStep"]
    assert ("KernelStep", "fft_convolve_wf") in kinds[up + 2 :]


@pytest.mark.parametrize("cut, n_steps", [("energy", 11), ("timing", 35),
                                          ("flagship", 40)])
def test_default_mode_forms_no_group(monkeypatch, flagship_events, cut, n_steps):
    from dspeed_tpu import lh5 as jlh5
    from dspeed_tpu.processing_chain import build_processing_chain as jax_build

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_torch_chain import _energy_config, _timing_config

    cfg = {"energy": _energy_config, "timing": _timing_config,
           "flagship": _flagship}[cut]()
    wf, bl = flagship_events
    monkeypatch.setenv("DSPEED_TPU_FUSE", "0")
    jc, _, _ = jax_build(cfg, _table(jlh5, wf, bl), db_dict=DB_FLAT)
    tc, _, _ = torch_build_chain(
        cfg, _table(dspeed_tpu_torch.lh5, wf, bl), db_dict=DB_FLAT,
        device="cpu", fuse=False,
    )
    applied = tc.optimize_fusions()
    assert applied == jc.optimize_fusions()
    assert not any(a.startswith("fusion_group") for a in applied)
    assert len(tc._steps) == n_steps and not _groups(tc)


def test_fuse_takes_true_false_or_generic():
    with pytest.raises(ValueError, match="fuse"):
        torch_build_chain(_flagship(), None, device="cpu", fuse="patterns")


# ---------------------------------------------------------------------------
# the whole chain


def _columns(out, outputs):
    return {k: np.asarray(out[k].nda) for k in outputs}


def _run(wf, bl, fuse, cfg=None):
    cfg = _flagship() if cfg is None else cfg
    out = dspeed_tpu_torch.build_dsp(
        _table(dspeed_tpu_torch.lh5, wf, bl), dsp_config=cfg,
        database=DB_FLAT, device="cpu", fuse=fuse,
    )
    return _columns(out, cfg["outputs"])


def test_generic_chain_equals_unfused(flagship_events):
    wf, bl = flagship_events
    _tile_program.reset_splits()
    generic = _run(wf, bl, "generic")
    assert _tile_program.SPLITS == {}
    unfused = _run(wf, bl, False)
    for k in generic:
        np.testing.assert_array_equal(generic[k], unfused[k], err_msg=k)


def test_generic_chain_matches_jax_generic(monkeypatch, flagship_events):
    import dspeed_tpu

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_torch_chain import _assert_timing_columns

    wf, bl = flagship_events
    monkeypatch.setenv("DSPEED_TPU_FUSE", "generic")
    cfg = _flagship()
    want = _columns(dspeed_tpu.build_dsp(
        _table(dspeed_tpu.lh5, wf, bl), dsp_config=cfg, database=DB_FLAT,
    ), cfg["outputs"])
    got = _run(wf, bl, "generic")
    _assert_timing_columns(got, want)
    for k, v in got.items():
        assert np.isnan(v[3]), k


def test_generic_chain_meets_golden():
    """The golden replay's tolerance (rtol 1e-9, atol 1e-12, index columns
    exact); the CUSP/ZAC columns within the known summation-order gap
    (``test_torch_chain.CONV_GAP``, ROADMAP §3)."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_build_dsp import make_hpge_waveforms
    from test_torch_chain import CONV_COLUMNS, CONV_GAP, GOLDEN

    golden = np.load(GOLDEN)
    wf, _amp, _t0, bl = make_hpge_waveforms(n=32)  # tools/make_goldens.py:35
    got = _run(wf, bl.astype("float32"), "generic")
    for k, g in got.items():
        w = golden[k]
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if k.startswith("tp_"):
            np.testing.assert_array_equal(g, w, err_msg=k)
        elif k in CONV_COLUMNS:
            gap = np.abs(g.astype(np.float64) - w).max() / np.abs(w).max()
            assert gap <= CONV_GAP, (k, gap)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-12,
                                       equal_nan=True, err_msg=k)


def test_generic_group_bisects_on_refused_lowering(monkeypatch):
    """Mirror of ``tests/test_fusion.py:501-540``: the whole group's lowering
    is refused once; its halves lower and run, and the outputs do not
    change."""
    wf, bl = _events(n=8)
    calls = []
    orig = _tile_program.lower

    def flaky(members, vals, escapes):
        calls.append(len(members))
        if len(calls) == 1:
            raise _tile_program.LoweringError("refused for the test")
        return orig(members, vals, escapes)

    monkeypatch.setattr(_tile_program, "lower", flaky)
    _tile_program.reset_splits()
    got = _run(wf, bl, "generic")
    assert calls[:3] == [34, 17, 17], calls
    assert _tile_program.SPLITS == {"refused for the test": 1}
    monkeypatch.setattr(_tile_program, "lower", orig)
    want = _run(wf, bl, False)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# each op kind, lowered alone, against the Pallas generic_rows

N_OPS = 256
OPS_CONFIG = {
    "outputs": [
        "tp_min", "wf_max", "bl_mean", "bl_std", "bl_slope", "trapTmax",
        "tp_0_est", "tp_0_atrap", "tp_50", "tp_10", "QDrift", "dt_eff",
        "trapEftp", "ftp_i", "A_max", "tp_aoe_max", "tp_aoe_samp",
    ],
    "processors": {
        "tp_min, tp_max, wf_min, wf_max": {
            "function": "min_max", "module": "dspeed_tpu.processors",
            "args": ["waveform", "tp_min", "tp_max", "wf_min", "wf_max"],
            "unit": ["ns", "ns", "ADC", "ADC"],
        },
        "wf_blsub": {
            "function": "bl_subtract", "module": "dspeed_tpu.processors",
            "args": ["waveform", "baseline", "wf_blsub(unit='ADC')"],
        },
        "bl_mean, bl_std, bl_slope, bl_intercept": {
            "function": "linear_slope_fit", "module": "dspeed_tpu.processors",
            "args": ["wf_blsub[0:50]", "bl_mean", "bl_std", "bl_slope",
                     "bl_intercept"],
            "unit": ["ADC", "ADC", "ADC", "ADC"],
        },
        "wf_pz": {
            "function": "pole_zero", "module": "dspeed_tpu.processors",
            "args": ["wf_blsub", "500.0", "wf_pz"], "unit": "ADC",
        },
        "t0_kernel": {
            "function": "t0_filter", "module": "dspeed_tpu.processors",
            "args": ["128*ns/wf_pz.period", "512*ns/wf_pz.period",
                     "t0_kernel(round((128*ns+512*ns)/wf_pz.period), 'f')"],
            "unit": "ADC",
        },
        "wf_t0_filter": {
            "function": "convolve_wf", "module": "dspeed_tpu.processors",
            "args": ["wf_pz", "t0_kernel", "'s'",
                     "wf_t0_filter(len(wf_pz), 'f', grid=wf_pz.grid)"],
            "unit": "ADC",
        },
        "wf_atrap": {
            "function": "asym_trap_filter", "module": "dspeed_tpu.processors",
            "args": ["wf_pz", "128*ns", "4", "512*ns", "wf_atrap"], "unit": "ADC",
        },
        "conv_tmin, tp_start, conv_min, conv_max": {
            "function": "min_max", "module": "dspeed_tpu.processors",
            "args": ["wf_t0_filter", "conv_tmin", "tp_start", "conv_min", "conv_max"],
            "unit": ["ns", "ns", "ADC", "ADC"],
        },
        "tp_0_atrap": {
            "function": "time_point_thresh", "module": "dspeed_tpu.processors",
            "args": ["wf_atrap", "bl_std", "tp_start", 0, "tp_0_atrap"], "unit": "ns",
        },
        "tp_0_est": {
            "function": "time_point_thresh", "module": "dspeed_tpu.processors",
            "args": ["wf_t0_filter", "bl_std", "tp_start", 0, "tp_0_est(unit=ns)"],
            "unit": "ns",
        },
        "wf_trap": {
            "function": "trap_norm", "module": "dspeed_tpu.processors",
            "args": ["wf_pz", "320*ns", "160*ns", "wf_trap"], "unit": "ADC",
        },
        "trapTmax": {
            "function": "amax", "module": "numpy", "args": ["wf_trap", 1, "trapTmax"],
            "kwargs": {"signature": "(n),()->()", "types": ["fi->f"]}, "unit": "ADC",
        },
        "tp_50": {
            "function": "time_point_thresh", "module": "dspeed_tpu.processors",
            "args": ["wf_pz", "trapTmax*0.5", "tp_0_est", 1, "tp_50"], "unit": "ns",
        },
        "tp_10": {
            "function": "time_point_thresh", "module": "dspeed_tpu.processors",
            "args": ["wf_pz", "0.1*trapTmax", "tp_50", 0, "tp_10"], "unit": "ns",
        },
        "trapQftp": {
            "function": "fixed_time_pickoff", "module": "dspeed_tpu.processors",
            "args": ["wf_trap", "tp_0_est + 480*ns", "'l'", "trapQftp"], "unit": "ADC",
        },
        "QDrift": "trapQftp * 16",
        "dt_eff": {"function": "QDrift/trapTmax", "unit": "ns"},
        "trapEftp": {
            "function": "fixed_time_pickoff", "module": "dspeed_tpu.processors",
            "args": ["wf_trap", "round(tp_0_est+320*ns+128*ns, wf_trap.grid)",
                     "'l'", "trapEftp"],
            "unit": "ADC",
        },
        "ftp_i": {
            "function": "fixed_time_pickoff", "module": "dspeed_tpu.processors",
            "args": ["wf_trap", "100", "'i'", "ftp_i"], "unit": "ADC",
        },
        "wf_le": {
            "function": "windower", "module": "dspeed_tpu.processors",
            "args": ["wf_pz", "tp_0_est", "wf_le(61, 'f')"], "unit": "ADC",
        },
        "curr": {
            "function": "avg_current", "module": "dspeed_tpu.processors",
            "args": ["wf_le", 1, "curr(len(wf_le)-1, 'f')"], "unit": "ADC/sample",
        },
        "curr_av": {
            "function": "moving_window_multi", "module": "dspeed_tpu.processors",
            "args": ["curr", "8", 3, 0, "curr_av"], "unit": "ADC/sample",
        },
        "aoe_t_min, tp_aoe_max, A_min, A_max": {
            "function": "min_max", "module": "dspeed_tpu.processors",
            "args": ["curr_av", "aoe_t_min", "tp_aoe_max", "A_min", "A_max"],
            "unit": ["ns", "ns", "ADC/sample", "ADC/sample"],
        },
        "tp_aoe_samp": {
            "function": "add", "module": "numpy",
            "args": ["tp_0_est", "tp_aoe_max/16", "tp_aoe_samp"], "unit": "ns",
        },
    },
}
# op kind -> how to find its steps in the unfused chain
OP_CASES = {
    "min_max": "min_max", "bl_subtract": "bl_subtract",
    "linear_slope_fit": "linear_slope_fit", "pole_zero": "pole_zero",
    "trap_norm": "trap_norm", "asym_trap_filter": "asym_trap_filter",
    "amax": "amax", "convolve_wf": "convolve_wf",
    "time_point_thresh": "time_point_thresh", "windower": "windower",
    "avg_current": "avg_current", "moving_window_multi": "moving_window_multi",
    "fixed_time_pickoff": "fixed_time_pickoff", "add": "add",
    "multiply": "multiply", "divide": "divide", "convert": "convert",
    "convert_round": "convert_round",
}


_AMAX = {"function": "amax", "module": "numpy", "unit": "ADC",
         "kwargs": {"signature": "(n),()->()", "types": ["fi->f"]}}


def _fit(src, p):
    return {"function": "linear_slope_fit", "module": "dspeed_tpu.processors",
            "args": [src] + [f"{p}_{q}" for q in ("mean", "std", "slope", "icpt")],
            "unit": ["ADC"] * 4}


def _min_max(src, p):
    return {"function": "min_max", "module": "dspeed_tpu.processors",
            "args": [src] + [f"{p}_{q}" for q in ("tmin", "tmax", "min", "max")],
            "unit": ["ns", "ns", "ADC", "ADC"]}


# block reductions back to back, each reading a plane written before the
# one before it, so that the plan puts no barrier between them: two slope
# fits, two amaxes, two min_maxes, a fit after pole_zero's scan
RED_CONFIG = {
    "outputs": [f"{p}_{q}" for p in ("ba", "ta") for q in ("mean", "std", "slope", "icpt")]
    + [f"{p}_{q}" for p in ("ma", "mb") for q in ("tmin", "tmax", "min", "max")]
    + ["m_all", "m_mid", "wf_pz"] + [f"pa_{q}" for q in ("mean", "std", "slope", "icpt")]
    + ["m_pz"],
    "processors": {
        "wf_blsub": {"function": "bl_subtract", "module": "dspeed_tpu.processors",
                     "args": ["waveform", "baseline", "wf_blsub(unit='ADC')"]},
        "ba_mean, ba_std, ba_slope, ba_icpt": _fit("wf_blsub[0:50]", "ba"),
        "ta_mean, ta_std, ta_slope, ta_icpt": _fit("wf_blsub[150:256]", "ta"),
        "m_all": dict(_AMAX, args=["wf_blsub", 1, "m_all"]),
        "m_mid": dict(_AMAX, args=["wf_blsub[100:200]", 1, "m_mid"]),
        "ma_tmin, ma_tmax, ma_min, ma_max": _min_max("wf_blsub", "ma"),
        "mb_tmin, mb_tmax, mb_min, mb_max": _min_max("wf_blsub[0:128]", "mb"),
        "wf_pz": {"function": "pole_zero", "module": "dspeed_tpu.processors",
                  "args": ["wf_blsub", "500.0", "wf_pz"], "unit": "ADC"},
        "pa_mean, pa_std, pa_slope, pa_icpt": _fit("wf_blsub[50:100]", "pa"),
        "m_pz": dict(_AMAX, args=["wf_pz", 1, "m_pz"]),
    },
}


@pytest.fixture(scope="module")
def ops_chain():
    """The small op chain built unfused and run on the CPU: (chain, env)."""
    wf, bl = _events(n=8, nsamp=N_OPS, seed=5)
    wf[6, 200:] = wf[6, 199]  # a flat tail: searches that find nothing
    chain, _, _ = torch_build_chain(
        OPS_CONFIG, _table(dspeed_tpu_torch.lh5, wf, bl), device="cpu",
        fuse=False,
    )
    inputs, n = chain._gather_inputs(0, chain._buffer_len)
    env = chain._run_steps(chain._to_device(inputs))
    return chain, env


def _jax_call(step, jargs):
    """The JAX package's counterpart of a port step on the same arguments."""
    import jax.numpy as jnp

    import dspeed_tpu.processors as dp
    from dspeed_tpu.processors import unit_conversion as juc
    from dspeed_tpu_torch.processing_chain import ConvertStep

    if isinstance(step, ConvertStep):
        return getattr(juc, step.kernel.__name__)(*jargs)
    name = step.kernel.__name__
    if name == "amax":
        return (jnp.amax(jargs[0], axis=-1),)
    if name in ("add", "multiply", "divide"):
        return ({"add": jnp.add, "multiply": jnp.multiply,
                 "divide": jnp.true_divide}[name](*jargs),)
    kern = getattr(dp, name)
    if kern.uses_dims:
        return kern(*jargs, dims=step.dims)
    return kern(*jargs)


@pytest.mark.parametrize("kind", sorted(OP_CASES))
def test_op_plain_walk_matches_pallas_generic_rows(ops_chain, kind):
    import jax.numpy as jnp

    from dspeed_tpu.processors import _pallas
    from dspeed_tpu_torch.processing_chain import ConvertStep, KernelStep

    chain, env = ops_chain
    steps = [s for s in chain._steps
             if isinstance(s, (KernelStep, ConvertStep))
             and s.kernel.__name__ == OP_CASES[kind]]
    assert steps, kind
    for step in steps:
        reads = sorted(chain._step_env_reads(step))
        writes = ([sp.key for sp in step.out_specs] if isinstance(step, KernelStep)
                  else [step.out_key])
        vals = {k: env[k] for k in reads}
        prog = _tile_program.lower([step], vals, writes)
        assert len([op for op in prog.ops if op.code != 1]) == 1
        got = _cuda.generic_rows_plain(prog, vals)
        # the same call traced into one Pallas row-tile program
        op = next(op for op in prog.ops if op.code != 1)

        def body(jv, op=op, step=step):
            jargs = [
                jv[prog.slots[a[1]].key].astype(
                    {torch.float32: jnp.float32, torch.float64: jnp.float64}
                    .get(a[2], jv[prog.slots[a[1]].key].dtype))
                if a[0] == "slot" else a[1]
                for a in op.args
            ]
            outs = _jax_call(step, jargs)
            return dict(zip(writes, outs))

        jvals = {k: np.asarray(v) for k, v in vals.items()}
        core_nd = {k: v.ndim - 1 for k, v in jvals.items()}
        want = _pallas.generic_rows(body, jvals, core_nd, interpret=True)
        assert want is not None, f"{kind}: generic_rows declined"
        assert set(got) == set(want)
        for k in writes:
            a, b = got[k].numpy(), np.asarray(want[k])
            assert a.shape == b.shape, (k, a.shape, b.shape)
            np.testing.assert_array_equal(np.isnan(a), np.isnan(b),
                                          err_msg=f"{kind} {k}: NaN")
            tol = dict(TILE_TOL)
            if kind == "convolve_wf":
                # two float32 banded products summed in other orders (K4's
                # loop, XLA's in-tile dot): the known gap of 2e-6 of scale
                # (test_torch_chain.CONV_GAP), not the elementwise rule
                tol = dict(rtol=0, atol=2e-6 * np.nanmax(np.abs(b)))
            np.testing.assert_allclose(
                np.nan_to_num(a.astype(np.float64), nan=-12345.0),
                np.nan_to_num(b.astype(np.float64), nan=-12345.0),
                err_msg=f"{kind} {k}", **tol,
            )


def test_ops_chain_runs_as_one_group_equal_to_unfused():
    wf, bl = _events(n=8, nsamp=N_OPS, seed=5)
    cfg = OPS_CONFIG
    chain, _, _ = torch_build_chain(
        cfg, _table(dspeed_tpu_torch.lh5, wf, bl), device="cpu", fuse="generic"
    )
    assert len(_groups(chain)) == 1
    _tile_program.reset_splits()
    got = _run(wf, bl, "generic", cfg)
    assert _tile_program.SPLITS == {}
    want = _run(wf, bl, False, cfg)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# what K7 refuses


def test_member_with_no_op_raises_and_the_group_splits():
    """A member K7 has no tape for in the group: every tile-safe kernel has
    an op on float32 and float64 rows now (this was ``moving_window_left``
    before the plane ops), so the member is a ufunc from a float32 row into
    a float64 plane, a mix of plane types no program takes (a float64
    program takes float64 and bool planes). The lowering raises, the group
    splits, and the outputs equal the unfused chain's."""
    wf, bl = _events(n=8, nsamp=N_OPS, seed=5)
    cfg = {"outputs": OPS_CONFIG["outputs"] + ["mwl_max"],
           "processors": dict(OPS_CONFIG["processors"])}
    cfg["processors"]["wf_mwl"] = {
        "function": "multiply", "module": "numpy", "args": ["wf_pz", "0.5", "wf_mwl"],
        "kwargs": {"signature": "(),()->()", "types": ["dd->d"]}, "unit": "ADC",
    }
    cfg["processors"]["mwl_max"] = {
        "function": "amax", "module": "numpy", "args": ["wf_mwl", 1, "mwl_max"],
        "kwargs": {"signature": "(n),()->()", "types": ["di->d"]}, "unit": "ADC",
    }
    chain, _, _ = torch_build_chain(
        cfg, _table(dspeed_tpu_torch.lh5, wf, bl), device="cpu", fuse="generic"
    )
    (group,) = _groups(chain)
    step = next(m for m in group.members
                if getattr(getattr(m, "kernel", None), "__name__", "") == "multiply"
                and m.out_specs[0].shape)
    with pytest.raises(_tile_program.LoweringError,
                       match="float64 programs take float64 and bool planes"):
        _tile_program.lower([step], {step.arg_specs[0].key: torch.zeros(8, N_OPS)},
                            [step.out_specs[0].key])
    _tile_program.reset_splits()
    got = _run(wf, bl, "generic", cfg)
    assert any("float64 programs take float64 and bool planes" in k
               for k in _tile_program.SPLITS)
    want = _run(wf, bl, False, cfg)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_lowering_refuses_float64_planes_and_oversized_plans():
    """A float64 trapezoid too long for one block (12000 samples: two
    float64 planes and the prefix, 288 KB; in float32 it would fit in
    192 KB), and a plan over one block's shared memory (a trapezoid of a
    40000-sample row: two planes and a float64 prefix, 640 KB), raise at
    lowering."""
    cfg = {"outputs": ["trapTmax"], "processors": {
        k: OPS_CONFIG["processors"][k] for k in ("wf_trap", "trapTmax")}}
    cfg["processors"]["wf_trap"] = dict(cfg["processors"]["wf_trap"],
                                        args=["waveform", "320*ns", "160*ns", "wf_trap"])
    cfg["processors"]["trapTmax"] = dict(cfg["processors"]["trapTmax"], kwargs={
        "signature": "(n),()->()", "types": ["fi->f", "di->d"]})
    for n, dtype, match in ((12000, "float64", "shared memory"),
                            (40000, "float32", "shared memory")):
        wf = np.zeros((2, n), dtype)
        chain, _, _ = torch_build_chain(
            cfg, _table(dspeed_tpu_torch.lh5, wf, np.zeros(2, "float32")),
            device="cpu", fuse=False,
        )
        step = chain._steps[0]
        key = step.arg_specs[0].key
        with pytest.raises(_tile_program.LoweringError, match=match):
            _tile_program.lower([step], {key: torch.from_numpy(wf)},
                                [step.out_specs[0].key])


def test_plan_reuses_dead_planes(flagship_events):
    """Group A keeps at most two 4096-sample planes live at once: the raw
    row, the baseline-subtracted row and the traps share the space of the
    planes that died before them."""
    wf, bl = flagship_events
    chain, _, _ = torch_build_chain(
        _flagship(), _table(dspeed_tpu_torch.lh5, wf, bl), db_dict=DB_FLAT,
        device="cpu", fuse="generic",
    )
    inputs, _ = chain._gather_inputs(0, chain._buffer_len)
    env = chain._to_device(inputs)
    a = _groups(chain)[0]
    prog = _tile_program.lower(a.members, {k: env[k] for k in a.ext_in}, a.escapes)
    assert prog.arena_floats == 2 * 4096
    assert prog.smem_bytes + _tile_program.STATIC_SMEM <= _cuda._MAX_SMEM
    # the [0:750] slice is a view of the baseline-subtracted plane
    s = prog.slots[prog.by_key[next(k for k in prog.by_key if k.startswith("wf_blsub[0:750]"))]]
    assert s.root == prog.by_key[next(k for k in prog.by_key if k.startswith("wf_blsub#"))]
    assert (s.start, s.length) == (0, 750)


# ---------------------------------------------------------------------------
# the barrier plan (ip[4]) and the tape's records

# what csrc/generic_rows.cu does around its own block barriers: ops that
# run on warp 0 alone, and for each op with a barrier of its own, which of
# its accesses come after that barrier (its input read again, the scratch)
WARP_OP_NAMES = {"time_point_thresh", "fixed_time_pickoff", "ufunc", "convert"}
AFTER_OWN_BARRIER = {
    "min_max": (), "amax": (), "linear_slope_fit": (),
    "pole_zero": ("input",), "trap": ("input", "scratch"),
    "conv": ("scratch",), "moving_window_multi": ("scratch",),
}
SCRATCH_BEFORE_BARRIER = {"conv"}  # stages its window before its barrier
# the reduction buffers (two, alternating) each op takes, the first before
# its first barrier, and how many of the last it reads after its last
# barrier; moving_window_multi takes one a stage
REDUCTION_BUFFERS = {
    "min_max": (1, 1), "amax": (1, 1), "linear_slope_fit": (2, 1),
    "pole_zero": (1, 1), "trap": (1, 0), "moving_window_multi": (None, 0),
}


def _program_groups(cfg, wf, bl, db=None):
    """Each generic group of ``cfg`` on ``(wf, bl)``, lowered with its chain's
    escapes: ``[(program, vals)]``, the steps between them run on the CPU."""
    chain, _, _ = torch_build_chain(
        cfg, _table(dspeed_tpu_torch.lh5, wf, bl), db_dict=db, device="cpu",
        fuse="generic",
    )
    inputs, _ = chain._gather_inputs(0, chain._buffer_len)
    env = chain._to_device(inputs)
    env.update(chain._const_env())
    out = []
    for step in chain._steps:
        if not isinstance(step, GroupStep):
            step.run(env)
            continue
        vals = {k: env[k] for k in step.ext_in}
        prog = _tile_program.lower(step.members, vals, step.escapes)
        out.append((prog, vals, step))
        env.update(_cuda.generic_rows_plain(prog, vals))
    return out


@pytest.fixture(scope="module")
def plan_programs(flagship_events):
    wf, bl = flagship_events
    (a, _, _), (b, _, _) = _program_groups(_flagship(), wf, bl, DB_FLAT)
    owf, obl = _events(n=8, nsamp=N_OPS, seed=5)
    ((ops, _, _),) = _program_groups(OPS_CONFIG, owf, obl)
    ((red, _, _),) = _program_groups(RED_CONFIG, owf, obl)
    return {"A": a, "B": b, "ops": ops, "red": red}


def _accesses(prog, op, taken):
    """``(before, after)``: the op's accesses before its first block barrier
    and after it (all before, for an op with no barrier of its own). An
    access is ``(kind, what)``: a plane span read or written, its root's
    flag word read or written, a scalar root read or written, the scratch,
    or reduction buffer ``taken + i`` (mod 2) written or read (``taken``:
    the buffers the ops before this one took)."""
    name = {v: k for k, v in _tile_program.OPCODES.items()}[op.code]
    slots = prog.slots

    def span(sid):
        s = slots[sid]
        lo = slots[s.root].off + s.start
        return (lo, lo + s.length)

    ins = [] if name == "load" else [e for e in op.ins if not isinstance(e, tuple)]
    reads = [("read", span(e)) for e in ins if slots[e].kind == "plane"]
    reads += [("read_scalar", slots[e].root) for e in ins if slots[e].kind == "scalar"]
    writes = [("write", span(o)) for o in op.outs if slots[o].kind == "plane"]
    writes += [("write_scalar", o) for o in op.outs if slots[o].kind == "scalar"]
    reads += [("read_flag", slots[e].root) for e in ins if slots[e].kind == "plane"]
    writes += [("write_flag", slots[o].root) for o in op.outs if slots[o].kind == "plane"]
    scratch = [("scratch", None)] if name in ("trap", "moving_window_multi", "conv") else []
    if name not in AFTER_OWN_BARRIER:
        return reads + writes + scratch, []
    before = reads + (scratch if name in SCRATCH_BEFORE_BARRIER else [])
    after = writes + (scratch if "scratch" in AFTER_OWN_BARRIER[name] else [])
    after += [a for a in reads if a[0] == "read"] if "input" in AFTER_OWN_BARRIER[name] else []
    if name in REDUCTION_BUFFERS:
        n, late = REDUCTION_BUFFERS[name]
        n = op.ip[1] if n is None else n
        before.append(("red_write", taken % 2))
        after += [("red_read", (taken + n - 1 - i) % 2) for i in range(late)]
    return before, after


def _buffers_taken(prog):
    """The reduction buffers the ops before each op took."""
    names = {v: k for k, v in _tile_program.OPCODES.items()}
    out, t = [], 0
    for op in prog.ops:
        out.append(t)
        n = REDUCTION_BUFFERS.get(names[op.code], (0, 0))[0]
        t += op.ip[1] if n is None else n
    return out


def _conflict(a, b, reader_on_warp0):
    """Whether access ``a`` of an earlier op and ``b`` of a later one need a
    barrier between them (``reader_on_warp0``: the later op runs on warp 0,
    which sees what warp 0 stored after a __syncwarp)."""
    def overlap(x, y):
        return x[0] < y[1] and y[0] < x[1]

    if a[0] == "write" and b[0] in ("read", "write"):
        return overlap(a[1], b[1])
    if a[0] == "read" and b[0] == "write":
        return overlap(a[1], b[1])
    if a[0] == "write_scalar" and b[0] == "read_scalar":
        return a[1] == b[1] and not reader_on_warp0
    if a[0] == "write_flag" and b[0] in ("read_flag", "write_flag"):
        return a[1] == b[1]
    if a[0] == "read_flag" and b[0] == "write_flag":
        return a[1] == b[1]
    if a[0] == "red_read" and b[0] == "red_write":
        return a[1] == b[1]
    return a[0] == b[0] == "scratch"


@pytest.mark.parametrize("group", ["A", "B", "ops", "red"])
def test_barrier_plan_orders_every_hazard(plan_programs, group):
    """Every pair of ops whose accesses conflict (a plane, its flag word or
    a scalar written, then read; an arena span, the scratch or a reduction
    buffer read or written, then written) has a barrier between them: one
    the plan puts before an op after the first, or a barrier of an op's own
    in between. Ops on warp 0 alone need none among themselves."""
    prog = plan_programs[group]
    names = {v: k for k, v in _tile_program.OPCODES.items()}
    ops = prog.ops
    acc = [_accesses(prog, op, t) for op, t in zip(ops, _buffers_taken(prog))]
    warp = [names[op.code] in WARP_OP_NAMES for op in ops]
    own = [names[op.code] in AFTER_OWN_BARRIER for op in ops]
    checked = 0
    for k, op in enumerate(ops):
        for j in range(k):
            if warp[j] and warp[k]:
                continue
            if any(ops[m].plan for m in range(j + 1, k + 1)) or any(own[j + 1 : k]):
                continue
            visible = acc[j][1] if own[j] else acc[j][0]
            for a in visible:
                for b in acc[k][0]:
                    checked += 1
                    assert not _conflict(a, b, warp[k]), (
                        f"{group}: op {k} {op.name} meets op {j} {ops[j].name} "
                        f"({a} then {b}) with no barrier between")
    assert checked > 0


def _reductions_back_to_back(prog):
    """Pairs of reductions with no barrier between them but their own."""
    names = {v: k for k, v in _tile_program.OPCODES.items()}
    red = [k for k, op in enumerate(prog.ops)
           if names[op.code] in _tile_program.LATE_REDUCTION_READS]
    return [(names[prog.ops[j].code], names[prog.ops[k].code])
            for j, k in zip(red, red[1:])
            if not any(op.plan for op in prog.ops[j + 1 : k + 1])
            and not any(names[op.code] in _tile_program.BARRIERED_OPS
                        for op in prog.ops[j + 1 : k])]


def test_reductions_run_back_to_back(plan_programs):
    """The reduction chain puts two slope fits, two amaxes, two min_maxes
    and a fit after pole_zero's scan back to back, each pair with no
    barrier between them but their own: the buffers alternate."""
    pairs = _reductions_back_to_back(plan_programs["red"])
    for pair in [("linear_slope_fit", "linear_slope_fit"), ("amax", "amax"),
                 ("min_max", "min_max"), ("pole_zero", "linear_slope_fit")]:
        assert pair in pairs, pairs


def test_barrier_plan_guards_a_reduction_buffer_read_late(monkeypatch,
                                                          plan_programs):
    """An op that read both buffers after its last barrier would meet the
    next reduction's first write: the plan then puts a barrier before each
    reduction that follows a slope fit."""
    prog = plan_programs["red"]
    names = {v: k for k, v in _tile_program.OPCODES.items()}
    monkeypatch.setitem(_tile_program.LATE_REDUCTION_READS, "linear_slope_fit", 2)
    monkeypatch.setitem(REDUCTION_BUFFERS, "linear_slope_fit", (2, 2))
    _tile_program._barriers(prog)
    assert ("linear_slope_fit", "linear_slope_fit") not in _reductions_back_to_back(prog)
    fits = [k for k, op in enumerate(prog.ops) if names[op.code] == "linear_slope_fit"]
    nxt = [next(k for k in range(f + 1, len(prog.ops))
                if names[prog.ops[k].code] in _tile_program.LATE_REDUCTION_READS)
           for f in fits]
    assert all(prog.ops[k].plan for k in nxt)
    test_barrier_plan_orders_every_hazard({"red": prog}, "red")
    monkeypatch.undo()
    _tile_program._barriers(prog)


def test_barrier_plan_of_the_flagship_groups(plan_programs):
    """Group A waits at 8 barriers, none inside its run of threshold
    multiplies and searches; group B at 5."""
    a, b = plan_programs["A"], plan_programs["B"]
    names = {v: k for k, v in _tile_program.OPCODES.items()}
    assert sum(op.plan for op in a.ops) == 8
    assert sum(op.plan for op in b.ops) == 5
    run = [k for k, op in enumerate(a.ops)
           if names[op.code] == "ufunc" and op.ip[0] == 1]  # the multiplies
    assert len(run) == 8
    last = max(k for k, op in enumerate(a.ops) if names[op.code] == "time_point_thresh")
    assert all(names[op.code] in ("ufunc", "time_point_thresh")
               for op in a.ops[run[0] : last + 1])
    assert not any(op.plan for op in a.ops[run[0] : last + 1])
    assert a.ops[last + 1].plan  # the windower waits for the searches


# each op record's (code, ip[0:4], ip[7]) on the flagship's two groups: the
# lowering's, unchanged by the barrier plan
FLAGSHIP_RECORDS = {
    "A": [(1, 0, 0, 0, 0, 0), (2, 0, 0, 0, 0, 0), (3, 0, 0, 0, 0, 2),
          (4, 0, 0, 0, 0, 0), (5, 0, 0, 0, 0, 0), (14, 0, 0, 0, 0, 0),
          (4, 0, 0, 0, 0, 0), (6, 0, 625, 188, 625, 0), (7, 0, 0, 0, 0, 0),
          (8, 0, 133, 66, 0, 0), (2, 0, 0, 0, 0, 0), (9, 0, 0, 0, 0, 6),
          (6, 1, 8, 4, 125, 0), (9, 0, 0, 0, 0, 6), (14, 1, 1, 0, 0, 3),
          (9, 1, 0, 0, 0, 6)] + [(14, 1, 1, 0, 0, 3), (9, 0, 0, 0, 0, 6)] * 7
         + [(9, 1, 0, 0, 0, 6), (10, 0, 0, 0, 0, 2), (11, 1, 0, 0, 0, 0)],
    "B": [(1, 0, 0, 0, 0, 0), (12, 48, 3, 0, 0, 0), (2, 0, 0, 0, 0, 0),
          (1, 0, 0, 0, 0, 0), (6, 0, 250, 6, 250, 0), (14, 0, 1, 0, 0, 3),
          (13, 108, 0, 0, 0, 2), (14, 1, 1, 0, 0, 3), (14, 2, 1, 0, 0, 3),
          (14, 2, 1, 0, 0, 3), (14, 0, 1, 0, 0, 3), (14, 0, 1, 0, 0, 3),
          (14, 0, 1, 0, 0, 3), (15, 0, 0, 0, 0, 0), (15, 1, 1, 0, 0, 0),
          (1, 0, 0, 0, 0, 0), (13, 108, 0, 0, 0, 2)],
}


@pytest.mark.parametrize("group", ["A", "B", "ops"])
def test_plan_sits_in_fields_the_records_left_free(plan_programs, group):
    """The plan is ip[4] (ip[5] and ip[6] stay 0); every other field of every
    record is the op's own: its code, operands (a constant as -1 - j),
    outputs and ip[0:4], ip[7]. On the flagship's groups those are pinned,
    so the block-per-op kernel, which reads ip[0:4] and ip[7], runs the
    same tape."""
    T = _tile_program
    prog = plan_programs[group]
    ints = prog.encode()[0]
    base = 1 + T.OP_IN + T.OP_OUT
    pinned = []
    for k, op in enumerate(prog.ops):
        rec = ints[k * T.OP_INTS : (k + 1) * T.OP_INTS]
        ip = rec[base:]
        assert rec[0] == op.code
        ins, j = [], len(op.dp)
        for e in op.ins:
            if isinstance(e, tuple):
                ins.append(-1 - j)
                j += 1
            else:
                ins.append(e)
        assert list(rec[1 : 1 + len(ins)]) == ins
        assert all(v == -(2**30) for v in rec[1 + len(ins) : 1 + T.OP_IN])
        assert list(rec[1 + T.OP_IN : 1 + T.OP_IN + len(op.outs)]) == op.outs
        want_ip = list(op.ip) + [0] * (T.OP_IP - len(op.ip))
        assert list(ip[:4]) == want_ip[:4] and ip[7] == want_ip[7]
        assert (ip[T.IP_PLAN], ip[5], ip[6]) == (op.plan, 0, 0)
        pinned.append((int(rec[0]), *(int(v) for v in ip[:4]), int(ip[7])))
    if group in FLAGSHIP_RECORDS:
        assert pinned == FLAGSHIP_RECORDS[group]


def test_moving_window_runs_in_its_dead_input(plan_programs):
    """Group B's moving window writes its 4784 samples over the plane it
    reads, which dies there, and the planes after it fit the same space:
    two 4096-sample planes, so three blocks fit an SM."""
    b = plan_programs["B"]
    names = {v: k for k, v in _tile_program.OPCODES.items()}
    (mw,) = [op for op in b.ops if names[op.code] == "moving_window_multi"]
    src, dst = b.slots[mw.ins[0]], b.slots[mw.outs[0]]
    assert (src.length, dst.length) == (4784, 4784) and src.off == dst.off
    assert b.arena_floats == 2 * 4096
    assert 3 * (b.smem_bytes + _tile_program.STATIC_SMEM + 1024) <= 233472


def test_lowering_refuses_a_tape_over_the_kernel_parameters(monkeypatch, plan_programs):
    """A tape longer than K7's parameters hold is refused at lowering, so the
    group splits."""
    wf, bl = _events(n=8, nsamp=N_OPS, seed=5)
    monkeypatch.setattr(_tile_program, "GEN_MAX_CODE", 100)
    _tile_program.reset_splits()
    got = _run(wf, bl, "generic", OPS_CONFIG)
    assert any("parameters hold" in k for k in _tile_program.SPLITS)
    want = _run(wf, bl, False, OPS_CONFIG)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# the ops chain with 64 more per-row outputs: one group storing 81
WIDE_CONFIG = {
    "outputs": OPS_CONFIG["outputs"] + [f"trapT_{i}" for i in range(64)],
    "processors": {**OPS_CONFIG["processors"],
                   **{f"trapT_{i}": f"trapTmax + {i + 1}" for i in range(64)}},
}


@pytest.mark.parametrize("limit", ["stored outputs", "inputs"])
def test_lowering_refuses_a_group_over_the_kernel_limits(monkeypatch, limit):
    """A group that stores more outputs than K7's parameters hold (81 of
    64), or reads more inputs (the limit patched to 1), is refused at
    lowering: the group bisects, ``SPLITS`` counts the refusal, and the
    outputs equal the unfused chain's."""
    wf, bl = _events(n=8, nsamp=N_OPS, seed=5)
    if limit == "inputs":
        monkeypatch.setattr(_tile_program, "GEN_MAX_EXT", 1)
    chain, _, _ = torch_build_chain(
        WIDE_CONFIG, _table(dspeed_tpu_torch.lh5, wf, bl), device="cpu", fuse="generic"
    )
    (group,) = _groups(chain)
    assert len(group.escapes) == 81
    _tile_program.reset_splits()
    got = _run(wf, bl, "generic", WIDE_CONFIG)
    held = _tile_program.GEN_MAX_EXT, _tile_program.GEN_MAX_ESC
    assert any(f"81 stored outputs; K7's parameters hold {held[0]} and {held[1]}"
               in k for k in _tile_program.SPLITS), _tile_program.SPLITS
    want = _run(wf, bl, False, WIDE_CONFIG)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_escaping_slice_keeps_the_plain_strides(flagship_events):
    wf, bl = flagship_events
    chain, _, _ = torch_build_chain(
        _flagship(), _table(dspeed_tpu_torch.lh5, wf, bl), db_dict=DB_FLAT,
        device="cpu", fuse="generic",
    )
    inputs, _ = chain._gather_inputs(0, chain._buffer_len)
    env = chain._run_steps(chain._to_device(inputs))
    key = next(k for k in env if k.startswith("wf_blsub[:1996]"))
    v = env[key]
    assert v.shape == (32, 1996) and v.stride() == (4096, 1)


def test_k7_wrapper_never_falls_back_on_a_cuda_tensor(monkeypatch, ops_chain):
    """A CUDA input reaches K7's build, never the plain walk: where the
    library cannot be built the wrapper raises, and nothing is counted."""
    chain, env = ops_chain
    step = next(s for s in chain._steps
                if getattr(s, "kernel", None) is not None
                and s.kernel.__name__ == "trap_norm")
    key = step.arg_specs[0].key
    prog = _tile_program.lower([step], {key: env[key]}, [step.out_specs[0].key])

    class FakeCuda:
        device = torch.device("cuda")
        dtype = torch.float32
        shape = tuple(env[key].shape)
        ndim = 2

        def dim(self):
            return 2

        def stride(self, d=None):
            return (self.shape[1], 1) if d is None else (self.shape[1], 1)[d]

        def is_contiguous(self):
            return True

        def data_ptr(self):
            return 0

    def no_lib(name):
        raise RuntimeError(f"no {name} library")

    monkeypatch.setattr(_cuda, "_lib", no_lib)
    monkeypatch.setattr(_cuda, "_program_on", lambda program, device: (
        _cuda._GenParams(), torch.zeros(1)))
    monkeypatch.setattr(_cuda, "generic_rows_plain", None)
    monkeypatch.setattr(torch, "empty", lambda *a, **k: torch.zeros(1))
    before = dict(_cuda.LAUNCHES)
    with pytest.raises(RuntimeError, match="no generic_rows library"):
        _cuda.generic_rows(prog, {key: FakeCuda()})
    assert _cuda.LAUNCHES == before


# ---------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _on_the_card(members, vals, label, dev):
    """K7 on ``members`` lowered with every key they write, against the
    plain walk of the same tape on the same card, by
    ``chip_smoke.check_generic``'s rule (the convolution bit for bit); one
    launch."""
    sys.path.insert(0, REPO)
    import chip_smoke

    vals = {k: v.to(dev) for k, v in vals.items()}
    prog = _tile_program.lower(members, vals, [])
    every = sorted(s.key for s in prog.slots if not s.ext)
    full = _tile_program.lower(members, vals, every)
    before = _cuda.LAUNCHES["generic_rows"]
    got = _cuda.generic_rows(full, vals)
    assert _cuda.LAUNCHES["generic_rows"] == before + 1
    want = _cuda.generic_rows_plain(full, vals)
    torch.cuda.synchronize()
    chip_smoke.check_generic(full, vals, got, want, label)
    return full, got, want


def _group_on_the_card(cfg, wf, bl, label, dev, db=None):
    ((_, vals, step),) = _program_groups(cfg, wf, bl, db)
    return _on_the_card(step.members, vals, label, dev)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", sorted(OP_CASES))
def test_k7_op_kind_alone_on_the_card(ops_chain, kind, cuda_device):
    """Each op kind of the small chain, lowered alone, on the card."""
    from dspeed_tpu_torch.processing_chain import ConvertStep, KernelStep

    chain, env = ops_chain
    steps = [s for s in chain._steps
             if isinstance(s, (KernelStep, ConvertStep))
             and s.kernel.__name__ == OP_CASES[kind]]
    assert steps, kind
    for step in steps:
        reads = sorted(chain._step_env_reads(step))
        writes = ([sp.key for sp in step.out_specs] if isinstance(step, KernelStep)
                  else [step.out_key])
        _on_the_card([step], {k: env[k] for k in reads}, kind, cuda_device)


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [37, 1])
def test_k7_ops_chain_as_one_group_on_the_card(rows, cuda_device):
    wf, bl = _events(n=max(rows, 8), nsamp=N_OPS, seed=5)
    _group_on_the_card(OPS_CONFIG, wf[:rows], bl[:rows], f"ops x{rows}", cuda_device)


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [37, 1])
def test_k7_reductions_back_to_back_on_the_card(rows, cuda_device):
    """Slope fit after slope fit, amax after amax, min_max after min_max
    and a fit after pole_zero's scan, with no barrier between them but
    their own (``RED_CONFIG``)."""
    wf, bl = _events(n=max(rows, 8), nsamp=N_OPS, seed=3)
    full, _, _ = _group_on_the_card(RED_CONFIG, wf[:rows], bl[:rows],
                                    f"reductions x{rows}", cuda_device)
    assert ("linear_slope_fit", "linear_slope_fit") in _reductions_back_to_back(full)


@pytest.mark.gpu
@pytest.mark.parametrize("nsamp", [1001, 5000])
def test_k7_rows_of_other_lengths_on_the_card(nsamp, cuda_device):
    """1001 samples: rows off 16-byte alignment (4-byte loads) and runs of 4;
    5000: runs of 20 and a longer prefix."""
    wf, bl = _events(n=16, nsamp=nsamp, seed=7)
    _group_on_the_card(OPS_CONFIG, wf, bl, f"{nsamp} samples", cuda_device)


@pytest.mark.gpu
def test_k7_nan_rows_on_the_card(cuda_device):
    """A NaN at a row's first and at its last sample, and a NaN baseline:
    those rows are poisoned where their members poison them."""
    wf, bl = _events(n=12, nsamp=N_OPS, seed=9)
    wf[0, 0] = np.nan
    wf[1, -1] = np.nan
    bl[2] = np.nan
    _, got, _ = _group_on_the_card(OPS_CONFIG, wf, bl, "NaN rows", cuda_device)
    key = next(k for k in got if k.startswith("trapTmax"))
    assert bool(torch.isnan(got[key][[0, 1, 2, 3, 5]]).all())
    assert not bool(torch.isnan(got[key][[4, 6]]).any())


@pytest.mark.gpu
def test_k7_infinite_samples_on_the_card(cuda_device):
    """Rows with infinite samples, as in ``_k5_rows``: at both ends, inside,
    of both signs."""
    wf, bl = _events(n=12, nsamp=N_OPS, seed=9)
    wf[6, 0] = np.inf
    wf[7, -1] = -np.inf
    wf[8, N_OPS // 2] = np.inf
    wf[9, N_OPS // 2 + 1] = -np.inf
    wf[10, 100], wf[10, 200] = np.inf, -np.inf
    _group_on_the_card(OPS_CONFIG, wf, bl, "infinite samples", cuda_device)


@pytest.mark.gpu
def test_k7_flat_tails_on_the_card(cuda_device):
    """Rows that go flat: the searches find nothing and walk to the row's
    end (or its start), the pickoffs read the last samples."""
    wf, bl = _events(n=8, nsamp=N_OPS, seed=5)
    wf[2:6, N_OPS // 3:] = wf[2:6, N_OPS // 3 - 1 : N_OPS // 3]
    _, got, _ = _group_on_the_card(OPS_CONFIG, wf, bl, "flat tails", cuda_device)
    key = next(k for k in got if k.startswith("tp_50"))
    assert bool(torch.isnan(got[key]).any())


@pytest.mark.gpu
@pytest.mark.parametrize("walk", [1, 0])
def test_k7_searches_on_exact_ties_on_the_card(walk, cuda_device):
    """Plateaus that sit exactly on the threshold, rising and falling: the
    search stops at the plain version's index, bit for bit."""
    cfg = {"outputs": ["tp"], "processors": {"tp": {
        "function": "time_point_thresh", "module": "dspeed_tpu.processors",
        "args": ["waveform", "baseline", 128, walk, "tp"], "unit": "ns"}}}
    n = 256
    wf = np.zeros((6, n), "float32")
    bl = np.full(6, 5.0, "float32")
    for r in range(6):
        wf[r] = np.where(np.arange(n) // (7 + 3 * r) % 2 == 0, 5.0, 5.0 + r - 2.0)
    wf[5] = 5.0  # a row flat on the threshold
    chain, _, _ = torch_build_chain(
        cfg, _table(dspeed_tpu_torch.lh5, wf, bl), device="cpu", fuse=False)
    inputs, _ = chain._gather_inputs(0, chain._buffer_len)
    env = chain._run_steps(chain._to_device(inputs))
    (step,) = [s for s in chain._steps if getattr(s, "kernel", None) is not None
               and s.kernel.__name__ == "time_point_thresh"]
    vals = {k: env[k] for k in sorted(chain._step_env_reads(step))}
    _, got, want = _on_the_card([step], vals, f"ties walk {walk}", cuda_device)
    (k,) = [k for k in want if k.startswith("tp")]
    g, w = got[k].cpu(), want[k].cpu()
    assert bool(((g == w) | (torch.isnan(g) & torch.isnan(w))).all())
    assert bool(torch.isfinite(w).any())


@pytest.mark.gpu
def test_k7_launch_on_the_flagship_groups(flagship_events, cuda_device):
    """One launch a group, no local memory, at least three blocks an SM
    on both flagship groups."""
    wf, bl = flagship_events
    for prog, vals, _ in _program_groups(_flagship(), wf, bl, DB_FLAT):
        launch = _cuda.generic_rows_launch(prog)
        assert launch["local_bytes"] == 0, launch
        assert launch["blocks_per_sm"] >= 3, launch
        before = _cuda.LAUNCHES["generic_rows"]
        _cuda.generic_rows(prog, {k: v.to(cuda_device) for k, v in vals.items()})
        assert _cuda.LAUNCHES["generic_rows"] == before + 1


@pytest.mark.gpu
def test_k7_matches_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, REPO)
    import chip_smoke

    wf, _amp, _t0, bl, _rt = chip_smoke.make_hpge_waveforms(512)
    before = _cuda.LAUNCHES["generic_rows"]
    _, ptxas_log = _cuda._compile("generic_rows", verbose=True)
    figs = chip_smoke.k7_phase(
        torch_build_chain, dspeed_tpu_torch.lh5, _cuda, wf, bl,
        torch.device("cuda"), ptxas_log,
    )
    assert _cuda.LAUNCHES["generic_rows"] > before
    assert figs["ms"] > 0 and figs["bound_ms"] > 0
