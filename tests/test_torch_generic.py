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

The JAX package is imported inside the CPU tests only. The ``gpu`` test
runs K7 on both flagship groups at 512 rows against the plain walk
(``chip_smoke.k7_phase``):

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
    from dspeed_tpu import lh5 as jlh5
    from dspeed_tpu.processing_chain import GroupStep as JaxGroupStep
    from dspeed_tpu.processing_chain import build_processing_chain as jax_build

    wf, bl = flagship_events
    monkeypatch.setenv("DSPEED_TPU_FUSE", "generic")
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
    """A tile-safe kernel with no K7 op (``moving_window_left``) in the
    group: the lowering raises, the group splits, and the outputs equal the
    unfused chain's."""
    wf, bl = _events(n=8, nsamp=N_OPS, seed=5)
    cfg = {"outputs": OPS_CONFIG["outputs"] + ["mwl_max"],
           "processors": dict(OPS_CONFIG["processors"])}
    cfg["processors"]["wf_mwl"] = {
        "function": "moving_window_left", "module": "dspeed_tpu.processors",
        "args": ["wf_pz", "8", "wf_mwl"], "unit": "ADC",
    }
    cfg["processors"]["mwl_max"] = {
        "function": "amax", "module": "numpy", "args": ["wf_mwl", 1, "mwl_max"],
        "kwargs": {"signature": "(n),()->()", "types": ["fi->f"]}, "unit": "ADC",
    }
    chain, _, _ = torch_build_chain(
        cfg, _table(dspeed_tpu_torch.lh5, wf, bl), device="cpu", fuse="generic"
    )
    (group,) = _groups(chain)
    step = next(m for m in group.members
                if getattr(getattr(m, "kernel", None), "__name__", "")
                == "moving_window_left")
    with pytest.raises(_tile_program.LoweringError, match="moving_window_left"):
        _tile_program.lower([step], {step.arg_specs[0].key: torch.zeros(8, N_OPS)},
                            [step.out_specs[0].key])
    _tile_program.reset_splits()
    got = _run(wf, bl, "generic", cfg)
    assert any("moving_window_left has no K7 op" in k for k in _tile_program.SPLITS)
    want = _run(wf, bl, False, cfg)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_lowering_refuses_float64_planes_and_oversized_plans():
    """A float64 plane, and a plan over one block's shared memory (a
    trapezoid of a 40000-sample row: two planes and a float64 prefix,
    640 KB), raise at lowering."""
    cfg = {"outputs": ["trapTmax"], "processors": {
        k: OPS_CONFIG["processors"][k] for k in ("wf_trap", "trapTmax")}}
    cfg["processors"]["wf_trap"] = dict(cfg["processors"]["wf_trap"],
                                        args=["waveform", "320*ns", "160*ns", "wf_trap"])
    cfg["processors"]["trapTmax"] = dict(cfg["processors"]["trapTmax"], kwargs={
        "signature": "(n),()->()", "types": ["fi->f", "di->d"]})
    for n, dtype, match in ((N_OPS, "float64", "float32"),
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
        torch.zeros(1), torch.zeros(1), torch.zeros(1)))
    monkeypatch.setattr(_cuda, "generic_rows_plain", None)
    monkeypatch.setattr(torch, "empty", lambda *a, **k: torch.zeros(1))
    before = dict(_cuda.LAUNCHES)
    with pytest.raises(RuntimeError, match="no generic_rows library"):
        _cuda.generic_rows(prog, {key: FakeCuda()})
    assert _cuda.LAUNCHES == before


# ---------------------------------------------------------------------------
# on the card


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
    figs = chip_smoke.k7_phase(
        torch_build_chain, dspeed_tpu_torch.lh5, _cuda, wf, bl,
        torch.device("cuda"),
    )
    assert _cuda.LAUNCHES["generic_rows"] > before
    assert figs["ms"] > 0 and figs["bound_ms"] > 0
