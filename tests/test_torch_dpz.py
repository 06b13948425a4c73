"""The flagship DPZ (``torch_flagship.dpz_config``: the flagship with its
pole-zero step changed to ``double_pole_zero``) through the port against
the JAX package, K7's ``double_pole_zero`` op, the per-event index through
``get_default`` and the registry, on the CPU at 32 events.

The column rule is the flagship's (``torch_flagship.assert_timing_columns``:
float columns within ``REL`` = 1e-5 of their scale, ``tp_*`` exactly,
``READS_TP0``'s one-sample excuse). The float64 chain meets it in full
against the JAX package's. On float32 waveforms the columns that read
``wf_pz``'s values after the rise (``WF_PZ_VALUE``, ``WF_PZ_INDEX``) are a
known difference: the JAX package rounds ``double_pole_zero``'s numerator
``x - (a+b) x[i-1] + ab x[i-2]`` to float32, where it cancels to a few ulps
of the pulse that the integrator then sums, and its float32 chain lands up
to ~2e-3 of ``trapEmax`` away from its own float64 chain. The port applies
the numerator to the float64 prefix instead, so its float32 chain is held
to the column rule against the float64 chain (the oracle) in every column
(``pz_slope`` at ``SLOPE_REL``; the time points of ``WF_PZ_INDEX`` within
one sample, in 1 event in 8 at most), and to the JAX package's float32
chain in the others.
"""

import os
import re
import sys

import numpy as np
import pytest
import torch

import dspeed_tpu_torch
from dspeed_tpu_torch.processing_chain import (
    GroupStep, build_processing_chain as torch_build_chain,
)
from dspeed_tpu_torch.processors import _cuda, _tile_program

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_flagship import (  # noqa: E402
    DPZ, assert_timing_columns, dpz_config, make_hpge_dpz_waveforms,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the float32 columns that read wf_pz's values after the rise (the known
# difference of the module docstring): values, and time points
WF_PZ_VALUE = ("pz_mean", "pz_std", "pz_slope", "trapTmax", "trapEmax", "trapEftp",
               "QDrift", "dt_eff", "A_max")
WF_PZ_INDEX = ("tp_50", "tp_80", "tp_90", "tp_95", "tp_99", "tp_100", "tp_aoe_max",
               "tp_aoe_samp")
# pz_slope is the slope of the flat top (a scale of ~1e-2 ADC a sample)
# fitted to float32 samples of ~3e4 ADC: their rounding alone moves it by
# ~2e-7, 2e-5 of that scale, so against the float64 oracle it is held at
# 1e-4 of its scale (the JAX package's float32 chain is ~20 scales away)
SLOPE_REL = 1e-4
# registry names of the JAX package that wait for later slices: none
WAITING: list = []


@pytest.fixture(autouse=True)
def fresh_chain_caches(monkeypatch):
    """Each test builds its own chains, in both packages."""
    from dspeed_tpu_torch import build_dsp

    monkeypatch.setenv("DSPEED_TPU_CHAIN_CACHE", "0")
    cache = sys.modules[build_dsp.__module__]._CHAIN_CACHE
    cache.clear()
    yield
    cache.clear()


def _table(lh5, wf, bl):
    return lh5.Table({
        "waveform": lh5.WaveformTable(values=wf, t0=0.0, t0_units="ns", dt=16.0,
                                      dt_units="ns"),
        "baseline": lh5.Array(bl),
    })


@pytest.fixture(scope="module")
def dpz_events():
    """32 events of the DPZ generator: row 3 with a NaN sample, row 5 with
    a NaN baseline. Returns ``(wf, bl, amp)``."""
    wf, amp, _, bl, _ = make_hpge_dpz_waveforms(32)
    bl = bl.astype("float32")
    wf[3, 512] = np.nan
    bl[5] = np.nan
    return wf, bl, amp


def _unnumbered(key: str) -> str:
    """A key or step name without its variables' numbers (``#N``), which
    count every chain built so far in the process."""
    return re.sub(r"#\d+", "", key)


def _kinds(steps):
    return [(type(s).__name__, _unnumbered(
        s.kernel.__name__ if hasattr(s, "kernel") else getattr(s, "name", "")))
        for s in steps]


def _columns(out):
    return {k: np.asarray(out[k].nda) for k in out.keys()}


_RUNS: dict = {}


def _run(wf, bl, fuse, dtype="float32"):
    """``(port, jax)`` columns of the DPZ chain on the same events (each
    mode and type run once a test process for the module's events)."""
    key = (id(wf), fuse, dtype)
    if key not in _RUNS:
        _RUNS[key] = (wf, _run_both(wf, bl, fuse, dtype))
    return _RUNS[key][1]


def _run_both(wf, bl, fuse, dtype):
    import dspeed_tpu

    cfg = dpz_config(dtype)
    wf, bl = wf.astype(dtype), bl.astype(dtype)
    port = dspeed_tpu_torch.build_dsp(_table(dspeed_tpu_torch.lh5, wf, bl),
                                      dsp_config=cfg, device="cpu", fuse=fuse)
    env = {} if fuse is True else {"DSPEED_TPU_FUSE": "generic"}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        jax_out = dspeed_tpu.build_dsp(_table(dspeed_tpu.lh5, wf, bl), dsp_config=cfg)
    finally:
        for k, v in old.items():
            os.environ.pop(k) if v is None else os.environ.__setitem__(k, v)
    return _columns(port), _columns(jax_out)


# ---------------------------------------------------------------------------
# the steps


def test_dpz_steps_match_jax(dpz_events):
    from dspeed_tpu import lh5 as jlh5
    from dspeed_tpu.processing_chain import GroupStep as JaxGroupStep
    from dspeed_tpu.processing_chain import build_processing_chain as jax_build

    wf, bl, _ = dpz_events
    jc, _, _ = jax_build(dpz_config(), _table(jlh5, wf, bl), db_dict={})
    tc, _, _ = torch_build_chain(dpz_config(), _table(dspeed_tpu_torch.lh5, wf, bl),
                                 db_dict={}, device="cpu")
    assert _kinds(tc._steps) == _kinds(jc._steps)
    tg = [s for s in tc._steps if isinstance(s, GroupStep)]
    jg = [s for s in jc._steps if isinstance(s, JaxGroupStep)]
    assert len(tg) == len(jg) == 2
    for t, j in zip(tg, jg):
        assert _kinds(t.members) == _kinds(j.members)
        for keys in ("ext_in", "escapes"):
            assert (sorted(map(_unnumbered, getattr(t, keys)))
                    == sorted(map(_unnumbered, getattr(j, keys)))), keys
    assert ("KernelStep", "double_pole_zero") in _kinds(tg[0].members)
    kinds = [k[1] for k in _kinds(tc._steps)]
    assert kinds[1:4] == ["fused_t0_front", "chained_time_point_thresh",
                          "fused_current_front"]
    assert kinds[5] == "fused_conv_bank" and "fused_energy_front" not in kinds


def test_dpz_groups_lower_without_a_split(dpz_events):
    """Both groups take K7's tape (no split), and their plain walk meets the
    column rule against the unfused chain on the CPU: it equals it but for
    ``double_pole_zero``'s pole, which the plain walk runs in K7's order
    (runs and an affine scan) where the unfused step runs the sequential
    recurrence, one rounding apart."""
    wf, bl, _ = dpz_events
    _tile_program.reset_splits()
    tb = _table(dspeed_tpu_torch.lh5, wf, bl)
    fused = _columns(dspeed_tpu_torch.build_dsp(tb, dsp_config=dpz_config(),
                                                device="cpu"))
    assert _tile_program.SPLITS == {}
    unfused = _columns(dspeed_tpu_torch.build_dsp(tb, dsp_config=dpz_config(),
                                                  device="cpu", fuse=False))
    assert_timing_columns(fused, unfused)


# ---------------------------------------------------------------------------
# the chain against the JAX package


@pytest.mark.parametrize("fuse", [True, "generic"])
def test_dpz_chain_float64_matches_jax(dpz_events, fuse):
    wf, bl, _ = dpz_events
    port, jax_out = _run(wf, bl, fuse, "float64")
    assert len(port) == 34
    assert_timing_columns(port, jax_out)


@pytest.mark.parametrize("fuse", [True, "generic"])
def test_dpz_chain_matches_jax(dpz_events, fuse):
    wf, bl, amp = dpz_events
    port, jax_out = _run(wf, bl, fuse)
    assert len(port) == 34
    rest = [k for k in port if k not in WF_PZ_VALUE + WF_PZ_INDEX]
    assert_timing_columns({k: port[k] for k in rest}, {k: jax_out[k] for k in rest})
    # every column against the float64 chain (the oracle), and the JAX
    # package's float32 columns that read wf_pz no closer to it
    oracle, _ = _run(wf, bl, fuse, "float64")
    cols = [k for k in port if k != "pz_slope" and k not in WF_PZ_INDEX]
    assert_timing_columns({k: port[k] for k in cols}, {k: oracle[k] for k in cols})
    for k in WF_PZ_INDEX:
        # a maximum's or a crossing's sample, which float32 rounding may
        # move by one against float64 (16 ns), in 1 event in 8 at most
        np.testing.assert_array_equal(np.isnan(port[k]), np.isnan(oracle[k]), err_msg=k)
        ok = ~np.isnan(oracle[k])
        d = np.abs(port[k][ok] - oracle[k][ok])
        assert (d <= 16.0).all() and (d > 0).sum() <= ok.sum() // 8, (k, d.max())
    for k in WF_PZ_VALUE:
        o = oracle[k]
        ok = ~np.isnan(o)
        np.testing.assert_array_equal(np.isnan(port[k]), np.isnan(o), err_msg=k)
        e_port = np.abs(port[k][ok].astype(np.float64) - o[ok]).max()
        e_jax = np.abs(jax_out[k][ok].astype(np.float64) - o[ok]).max()
        assert e_port <= e_jax, (k, e_port, e_jax)
        if k == "pz_slope":
            assert e_port <= SLOPE_REL * np.abs(o[ok]).max(), (k, e_port)
    # the physics, as the JAX package meets it on these events
    good = np.isfinite(port["trapEmax"])
    err = np.abs(port["trapEmax"][good] / amp[good] - 1).max()
    jerr = np.abs(jax_out["trapEmax"][good] / amp[good] - 1).max()
    assert err <= jerr + 1e-5, (err, jerr)


# ---------------------------------------------------------------------------
# K7's double_pole_zero op


def _one_op_config(tau1=500.0, tau2=20.0, frac=0.05):
    return {
        "outputs": ["wf_pz"],
        "processors": {
            "wf_blsub": {"function": "bl_subtract", "module": "dspeed_tpu.processors",
                         "args": ["waveform", "baseline", "wf_blsub(unit='ADC')"]},
            "wf_pz": {"function": "double_pole_zero",
                      "module": "dspeed_tpu.processors",
                      "args": ["wf_blsub", repr(tau1), repr(tau2), repr(frac), "wf_pz"],
                      "unit": "ADC"},
        },
    }


def _near_step(got, want):
    """The plain walk's plane against the unfused step's: NaN rows equal,
    within 2e-6 of the scale (the pole's two orders, one rounding apart)."""
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    ok = ~torch.isnan(want)
    err = (got[ok].double() - want[ok].double()).abs().max()
    assert err <= 2e-6 * want[ok].double().abs().max(), float(err)


def _small_events(n=8, nsamp=256, seed=5):
    """DPZ pulses cut to ``nsamp`` samples around the rise, row 2 with a
    NaN sample."""
    wf, _, _, bl, _ = make_hpge_dpz_waveforms(n, nsamp=max(nsamp, 4096), seed=seed)
    wf = wf[:, 900:900 + nsamp] if nsamp <= 3000 else wf[:, :nsamp]
    bl = bl.astype("float32")
    wf[2, 40] = np.nan
    return np.ascontiguousarray(wf), bl


def _dpz_step(wf, bl, **params):
    chain, _, _ = torch_build_chain(
        _one_op_config(**params), _table(dspeed_tpu_torch.lh5, wf, bl),
        device="cpu", fuse=False)
    inputs, _ = chain._gather_inputs(0, len(wf))
    env = chain._run_steps(chain._to_device(inputs))
    step = next(s for s in chain._steps if getattr(s, "kernel", None) is not None
                and s.kernel.__name__ == "double_pole_zero")
    reads = sorted(chain._step_env_reads(step))
    return step, {k: env[k] for k in reads}, env


def test_dpz_op_plain_walk_matches_pallas_generic_rows():
    """The tape's plain walk of a one-op group against the JAX package's
    ``generic_rows`` in interpret mode at 8 x 256, at the generic ops'
    tolerance (``test_torch_generic.TILE_TOL``). The Pallas body runs the
    JAX package's ``double_pole_zero`` on the row in float64 and rounds its
    output to float32: its float32 body rounds the numerator to float32
    first (the known difference of the module docstring, ~4e-4 of the
    scale on these rows)."""
    import jax.numpy as jnp

    import dspeed_tpu.processors as dp
    from dspeed_tpu.processors import _pallas

    wf, bl = _small_events()
    step, vals, env = _dpz_step(wf, bl, tau1=DPZ["tau1"], tau2=DPZ["tau2"],
                                frac=DPZ["frac"])
    out = step.out_specs[0].key
    prog = _tile_program.lower([step], vals, [out])
    assert [op.code for op in prog.ops if op.code != 1] == [17]
    got = _cuda.generic_rows_plain(prog, vals)[out]
    _near_step(got, env[out])
    op = next(op for op in prog.ops if op.code == 17)

    def body(jv):
        args = [jv[prog.slots[a[1]].key].astype(jnp.float64) if a[0] == "slot"
                else a[1] for a in op.args]
        return {out: dp.double_pole_zero(*args)[0].astype(jnp.float32)}

    jvals = {k: np.asarray(v) for k, v in vals.items()}
    want = _pallas.generic_rows(body, jvals, {k: v.ndim - 1 for k, v in jvals.items()},
                                interpret=True)
    assert want is not None
    a, b = got.numpy(), np.asarray(want[out])
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_allclose(np.nan_to_num(a, nan=-1.0), np.nan_to_num(b, nan=-1.0),
                               rtol=2e-6, atol=2e-5)


@pytest.mark.parametrize("params", [dict(tau2=100.0, frac=0.3), dict(frac=0.0)])
def test_dpz_op_parameters(params):
    """Other poles: the plain walk of the one-op tape is the unfused step."""
    wf, bl = _small_events()
    kw = dict(tau1=500.0, tau2=20.0, frac=0.05)
    kw.update(params)
    step, vals, env = _dpz_step(wf, bl, **kw)
    out = step.out_specs[0].key
    prog = _tile_program.lower([step], vals, [out])
    got = _cuda.generic_rows_plain(prog, vals)[out]
    _near_step(got, env[out])
    from dspeed_tpu_torch.processors.pole_zero import dpz_constants

    op = prog.ops[-1]
    # the parameters as the step passes them (in the signature's float32)
    k = dpz_constants(*(float(a[1]) for a in op.args[1:]))
    assert op.ip[1] == 0 and op.dp == [k["p"], k["k1"], k["k2"]]


@pytest.mark.parametrize("n", [300, 4100])
def test_runs_order_is_the_recurrence_within_rounding(n):
    """K7's order of the pole (runs of ceil(n/256) samples, an affine scan
    of their maps) against the sequential recurrence and the JAX package's
    blocked form, in float64: within 1e-12 and 1e-9 of the scale."""
    from dspeed_tpu.processors import _numerics as jn
    from dspeed_tpu_torch.processors import _numerics as tn

    x = np.random.default_rng(n).normal(0, 50, (5, n))
    got = tn.iir_first_order_runs(torch.from_numpy(x), 0.9961).numpy()
    seq = _cuda.recurrence_plain(torch.from_numpy(x), 0.9961).numpy()
    want = np.asarray(jn.iir_first_order(x, 0.9961))
    for ref, rel in ((seq, 1e-12), (want, 1e-9)):
        np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
        ok = ~np.isnan(ref)
        assert np.abs(got[ok] - ref[ok]).max() <= rel * np.abs(ref[ok]).max()


def test_dpz_op_plan_barriers():
    """A barrier before the op (its FIR reads samples other threads wrote),
    none of its own reduction buffers read late."""
    wf, bl = _small_events()
    chain, _, _ = torch_build_chain(
        _one_op_config(), _table(dspeed_tpu_torch.lh5, wf, bl), device="cpu",
        fuse="generic")
    group = next(s for s in chain._steps if isinstance(s, GroupStep))
    inputs, _ = chain._gather_inputs(0, len(wf))
    inputs = chain._to_device(inputs)
    vals = {k: inputs[k] for k in group.ext_in}
    prog = _tile_program.lower(group.members, vals, group.escapes)
    names = {v: k for k, v in _tile_program.OPCODES.items()}
    plan = [(names[op.code], op.plan) for op in prog.ops]
    assert plan[-1] == ("double_pole_zero", 1)
    # its affine scan's warp totals are read after its last barrier
    assert _tile_program.LATE_REDUCTION_READS["double_pole_zero"] == 1
    assert prog.scratch_dbl >= 256


# ---------------------------------------------------------------------------
# the per-event index, and the registry


def test_per_event_index_goes_through_get_default():
    """``vov_in(shape=50)[len(vov_in)//2]`` (the JAX package's
    ``TestVovVariableIndices``) and indices past the end: a ``get_default``
    step, the JAX package's values."""
    import dspeed_tpu

    config = {
        "outputs": ["vals", "v_end", "v_past"],
        "processors": {"vals": "vov_in(shape=50)[len(vov_in)//2]",
                       "v_end": "vov_in(shape=50)[-1]",
                       "v_past": "vov_in(shape=50)[len(vov_in) + 5]"},
    }

    def table(lh5):
        return lh5.Table({"vov_in": lh5.VectorOfVectors(
            flattened_data=np.arange(150.0),
            cumulative_length=np.array([10, 30, 60, 100, 150]),
            attrs={"units": "ns"})})

    chain, _, _ = torch_build_chain(config, table(dspeed_tpu_torch.lh5), device="cpu")
    assert "get_default" in [k[1] for k in _kinds(chain._steps)]
    out = dspeed_tpu_torch.build_dsp(table(dspeed_tpu_torch.lh5), dsp_config=config,
                                     device="cpu")
    np.testing.assert_array_equal(out["vals"].nda, [5.0, 20.0, 45.0, 80.0, 125.0])
    assert out["vals"].attrs["units"] == "ns"
    np.testing.assert_array_equal(out["v_end"].nda, [9.0, 29.0, 59.0, 99.0, 149.0])
    want = dspeed_tpu.build_dsp(table(dspeed_tpu.lh5), dsp_config=config)
    for k in config["outputs"]:
        np.testing.assert_array_equal(out[k].nda, want[k].nda, err_msg=k)
    assert np.isnan(out["v_past"].nda[-1])


def test_registry_is_the_jax_registry_less_the_waiting_names():
    import dspeed_tpu.processors as jp
    import dspeed_tpu_torch.processors as tp

    # every JAX registry name is in the port
    assert len(tp._modules) == 108 and not WAITING
    assert sorted(set(jp._modules) - set(tp._modules)) == WAITING
    # the port's one name of its own: K2's threshold-mask entry
    assert set(tp._modules) - set(jp._modules) == {"tp_from_cross_mask"}
    for name in tp._modules:
        assert getattr(tp, name) is not None, name


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
@pytest.mark.parametrize("rows, nsamp", [(37, 256), (1, 1001), (9, 5000)])
def test_k7_dpz_op_on_the_card(cuda_device, rows, nsamp):
    """K7's double_pole_zero op equals the plain walk bit for bit: a NaN
    row, an infinite sample, rows longer than 4096 samples (its runs
    re-read from shared memory)."""
    wf, bl = _small_events(n=max(rows, 4), nsamp=nsamp)
    if rows > 3:
        wf[3, nsamp // 2] = np.inf
    wf, bl = wf[:rows], bl[:rows]
    step, vals, _ = _dpz_step(wf, bl, tau1=DPZ["tau1"], tau2=DPZ["tau2"],
                              frac=DPZ["frac"])
    vals = {k: v.to(cuda_device) for k, v in vals.items()}
    out = step.out_specs[0].key
    prog = _tile_program.lower([step], vals, [out])
    before = _cuda.LAUNCHES["generic_rows"]
    got = _cuda.generic_rows(prog, vals)[out]
    assert _cuda.LAUNCHES["generic_rows"] == before + 1
    want = _cuda.generic_rows_plain(prog, vals)[out]
    assert _same(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [37, 1])
def test_k7_dpz_group_on_the_card(cuda_device, rows):
    """The flagship DPZ's energy-front group, every intermediate against its
    plain walk by ``chip_smoke.check_generic``'s rule (the trapezoid's and
    the fits' float64 sums of a float32 plane run in other orders), and
    ``double_pole_zero``'s plane bit for bit."""
    sys.path.insert(0, REPO)
    import chip_smoke

    wf, _, _, bl, _ = make_hpge_dpz_waveforms(max(rows, 8))
    bl = bl.astype("float32")
    wf[1, 700] = np.nan
    wf, bl = wf[:rows], bl[:rows]
    chain, _, _ = torch_build_chain(dpz_config(), _table(dspeed_tpu_torch.lh5, wf, bl),
                                    db_dict={}, device="cpu")
    group = next(s for s in chain._steps if isinstance(s, GroupStep))
    inputs, _ = chain._gather_inputs(0, len(wf))
    inputs = chain._to_device(inputs)
    vals = {k: inputs[k].to(cuda_device) for k in group.ext_in}
    prog = _tile_program.lower(group.members, vals, group.escapes)
    every = sorted(s.key for s in prog.slots if not s.ext)
    full = _tile_program.lower(group.members, vals, every)
    got = _cuda.generic_rows(full, vals)
    want = _cuda.generic_rows_plain(full, vals)
    chip_smoke.check_generic(full, vals, got, want, "DPZ A")
    ops = [op for op in full.ops if op.code == _tile_program.OPCODES["double_pole_zero"]]
    assert len(ops) == 1
    key = full.slots[ops[0].outs[0]].key
    assert _same(got[key], want[key])
