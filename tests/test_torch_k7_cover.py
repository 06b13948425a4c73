"""K7's ops for the twelve tile-safe kernels of slice 19 (``mean_below_threshold``,
``time_over_threshold``, ``saturation``, ``presum``, ``log_check``,
``trap_pickoff``, ``min_max_norm``, ``linear_slope_diff``, ``get`` /
``get_default``, ``multi_a_filter``, ``where`` and the four ``*_to_nearest``
rounders), the per-row comparisons and bool and int64 scalar slots they need,
and the coverage path (``chip_smoke.coverage_config``) that runs them all.

- Each op alone: the tape's plain walk on a one-op group against the JAX
  package's ``_pallas.generic_rows`` in interpret mode at 8 x 256
  (``tests/torch_k7_ops.py``, ``tests/test_tile_safety.py``'s tolerance),
  rows with a NaN sample and a flat row among them; float64 rows split the
  plane ops' groups (K7 takes float32 planes) and run the scalar ops.
- The coverage config at 64 events: the port's generic groups are the JAX
  package's (``DSPEED_TPU_FUSE=generic``) member for member, nothing
  splits, and its columns meet the JAX package's at the chain tolerance.
- ``tests/test_torch_k7_cover_emulation.py`` runs the kernel's new ops on
  the CPU under ThreadSanitizer and AddressSanitizer (``tools/k7_emu``).

The ``gpu`` tests hold each op on the card against the plain walk of the
same tape bit for bit, and the coverage groups at 600 rows; they import
neither JAX nor the JAX package.
"""

import itertools
import os
import sys

import numpy as np
import pytest
import torch

import dspeed_tpu_torch
from dspeed_tpu_torch.processing_chain import GroupStep
from dspeed_tpu_torch.processors import _cuda, _tile_program

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)
sys.path.insert(0, REPO)
import chip_smoke as cs  # noqa: E402
from torch_k7_ops import (  # noqa: E402
    check_against_pallas, check_float64_body, events, one_op, widen,
)

K = "dspeed_tpu.processors"
INF_ROW, INF_AT = 4, 180  # the row with an infinite sample, and where


@pytest.fixture(autouse=True)
def fresh_chain_cache():
    from dspeed_tpu_torch import build_dsp

    cache = sys.modules[build_dsp.__module__]._CHAIN_CACHE
    cache.clear()
    yield
    cache.clear()


def _p(fn, args, unit=None):
    node = {"function": fn, "module": K, "args": args}
    if unit:
        node["unit"] = unit
    return node


_MINMAX = {"tp_min, tp_max, wf_min, wf_max": _p(
    "min_max", ["wf_blsub", "tp_min", "tp_max", "wf_min", "wf_max"],
    ["ns", "ns", "ADC", "ADC"])}
_FIT = {"b_mean, b_std, b_slope, b_icpt": _p(
    "linear_slope_fit", ["wf_blsub[0:90]", "b_mean", "b_std", "b_slope", "b_icpt"])}
_MEAN = {"b_mb": _p("mean_below_threshold", ["wf_blsub", "20.0", "b_mb"])}
_TOT = {"n_tot": _p("time_over_threshold", ["wf_blsub", "30.0", "n_tot"])}

# case -> (processors, the member's kernel, its outputs (the chain's), the op)
OP_CASES = {
    "mean_below_threshold": (_MEAN, "mean_below_threshold", ["b_mb"],
                             "mean_below_threshold"),
    "mean_below_threshold_per_row": (
        {**_FIT, "b_mb": _p("mean_below_threshold", ["wf_blsub", "b_std*2", "b_mb"])},
        "mean_below_threshold", ["b_mb"], "mean_below_threshold"),
    "time_over_threshold": (_TOT, "time_over_threshold", ["n_tot"], "count"),
    "saturation": ({"s_lo, s_hi": _p("saturation", ["waveform", "8", "s_lo", "s_hi"])},
                   "saturation", ["s_lo", "s_hi"], "count"),
    "presum": ({"ps_f, wf_ps": _p("presum", ["wf_blsub", "0", "ps_f", "wf_ps(64, 'f')"])},
               "presum", ["ps_f", "wf_ps"], "presum"),
    "presum_norm": ({"ps_f, wf_ps": _p("presum", ["wf_blsub", "1", "ps_f",
                                                "wf_ps(50, 'f')"])},
                    "presum", ["ps_f", "wf_ps"], "presum"),
    "log_check": ({"wf_log": _p("log_check", ["waveform", "wf_log"])}, "log_check",
                  ["wf_log"], "log_check"),
    "log_check_nonpositive": ({"wf_log": _p("log_check", ["wf_blsub", "wf_log"])},
                              "log_check", ["wf_log"], "log_check"),
    "trap_pickoff": ({"pick": _p("trap_pickoff", ["wf_blsub", "20", "5", "150", "pick"])},
                     "trap_pickoff", ["pick"], "trap_pickoff"),
    "trap_pickoff_per_row": (
        {**_MINMAX, "pick": _p("trap_pickoff", ["wf_blsub", "10", "5", "tp_max/16",
                                               "pick"])},
        "trap_pickoff", ["pick"], "trap_pickoff"),
    "min_max_norm": ({**_MINMAX, "wf_n": _p("min_max_norm",
                                            ["wf_blsub", "wf_min", "wf_max", "wf_n"])},
                     "min_max_norm", ["wf_n"], "min_max_norm"),
    "linear_slope_diff": ({**_FIT, "d_mean, d_rms": _p(
        "linear_slope_diff", ["wf_blsub[0:90]", "b_slope", "b_icpt", "d_mean", "d_rms"])},
        "linear_slope_diff", ["d_mean", "d_rms"], "linear_slope_diff"),
    "get": ({"w_last": _p("get", ["wf_blsub", "-3", "w_last"])}, "get", ["w_last"], "get"),
    "get_out_of_range": ({"w_last": _p("get", ["wf_blsub", "300", "w_last"])}, "get", ["w_last"],
                         "get"),
    "get_default": ({**_MINMAX, "w_at": "wf_blsub[round(tp_max, wf_blsub.grid, 'int64')]"},
                    "get_default", ["tp_max", "w_at"], "get"),
    "multi_a_filter": ({
        "vt_max, vt_min, n_max, n_min": _p("get_multi_local_extrema", [
            "wf_blsub", "20", "20", "0", "20", "0", "vt_max(4, vector_len=n_max)",
            "vt_min(4, vector_len=n_min)", "n_max", "n_min"]),
        "pk_a": _p("multi_a_filter", ["wf_blsub", "vt_max", "pk_a"])},
        "multi_a_filter", ["pk_a"], "multi_a_filter"),
    "where": ({**_MEAN, **_TOT, "m_sel": "where(b_mb > 0, b_mb, n_tot)"}, "where", ["m_sel"],
              "where"),
    **{f"{m}_to_nearest": ({**_MEAN, "m_r": _p(f"{m}_to_nearest", ["b_mb", "0.25", "m_r"])},
                           f"{m}_to_nearest", ["m_r"], "round")
       for m in ("round", "floor", "ceil", "trunc")},
}
SCALAR_OPS = ("where", "round_to_nearest", "floor_to_nearest", "ceil_to_nearest",
              "trunc_to_nearest")


def _jp():
    import dspeed_tpu.processors as jp

    return jp


def _jax_fn(step):
    """The JAX package's processor of ``step``, on the step's arguments
    (``presum`` given its output's length)."""
    fn = getattr(_jp(), step.kernel.__name__)
    if step.kernel.__name__ == "presum":
        m = step.out_specs[1].shape[0]
        return lambda w, dn: fn(w, dn, dims={"m": m})
    return fn


def _rows(case, dtype="float32", inf=False):
    wf, bl = events(dtype)
    if inf:
        wf[INF_ROW, INF_AT] = np.inf
    if case == "saturation":
        # samples at both rails of 8 bits (0 and 248), a few per row
        wf[:, 10:13] = 0.0
        wf[::2, 200:205] = 248.0
    if case == "trap_pickoff_per_row":
        wf[4, 60] = 1e4  # a maximum too early for the trapezoid to fit
    return wf, bl


def _op(case, dtype="float32", inf=False):
    """``(step, vals, op)``: the case's member on ``dtype`` rows (with
    ``inf``, an infinite sample in row ``INF_ROW``; on float64 rows its
    float32 outputs declared float64) and the values it reads."""
    procs, name, outs, code = OP_CASES[case]
    wf, bl = _rows(case, dtype, inf)
    if dtype == "float64":
        procs = widen(procs)
    step, vals, _, _ = one_op(procs, name, wf, bl, outs)
    return step, vals, code


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_op_matches_pallas_generic_rows(case):
    step, vals, code = _op(case)
    prog = check_against_pallas(step, vals, _jax_fn(step), code)
    op = prog.ops[-1]
    assert op.plan == (0 if case in SCALAR_OPS else 1)


@pytest.mark.parametrize("case", ["mean_below_threshold", "saturation", "presum",
                                  "log_check", "trap_pickoff", "min_max_norm",
                                  "linear_slope_diff", "get", "multi_a_filter"])
def test_op_float64_rows_split(case):
    """A float64 row (these ops split it until K7's float64 kernel took
    them), an infinite sample among its rows: the op lowers into a float64
    program; its plain walk meets the JAX package in float64, and the
    member's own body the plain walk (``check_float64_body``)."""
    step, vals, code = _op(case, "float64", inf=True)
    check_float64_body(step, vals, _jax_fn(step), codes=code)


@pytest.mark.parametrize("case", SCALAR_OPS)
def test_scalar_op_takes_float64(case):
    step, vals, code = _op(case, "float64")
    prog = check_against_pallas(step, vals, _jax_fn(step), code)
    assert prog.slots[prog.ops[-1].outs[0]].dtype == torch.float64


def test_where_condition_is_a_bool_input():
    """The comparison runs outside the one-op group: its bool is an
    external per-row scalar (slot type 2), the op's first operand."""
    step, vals, _ = _op("where")
    cond = [k for k, v in vals.items() if v.dtype == torch.bool]
    assert len(cond) == 1
    prog = _tile_program.lower([step], vals, [step.out_specs[0].key])
    s = prog.slots[prog.by_key[cond[0]]]
    assert s.kind == "scalar" and s.ext
    ints, _, _ = prog.encode()
    base = len(prog.ops) * _tile_program.OP_INTS
    assert ints[base + prog.by_key[cond[0]] * _tile_program.SLOT_INTS + 1] == 2


def test_k7_order_variants_hold_their_members():
    """The plain walk's K7-order variants (``mean_below_threshold``,
    ``linear_slope_diff``, ``trap_pickoff``, ``presum``) equal their members
    within float32 rounding, and K7's float64 sum and prefix equal numpy's
    within float64 rounding."""
    from dspeed_tpu_torch.processors import _numerics
    import dspeed_tpu_torch.processors as tp
    from dspeed_tpu_torch.processors.arithmetic import mean_below_threshold_k7
    from dspeed_tpu_torch.processors.linear_slope_fit import linear_slope_diff_k7
    from dspeed_tpu_torch.processors.misc import presum_k7
    from dspeed_tpu_torch.processors.trap_filters import trap_pickoff_k7

    rng = np.random.default_rng(2)
    for n in (1, 255, 256, 1001, 4100):
        x = torch.from_numpy(rng.normal(0, 100, (3, n)))
        np.testing.assert_allclose(_numerics.k7_sum(x).numpy(), x.numpy().sum(1),
                                   rtol=1e-13, atol=1e-10)
        np.testing.assert_allclose(_numerics.k7_prefix(x).numpy(),
                                   np.cumsum(x.numpy(), 1), rtol=1e-12, atol=1e-9)
    wf, _ = events()
    w = torch.from_numpy(wf)
    thr = torch.full((8,), 150.0)
    t = torch.tensor([150.0, 40.0, 200.5, 255.0, 30.0, 100.0, 120.0, 160.0])
    pairs = [(mean_below_threshold_k7(w, thr), tp.mean_below_threshold(w, thr)[0]),
             (linear_slope_diff_k7(w, 0.5, 100.0), tp.linear_slope_diff(w, 0.5, 100.0)),
             (trap_pickoff_k7(w, 20, 5, t), tp.trap_pickoff(w, 20, 5, t)[0]),
             (presum_k7(w, 1, dims={"m": 64}), tp.presum(w, 1, dims={"m": 64}))]
    for got, want in pairs:
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, v in zip(got, want):
            torch.testing.assert_close(g, v, rtol=2e-6, atol=1e-3, equal_nan=True)


def test_lowering_refuses_a_bit_depth_that_is_not_a_positive_integer():
    """As the member raises ``DSPFatal`` for it, the lowering refuses it."""
    step, vals, _ = _op("saturation")
    for bad in (np.float32(8.5), np.float32(0.0)):
        step.arg_specs[1].value = bad
        with pytest.raises(_tile_program.LoweringError, match="bit depth"):
            _tile_program.lower([step], vals, [sp.key for sp in step.out_specs])


# ---------------------------------------------------------------------------
# the coverage config


N_COVER = 64


def _cover_table(lh5, wf, bl):
    return lh5.Table({
        "waveform": lh5.WaveformTable(values=wf, t0=0.0, t0_units="ns", dt=16.0,
                                      dt_units="ns"),
        "baseline": lh5.Array(bl.astype("float32")),
    })


@pytest.fixture(scope="module")
def cover_events():
    wf, _amp, _t0, bl, _rt = cs.make_hpge_waveforms(N_COVER)
    wf[cs.NAN_SAMPLE_ROW, 500] = np.nan
    bl[cs.NAN_BASELINE_ROW] = np.nan
    wf[9, :] = wf[9, 0]  # a flat row: the searches find nothing
    return wf, bl


def _kinds(steps):
    return [(type(s).__name__, s.kernel.__name__ if hasattr(s, "kernel")
             else getattr(s, "name", "")) for s in steps]


def test_coverage_groups_match_jax_and_nothing_splits(monkeypatch, cover_events):
    from dspeed_tpu import lh5 as jlh5
    from dspeed_tpu.processing_chain import GroupStep as JaxGroupStep
    from dspeed_tpu.processing_chain import ProcChainVar as JaxVar
    from dspeed_tpu.processing_chain import build_processing_chain as jax_build
    from dspeed_tpu_torch.processing_chain import ProcChainVar as TorchVar
    from dspeed_tpu_torch.processing_chain import build_processing_chain as torch_build

    wf, bl = cover_events
    monkeypatch.setenv("DSPEED_TPU_FUSE", "generic")
    monkeypatch.setattr(JaxVar, "_counter", itertools.count())
    monkeypatch.setattr(TorchVar, "_counter", itertools.count())
    db = {"pz": {"tau": cs.TAU}}
    jc, _, _ = jax_build(cs.coverage_config(), _cover_table(jlh5, wf, bl), db_dict=db)
    tc, _, tout = torch_build(cs.coverage_config(),
                              _cover_table(dspeed_tpu_torch.lh5, wf, bl), db_dict=db,
                              device="cpu", fuse="generic")
    jg = [s for s in jc._steps if isinstance(s, JaxGroupStep)]
    tg = [s for s in tc._steps if isinstance(s, GroupStep)]
    assert [len(g.members) for g in tg] == [len(g.members) for g in jg] == [34, 19, 24, 26]
    assert _kinds(tc._steps) == _kinds(jc._steps)
    for t, j in zip(tg, jg):
        assert _kinds(t.members) == _kinds(j.members)
        assert t.ext_in == j.ext_in and t.escapes == j.escapes
    _tile_program.reset_splits()
    tc(_cover_table(dspeed_tpu_torch.lh5, wf, bl), tout)
    assert _tile_program.SPLITS == {}
    # every new op runs, each in a group
    codes = {_tile_program.OPCODES[c] for c in cs.COVER_OPS}
    seen = set()
    inputs, _ = tc._gather_inputs(0, len(wf))
    env = tc._to_device(inputs)
    env.update(tc._const_env())
    for step in tc._steps:
        if isinstance(step, GroupStep):
            prog = _tile_program.lower(step.members, {k: env[k] for k in step.ext_in},
                                       step.escapes)
            seen |= {op.code for op in prog.ops}
        step.run(env)
    assert codes <= seen, sorted(codes - seen)


def test_coverage_columns_match_jax(monkeypatch, cover_events):
    import dspeed_tpu

    wf, bl = cover_events
    db = {"pz": {"tau": cs.TAU}}
    cfg = cs.coverage_config()
    _tile_program.reset_splits()
    got = dspeed_tpu_torch.build_dsp(_cover_table(dspeed_tpu_torch.lh5, wf, bl),
                                     dsp_config=cfg, database=db, device="cpu",
                                     fuse="generic")
    assert _tile_program.SPLITS == {}
    unfused = dspeed_tpu_torch.build_dsp(_cover_table(dspeed_tpu_torch.lh5, wf, bl),
                                         dsp_config=cfg, database=db, device="cpu",
                                         fuse=False)
    monkeypatch.setenv("DSPEED_TPU_FUSE", "generic")
    want = dspeed_tpu.build_dsp(_cover_table(dspeed_tpu.lh5, wf, bl), dsp_config=cfg,
                                database=db)
    for k in cfg["outputs"]:
        g, u, w = got[k].nda, unfused[k].nda, np.asarray(want[k].nda)
        assert g.shape == w.shape, k
        for other, what in ((w, "jax"), (u, "unfused")):
            ok = np.isfinite(other) & np.isfinite(g)
            near_t0 = k.startswith("tp_") or k in ("pz_at_t0", "trapEpick", "trapEftp")
            # a time point within one sample; a column that reads tp_0_est
            # (pz_at_t0, the pick-offs) excused where tp_0_est moved a sample
            if near_t0:
                moved = np.abs(got["tp_0_est"].nda - np.asarray(
                    (want if what == "jax" else unfused)["tp_0_est"].nda)) > 0
                ok &= ~moved
            np.testing.assert_array_equal(np.isnan(g), np.isnan(other),
                                          err_msg=f"{k} NaN vs {what}")
            scale = max(np.abs(other[ok]).max(initial=0.0), 1.0)
            tol = 16.0 if k.startswith("tp_") else 1e-5 * scale
            err = np.abs(g[ok].astype(np.float64) - other[ok]).max(initial=0.0)
            assert err <= tol, f"{k} vs {what}: {err:.3e} > {tol:.3e}"
    for k in cs.COVER_OUTPUTS:
        assert np.isfinite(got[k].nda).mean() >= 0.9, k


# ---------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _same(a, b):
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_op_on_the_card_equals_the_plain_walk(case, cuda_device):
    """Each op alone, one launch, every output bit for bit against the
    tape's plain walk on the same card, at 37 rows of 1001 samples with an
    infinite sample."""
    procs, name, outs, _ = OP_CASES[case]
    rng = np.random.default_rng(len(case))
    n = 1001
    t = np.arange(n)[None, :]
    bl = rng.uniform(100, 200, 37)
    wf = bl[:, None] + rng.uniform(50, 500, (37, 1)) * np.clip((t - 300) / 20, 0, 1) \
        + rng.normal(0, 2, (37, n))
    wf[1, 500] = np.nan
    wf[3, 700] = np.inf
    wf[5, 40:60] = 0.0
    step, vals, _, _ = one_op(procs, name, wf.astype(np.float32),
                              bl.astype(np.float32), outs)
    vals = {k: v.to(cuda_device) for k, v in vals.items()}
    prog = _tile_program.lower([step], vals, [sp.key for sp in step.out_specs])
    before = _cuda.LAUNCHES["generic_rows"]
    got = _cuda.generic_rows(prog, vals)
    assert _cuda.LAUNCHES["generic_rows"] == before + 1
    want = _cuda.generic_rows_plain(prog, vals)
    torch.cuda.synchronize()
    for k in want:
        assert _same(got[k], want[k]), k


@pytest.mark.gpu
def test_coverage_groups_on_the_card(cuda_device):
    """The coverage config's four groups at 600 rows: every output of the
    new ops bit for bit against the plain walk, one launch a group."""
    wf, _amp, _t0, bl, _rt = cs.make_hpge_waveforms(600)
    wf[3, 500] = np.nan
    bl[5] = np.nan
    wf[7, 2000] = np.inf
    chain, _, _ = dspeed_tpu_torch.processing_chain.build_processing_chain(
        cs.coverage_config(), _cover_table(dspeed_tpu_torch.lh5, wf, bl),
        db_dict={"pz": {"tau": cs.TAU}}, device="cpu", fuse="generic")
    inputs, _ = chain._gather_inputs(0, len(wf))
    env = {k: v.to(cuda_device) for k, v in chain._to_device(inputs).items()}
    env.update({k: v.to(cuda_device) if isinstance(v, torch.Tensor) else v
                for k, v in chain._const_env().items()})
    codes = {_tile_program.OPCODES[c] for c in cs.COVER_OPS}
    with torch.no_grad():
        for step in chain._steps:
            if not isinstance(step, GroupStep):
                step.run(env)
                continue
            vals = {k: env[k] for k in step.ext_in}
            full = _tile_program.lower(step.members, vals,
                                       sorted(s.key for s in
                                              _tile_program.lower(step.members, vals,
                                                                  step.escapes).slots
                                              if not s.ext))
            got = _cuda.generic_rows(full, vals)
            want = _cuda.generic_rows_plain(full, vals)
            torch.cuda.synchronize()
            for op in full.ops:
                if op.code in codes:
                    for sid in op.outs:
                        key = full.slots[sid].key
                        assert _same(got[key], want[key]), key
            env.update({k: got[k] for k in step.escapes})
