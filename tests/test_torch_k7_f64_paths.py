"""K7's float64 kernel on the float64 injection + ML, coverage and plane
paths (``chip_smoke.inject_ml_config``, ``coverage_config`` and
``plane_config`` with ``"float64"``): every op of a float program in its
float64 form (``_tile_program.F64_OPS``), bool planes among float64 ones.

- Each path at 32 events, in the generic mode and under the card's rule
  (``_hand_kernel_plane``: no hand kernel on a float64 plane) in the default
  mode: the port's groups are the JAX package's generic groups member for
  member, each run as float64 programs; nothing splits but the plane path's
  group C, whose float64 arena is over one block's shared memory
  (``_cuda._MAX_SMEM``): it bisects on that alone, and each part lowers. The
  columns meet the JAX package's at the golden replay's tolerance of their
  scale (rtol 1e-9, atol 1e-12; NaN and infinite positions exact), but for
  :data:`KNOWN`.
- ``where`` and ``round`` (the warp ops the float64 kernel took last) in a
  float64 program beside a plane op, against the JAX package.

The ``gpu`` tests run each float64 op case of ``tests/test_torch_k7_plane.py``,
``tests/test_torch_k7_cover.py`` and ``tests/test_torch_inject_ml.py`` on the
card, and the three paths' groups (each part of a group that bisects) at 600
rows: one launch a program, every output bit for bit against the plain walk.
They import neither JAX nor the JAX package.
"""

import itertools
import os
import sys

import numpy as np
import pytest
import torch

import dspeed_tpu_torch
from dspeed_tpu_torch.processing_chain import GroupStep, _step_writes
from dspeed_tpu_torch.processing_chain import build_processing_chain as torch_build
from dspeed_tpu_torch.processors import _cuda, _tile_program

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))
import chip_smoke as cs  # noqa: E402
import test_torch_inject_ml as iml  # noqa: E402
import test_torch_k7_cover as cover  # noqa: E402
import test_torch_k7_plane as plane  # noqa: E402
from torch_k7_ops import assert_f64_close, check_group, member_name  # noqa: E402

N_CFG = 32
# path -> (config, the generic groups' members, the database's maker, the
# group allowed to bisect on shared memory)
CONFIGS = {
    "inject_ml": (cs.inject_ml_config, (34, 19, 25, 22), lambda: cs.inject_ml_db(), None),
    "coverage": (cs.coverage_config, (34, 19, 24, 26), lambda: {"pz": {"tau": cs.TAU}},
                 None),
    "plane": (cs.plane_config, cs.PLANE_MEMBERS, lambda: {"pz": {"tau": cs.TAU}}, 2),
}
INF_ROW = 11  # the event with an infinite sample (cfg_events)
# (path, column) -> the events where the port's float64 chain departs from
# the JAX package's (ROADMAP §3), each held to what the port gives there:
# "inf_row", the DPLMS convolution's maximum on the infinite sample's event,
# +inf (K7's float64 convolution is a direct sum, a known difference)
# where the JAX package's banded product gives NaN; "nan_t0", the events
# whose tp_0_est is NaN (the NaN rows, the flat and the infinite one), where
# PyTorch's CPU conversion of a NaN time to an int64 index gives
# iinfo(int64).min and XLA's 0, and the sample read at that index
KNOWN = {("inject_ml", "dplmsEmax"): "inf_row", ("plane", "t0_idx"): "nan_t0",
         ("plane", "t0_late"): "nan_t0"}


@pytest.fixture(autouse=True)
def fresh_chain_cache():
    from dspeed_tpu_torch import build_dsp

    cache = sys.modules[build_dsp.__module__]._CHAIN_CACHE
    cache.clear()
    yield
    cache.clear()


@pytest.fixture(scope="module")
def jax_columns():
    """The JAX package's generic-mode columns by path, made once for both
    modes' tests (its build is most of their time)."""
    return {}


@pytest.fixture(scope="module")
def cfg_events():
    wf, _amp, _t0, bl, _rt = cs.make_hpge_waveforms(N_CFG)
    wf = wf.astype(np.float64)
    wf[cs.NAN_SAMPLE_ROW, 500] = np.nan
    bl = bl.copy()
    bl[cs.NAN_BASELINE_ROW] = np.nan
    wf[9, :] = wf[9, 0]  # a flat row: the searches find nothing
    wf[11, 2000] = np.inf
    return wf, bl


def _table(lh5, wf, bl):
    return lh5.Table({
        "waveform": lh5.WaveformTable(values=wf, t0=0.0, t0_units="ns", dt=16.0,
                                      dt_units="ns"),
        "baseline": lh5.Array(bl.astype("float32")),
    })


def _kinds(steps):
    return [(type(s).__name__, member_name(s) or getattr(s, "name", "")) for s in steps]


def _card_rule(monkeypatch):
    """The fusion pass's card rule on the CPU: no hand pattern over a
    float64 plane."""
    from dspeed_tpu_torch.processing_chain import ProcessingChain as PC

    monkeypatch.setattr(PC, "_hand_kernel_plane",
                        lambda self, spec: np.dtype(spec.dtype) == np.float32)


def _run_parts(chain, env, split_group):
    """Run ``chain``'s steps on ``env``, each group as the launches
    ``GroupStep._exec`` makes (``chip_smoke.k7_parts``), each a float64
    program walked plainly; only group ``split_group`` may bisect, and then
    on shared memory alone. Returns the programs' count per group."""
    parts = []
    for step in chain._steps:
        if not isinstance(step, GroupStep):
            step.run(env)
            continue
        refusals = []
        n = 0
        for _members, vals, prog in cs.k7_parts(step, env, refusals):
            assert prog.f64
            env.update(_cuda.generic_rows_plain(prog, vals))
            n += 1
        if len(parts) == split_group:
            assert refusals and all("shared memory" in r for r in refusals), refusals
        else:
            assert not refusals, refusals
        parts.append(n)
    return parts


@pytest.mark.parametrize("mode", ["generic", "card_rule"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_float64_path_groups_and_columns_match_jax(monkeypatch, cfg_events, jax_columns,
                                                   name, mode):
    """The port's groups are the JAX package's generic groups member for
    member and run as float64 programs; only the plane path's group C
    splits, on shared memory; the columns meet the JAX package's generic
    mode at the golden replay's tolerance of the column's scale."""
    import dspeed_tpu
    from dspeed_tpu.processing_chain import GroupStep as JaxGroupStep
    from dspeed_tpu.processing_chain import ProcChainVar as JaxVar
    from dspeed_tpu.processing_chain import build_processing_chain as jax_build
    from dspeed_tpu_torch.processing_chain import ProcChainVar as TorchVar

    make, members, make_db, split_group = CONFIGS[name]
    wf, bl = cfg_events
    db = make_db()
    monkeypatch.setenv("DSPEED_TPU_FUSE", "generic")
    monkeypatch.setattr(JaxVar, "_counter", itertools.count())
    monkeypatch.setattr(TorchVar, "_counter", itertools.count())
    jc, _, _ = jax_build(make("float64"), _table(dspeed_tpu.lh5, wf, bl), db_dict=db)
    fuse = "generic"
    if mode == "card_rule":
        _card_rule(monkeypatch)
        fuse = True
    tc, _, _ = torch_build(make("float64"), _table(dspeed_tpu_torch.lh5, wf, bl),
                           db_dict=db, device="cpu", fuse=fuse)
    jg = [s for s in jc._steps if isinstance(s, JaxGroupStep)]
    tg = [s for s in tc._steps if isinstance(s, GroupStep)]
    assert [len(g.members) for g in tg] == [len(g.members) for g in jg] == list(members)
    for t, j in zip(tg, jg):
        assert _kinds(t.members) == _kinds(j.members)
    inputs, _ = tc._gather_inputs(0, tc._buffer_len)
    env = tc._to_device(inputs)
    env.update(tc._const_env())
    parts = _run_parts(tc, env, split_group)
    assert [p > 1 for p in parts] == [q == split_group for q in range(len(parts))]
    cfg = make("float64")
    _tile_program.reset_splits()
    got = dspeed_tpu_torch.build_dsp(_table(dspeed_tpu_torch.lh5, wf, bl), dsp_config=cfg,
                                     database=db, device="cpu", fuse=fuse)
    assert all("shared memory" in k for k in _tile_program.SPLITS), _tile_program.SPLITS
    assert bool(_tile_program.SPLITS) == (split_group is not None)
    if name not in jax_columns:
        jax_columns[name] = dspeed_tpu.build_dsp(_table(dspeed_tpu.lh5, wf, bl),
                                                 dsp_config=cfg, database=db)
    want = jax_columns[name]
    t0 = np.asarray(want["tp_0_est"].nda)
    for k in cfg["outputs"]:
        g, w = np.asarray(got[k].nda), np.asarray(want[k].nda)
        assert g.shape == w.shape, k
        assert g.dtype == np.float64 or g.dtype.kind in "iu", k
        rows = np.zeros(len(g), bool)
        if KNOWN.get((name, k)) == "inf_row":
            rows[INF_ROW] = True
            assert np.isposinf(g[INF_ROW]) and np.isnan(w[INF_ROW]), k
        elif KNOWN.get((name, k)) == "nan_t0":
            rows = np.isnan(t0)
            assert rows.sum() == 4, k
            if k == "t0_idx":
                assert (g[rows] == np.iinfo(np.int64).min).all() and (w[rows] == 0).all()
        assert_f64_close(g[~rows], w[~rows], f"{name} {k}")


def test_plane_group_c_bisects_on_shared_memory_alone():
    """The float64 plane path's group C (107 members): its float64 arena
    alone is over one block's shared memory, where the float32 group's
    fits; the lowering refuses it for that, and for nothing else."""
    wf, _amp, _t0, bl, _rt = cs.make_hpge_waveforms(4)
    chain, _, _ = torch_build(cs.plane_config("float64"),
                              _table(dspeed_tpu_torch.lh5, wf.astype(np.float64), bl),
                              db_dict={"pz": {"tau": cs.TAU}}, device="cpu",
                              fuse="generic")
    inputs, _ = chain._gather_inputs(0, len(wf))
    env = chain._to_device(inputs)
    env.update(chain._const_env())
    groups = [s for s in chain._steps if isinstance(s, GroupStep)]
    for step in chain._steps:
        if step is groups[2]:
            break
        step.run(env)
    c = groups[2]
    with pytest.raises(_tile_program.LoweringError, match="shared memory"):
        _tile_program.lower(c.members, {k: env[k] for k in c.ext_in}, c.escapes)
    refusals = []
    progs = [p for _m, vals, p in cs.k7_parts(c, env, refusals)
             if env.update(_cuda.generic_rows_plain(p, vals)) is None]
    assert len(progs) >= 2 and all(p.f64 for p in progs)
    assert all(p.smem_bytes + _tile_program.STATIC_SMEM <= _cuda._MAX_SMEM for p in progs)


def test_where_and_round_in_a_float64_program():
    """``where`` and a rounder on the per-row scalars of a float64 plane op,
    in one float64 program: the warp ops against the JAX package."""
    procs = {**cover._MEAN, **cover._TOT,
             "m_sel": "where(b_mb > 0, b_mb, n_tot)",
             "m_r": cover._p("round_to_nearest", ["b_mb", "0.25", "m_r"])}
    wf, bl = cover._rows("mean_below_threshold", "float64", inf=True)
    cfg = {"outputs": ["m_sel", "m_r"], "processors": {
        "wf_blsub": cover._p("bl_subtract", ["waveform", "baseline",
                                            "wf_blsub(unit='ADC')"]), **procs}}
    chain, _, _ = torch_build(cfg, _table(dspeed_tpu_torch.lh5, wf, bl), device="cpu",
                              fuse=False)
    inputs, _ = chain._gather_inputs(0, len(wf))
    env = chain._run_steps(chain._to_device(inputs))
    steps = [s for s in chain._steps if member_name(s) in (
        "mean_below_threshold", "time_over_threshold", "where", "round_to_nearest")]
    ext, written = set(), set()
    for s in steps:
        ext |= chain._step_env_reads(s) - written
        written |= _step_writes(s)
    vals = {k: env[k] for k in sorted(ext)}
    prog = check_group(steps, vals, ("mean_below_threshold", "count", "where", "round"),
                       f64=True)
    assert prog.f64


# ---------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _same(a, b):
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def _launch_once(prog, dev):
    before = _cuda.LAUNCHES["generic_rows"]
    got = _cuda.generic_rows(prog, dev)
    assert _cuda.LAUNCHES["generic_rows"] == before + 1
    want = _cuda.generic_rows_plain(prog, dev)
    torch.cuda.synchronize()
    return got, want


# the float64 op cases: every case of the plane and coverage files whose
# members lower into a float64 program on float64 rows, and the injectors
# and layers
PLANE_F64 = sorted(c for c in plane.OP_CASES if not c.startswith(("scalar_", "convert_"))
                   and c not in ("isnan_scalar", "logical_of_bool_planes",
                                 "reduce_mean_of_a_slice", "reduce_sum_of_bools"))
COVER_F64 = sorted(c for c in cover.OP_CASES if c not in cover.SCALAR_OPS)


@pytest.mark.gpu
@pytest.mark.parametrize("case", [f"plane {c}" for c in PLANE_F64]
                         + [f"cover {c}" for c in COVER_F64]
                         + [f"inject_ml {c}" for c in sorted(iml.OP_CASES)])
def test_k7_f64_new_op_on_the_card(case, cuda_device):
    """Each float64 op case on the card: one launch of the float64 kernel,
    every output bit for bit against the plain walk."""
    where, name = case.split(" ")
    if where == "plane":
        steps, vals, _ = plane._group(name, "float64")
    elif where == "cover":
        step, vals, _ = cover._op(name, "float64", inf=True)
        steps = [step]
    else:
        step, vals, _ = iml._op(name, "float64", inf=True)
        steps = [step]
    writes = sorted(set().union(*(_step_writes(s) for s in steps)))
    dev = {k: v.to(cuda_device) for k, v in vals.items()}
    prog = _tile_program.lower(steps, dev, writes)
    assert prog.f64
    got, want = _launch_once(prog, dev)
    for k in writes:
        assert _same(got[k], want[k]), k


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_k7_f64_path_groups_on_the_card(name, cuda_device):
    """The float64 path's groups on the card at 600 rows: one launch a
    program (the plane path's group C a launch a part), every stored output
    bit for bit against the plain walk."""
    make, members, make_db, split_group = CONFIGS[name]
    wf, _amp, _t0, bl, _rt = cs.make_hpge_waveforms(600)
    wf = wf.astype(np.float64)
    wf[3, 500] = np.nan
    bl[5] = np.nan
    chain, _, _ = torch_build(make("float64"), _table(dspeed_tpu_torch.lh5, wf, bl),
                              db_dict=make_db(), device="cpu", fuse="generic")
    inputs, _ = chain._gather_inputs(0, len(wf))
    env = {k: v.to(cuda_device) for k, v in chain._to_device(inputs).items()}
    env.update({k: v.to(cuda_device) if isinstance(v, torch.Tensor) else v
                for k, v in chain._const_env().items()})
    n = 0
    with torch.no_grad():
        for step in chain._steps:
            if not isinstance(step, GroupStep):
                step.run(env)
                continue
            refusals = []
            for _members, vals, prog in cs.k7_parts(step, env, refusals):
                assert prog.f64
                got, want = _launch_once(prog, vals)
                for k in prog.escapes:
                    assert _same(got[k], want[k]), k
                env.update(got)
            assert bool(refusals) == (n == split_group), refusals
            n += 1
    assert n == len(members)
