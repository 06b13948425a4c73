"""The flagship injection + ML path (``chip_smoke.inject_ml_config``: the
flagship's 34 columns plus the four pulse injectors, a DPLMS filter, an NNLS
template fit and a small classifier, with ``chip_smoke.inject_ml_db``'s
database) through both packages' ``build_dsp`` on the CPU at 64 events,
column by column, and its fusion plan against the JAX package's; on the
card (the ``gpu`` test, which imports neither JAX nor the JAX package), its
two K7 groups against the plain walk.

The column rule is the flagship's (``torch_flagship.assert_timing_columns``:
float columns within 1e-5 of their scale, ``tp_*`` exactly) for every
column but ``nnls_coef``: the JAX package solves the NNLS fit in the
matrix's type (float32 in this chain), whose normal equations over the eight
nearly collinear shifted templates leave it ~3e-5 of the column's scale from
the float64 solution (3.4e-5 on these events); the port solves in float64, so its ``nnls_coef`` is
held to the JAX package's float64 chain on the same rows, at the float32
tolerance, and no further from it than the JAX package's float32 column.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from test_torch_extras_chain import _plan, _table  # noqa: E402
from torch_flagship import assert_timing_columns  # noqa: E402

import dspeed_tpu_torch  # noqa: E402
from dspeed_tpu_torch import lh5  # noqa: E402
from dspeed_tpu_torch.processing_chain import GroupStep  # noqa: E402
from dspeed_tpu_torch.processing_chain import (  # noqa: E402
    build_processing_chain as torch_build_chain,
)
from dspeed_tpu_torch.processors import _cuda, _tile_program  # noqa: E402

N_EVENTS = 64


@pytest.fixture(autouse=True)
def fresh_chain_cache(monkeypatch):
    from dspeed_tpu_torch import build_dsp

    monkeypatch.setenv("DSPEED_TPU_CHAIN_CACHE", "0")
    cache = sys.modules[build_dsp.__module__]._CHAIN_CACHE
    cache.clear()
    yield
    cache.clear()


@pytest.fixture(scope="module")
def db():
    return cs.inject_ml_db(512)


def _events(n=N_EVENTS):
    """The flagship generator's events: a NaN sample in event 3 and a NaN
    baseline in event 5."""
    wf, amp, t0, bl, _ = cs.make_hpge_waveforms(n)
    bl = bl.astype("float32")
    wf[3, 500] = np.nan
    bl[5] = np.nan
    return wf, bl, amp


@pytest.fixture(scope="module")
def runs(db):
    """The chain through both packages, Table -> Table: ``(port, jax, jax
    float64, splits, amp)``."""
    import dspeed_tpu

    wf, bl, amp = _events()
    cfg = cs.inject_ml_config()
    _tile_program.reset_splits()
    out_t = dspeed_tpu_torch.build_dsp(_table(lh5, wf, bl), dsp_config=cfg, database=db,
                                       device="cpu")
    splits = dict(_tile_program.SPLITS)
    out_j = dspeed_tpu.build_dsp(_table(dspeed_tpu.lh5, wf, bl), dsp_config=cfg,
                                 database=db)
    out_64 = dspeed_tpu.build_dsp(
        _table(dspeed_tpu.lh5, wf.astype(np.float64), bl.astype(np.float64)),
        dsp_config=cs.inject_ml_config("float64"), database=db,
        outputs=["nnls_coef"])

    def cols(out, keys):
        return {k: np.asarray(out[k].nda) for k in keys}

    return (cols(out_t, cfg["outputs"]), cols(out_j, cfg["outputs"]),
            cols(out_64, ["nnls_coef"]), splits, amp)


def test_inject_ml_chain_matches_jax(runs):
    got, want, want64, splits, _ = runs
    assert splits == {}
    assert len(got) == 34 + len(cs.INJECT_ML_OUTPUTS)
    rest = [k for k in got if k != "nnls_coef"]
    assert_timing_columns({k: got[k] for k in rest}, {k: want[k] for k in rest})
    g, w32, w64 = got["nnls_coef"], want["nnls_coef"], want64["nnls_coef"]
    assert g.shape == (N_EVENTS, cs.NNLS_SHIFTS) and g.dtype == np.float32
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w64))
    ok = ~np.isnan(w64)
    scale = np.abs(w64[ok]).max()
    e_port = np.abs(g[ok] - w64[ok]).max()
    assert e_port <= 1e-5 * scale, (e_port, scale)
    assert e_port <= np.abs(w32[ok] - w64[ok]).max()


def test_inject_ml_columns_are_finite_and_physical(runs):
    """Every new column finite on every good event; each injected plane's
    maximum at least the pulse's (``trapEmax``); ``dplmsEmax`` within 3% of
    the amplitude."""
    got, _, _, _, amp = runs
    good = np.ones(N_EVENTS, bool)
    good[[3, 5]] = False
    for k in cs.INJECT_ML_OUTPUTS:
        v = np.asarray(got[k], np.float64).reshape(N_EVENTS, -1)
        assert np.isfinite(v[good]).all(), k
        assert np.isnan(v[~good]).all(), k
    for q in ("sig", "exp", "gum", "log"):
        assert (got[f"{q}_amax"][good] >= 0.99 * got["trapEmax"][good] - 20).all(), q
    r = got["dplmsEmax"][good] / amp[good]
    assert (np.abs(r - 1) < 0.03).all()
    assert ((got["nn_score"][good] > 0) & (got["nn_score"][good] < 1)).all()


@pytest.mark.parametrize("fuse", [True, "generic"])
def test_inject_ml_plan_is_the_jax_plan(fuse, db, monkeypatch):
    """The hand fronts and the K7 groups (their members, inputs and
    escapes) of ``optimize_fusions`` equal the JAX package's for the same
    config; every group lowers to K7's tape (no split), the inject and
    dense ops among its ops."""
    from dspeed_tpu.processing_chain import GroupStep as JaxGroupStep
    from dspeed_tpu.processing_chain import build_processing_chain as jax_build

    import dspeed_tpu

    wf, bl, _ = _events(8)
    cfg = cs.inject_ml_config()
    if fuse == "generic":
        monkeypatch.setenv("DSPEED_TPU_FUSE", "generic")
    jc, _, _ = jax_build(cfg, _table(dspeed_tpu.lh5, wf, bl), db_dict=db)
    tc, _, _ = torch_build_chain(cfg, _table(lh5, wf, bl), db_dict=db, device="cpu",
                                 fuse=fuse)
    assert _plan(tc, GroupStep) == _plan(jc, JaxGroupStep)
    groups = [s for s in tc._steps if isinstance(s, GroupStep)]
    assert [len(g.members) for g in groups] == ([28, 22] if fuse is True
                                                 else [34, 19, 25, 22])
    inputs, _ = tc._gather_inputs(0, len(wf))
    env = tc._to_device(inputs)
    env.update(tc._const_env())
    ops = set()
    for step in tc._steps:
        if isinstance(step, GroupStep):
            vals = {k: env[k] for k in step.ext_in}
            prog = _tile_program.lower(step.members, vals, step.escapes)
            ops |= {op.code for op in prog.ops}
            env.update(_cuda.generic_rows_plain(prog, vals))
        else:
            step.run(env)
    names = {v: k for k, v in _tile_program.OPCODES.items()}
    assert {"inject", "dense", "conv"} <= {names[c] for c in ops}


# ---------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [37, 1])
def test_k7_inject_ml_groups_on_the_card(cuda_device, rows, db):
    """Each of the path's two groups as one K7 launch on the card, every
    intermediate against the plain walk by ``chip_smoke.check_generic``'s
    rule and the inject and dense ops' outputs bit for bit, the chain's
    steps between the groups run on the card."""
    import torch

    wf, bl, _ = _events(max(rows, 8))
    wf, bl = wf[:rows], bl[:rows]
    chain, _, _ = torch_build_chain(cs.inject_ml_config(), _table(lh5, wf, bl),
                                    db_dict=db, device="cpu")
    inputs, _ = chain._gather_inputs(0, rows)
    env = {k: v.to(cuda_device) for k, v in chain._to_device(inputs).items()}
    env.update({k: v.to(cuda_device) if isinstance(v, torch.Tensor) else v
                for k, v in chain._const_env().items()})
    codes = (_tile_program.OPCODES["inject"], _tile_program.OPCODES["dense"])
    n_bits = 0
    with torch.no_grad():
        for step in chain._steps:
            if not isinstance(step, GroupStep):
                step.run(env)
                continue
            vals = {k: env[k] for k in step.ext_in}
            prog = _tile_program.lower(step.members, vals, step.escapes)
            every = sorted(s.key for s in prog.slots if not s.ext)
            full = _tile_program.lower(step.members, vals, every)
            before = _cuda.LAUNCHES["generic_rows"]
            got = _cuda.generic_rows(full, vals)
            assert _cuda.LAUNCHES["generic_rows"] == before + 1
            want = _cuda.generic_rows_plain(full, vals)
            cs.check_generic(full, vals, got, want, f"inject_ml {n_bits}")
            for op in full.ops:
                if op.code in codes:
                    for sid in op.outs:
                        key = full.slots[sid].key
                        assert cs.same_bits(got[key], want[key]), key
                        n_bits += 1
            env.update(_cuda.generic_rows(prog, vals))
    assert n_bits == 9
