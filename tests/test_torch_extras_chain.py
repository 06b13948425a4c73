"""The flagship extras (``chip_smoke.extras_config``: the flagship's 34
columns plus columns that run the 12 processors of ``poly_fit.py``,
``soft_pileup_corr.py``, ``corrections.py`` and the rest of ``time_point_thresh.py``)
through both packages' ``build_dsp``, file to file in chunks, on the CPU at
48 events, and its fusion plan and generic groups; on the card (the
``gpu`` test, which imports neither JAX nor the JAX package), its three K7
groups against the plain walk.

The column rule is the flagship's (``torch_flagship.assert_timing_columns``:
float columns within 1e-5 of their scale, ``tp_*`` exactly), the new index
and count columns (``bl_ncross``, ``bl_pol``, ``bl_trig``, ``centroid``)
exactly. The DPZ chain's rule for columns that read ``wf_pz``
(``tests/test_torch_dpz.py``'s module docstring: where the JAX package's
float32 column carries a known rounding, the port's is held to a float64
oracle, no further from it than the JAX package's) carries over to the two
columns that read ``tail_poly``, ``tail_pexp_mean`` and ``tail_pexp_rms``:
the JAX package fits the tail's log with float32 moments, whose error the
exponential spreads over the residual (~0.3 of ``tail_pexp_mean``'s scale).
Their oracle is numpy in float64 on the same rows. Every other extras column
meets the column rule against the JAX package, those that read ``wf_pz``
included.
"""

import os
import re
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from torch_flagship import assert_timing_columns  # noqa: E402

import dspeed_tpu_torch  # noqa: E402
from dspeed_tpu_torch import lh5  # noqa: E402
from dspeed_tpu_torch.processing_chain import GroupStep  # noqa: E402
from dspeed_tpu_torch.processing_chain import (  # noqa: E402
    build_processing_chain as torch_build_chain,
)
from dspeed_tpu_torch.processors import _cuda, _tile_program  # noqa: E402

N_EVENTS = 48
DB = {"geds": {"pz": {"tau": 27460.5}}}
EXACT = ("bl_ncross", "bl_pol", "bl_trig", "centroid")
TAIL = ("tail_pexp_mean", "tail_pexp_rms")


@pytest.fixture(autouse=True)
def fresh_chain_cache(monkeypatch):
    from dspeed_tpu_torch import build_dsp

    monkeypatch.setenv("DSPEED_TPU_CHAIN_CACHE", "0")
    cache = sys.modules[build_dsp.__module__]._CHAIN_CACHE
    cache.clear()
    yield
    cache.clear()


def _table(pkg_lh5, wf, bl):
    return pkg_lh5.Table({
        "waveform": pkg_lh5.WaveformTable(values=wf, t0=0.0, t0_units="ns", dt=16.0,
                                          dt_units="ns"),
        "baseline": pkg_lh5.Array(bl),
    })


def _events(n=N_EVENTS):
    """The flagship generator's events: a NaN sample in event 3 and a NaN
    baseline in event 5."""
    wf, amp, t0, bl, _ = cs.make_hpge_waveforms(n)
    bl = bl.astype("float32")
    wf[3, 500] = np.nan
    bl[5] = np.nan
    return wf, bl, t0


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The extras chain through both packages, file to file, in chunks of
    16 events (the production loop): ``(port, jax, port file, jax file,
    wf, bl, t0)``."""
    import h5py

    import dspeed_tpu

    wf, bl, t0 = _events()
    d = tmp_path_factory.mktemp("extras")
    raw = str(d / "extras_raw.lh5")
    lh5.write(_table(lh5, wf, bl), "geds/raw", raw)
    cfg = cs.extras_config()
    out_t, out_j = str(d / "t_dsp.lh5"), str(d / "j_dsp.lh5")
    _tile_program.reset_splits()
    dspeed_tpu_torch.build_dsp(raw, out_t, cfg, database=DB, buffer_len=16,
                               device="cpu")
    splits = dict(_tile_program.SPLITS)
    dspeed_tpu.build_dsp(raw, out_j, cfg, database=DB, buffer_len=16)

    def read(path):
        with h5py.File(path, "r") as f:
            return {k: f[f"geds/dsp/{k}"][()] for k in cfg["outputs"]}

    return read(out_t), read(out_j), out_t, out_j, wf, bl, t0, splits


def _tail_oracle(wf, bl):
    """``tail_pexp_mean`` and ``tail_pexp_rms`` in float64 numpy: the tail
    window's log fitted by a line (least squares), the residual of the
    window against the line's exponential, ``sum(r / (i+1))`` and
    ``sqrt(sum(r**2) / (n-1))``; NaN for a row that holds a NaN anywhere (the
    baseline subtraction poisons the row)."""
    lo, hi = cs.EXTRAS_TAIL
    x = wf.astype(np.float64)[:, lo:hi] - bl.astype(np.float64)[:, None]
    i = np.arange(hi - lo, dtype=np.float64)
    mean, rms = np.full(len(x), np.nan), np.full(len(x), np.nan)
    for r in range(len(x)):
        if np.isnan(wf[r]).any() or np.isnan(bl[r]):
            continue
        p1, p0 = np.polyfit(i, np.log(x[r]), 1)
        res = x[r] - np.exp(p0 + p1 * i)
        mean[r] = np.sum(res / (i + 1))
        rms[r] = np.sqrt(np.sum(res**2) / (len(i) - 1))
    return {"tail_pexp_mean": mean, "tail_pexp_rms": rms}


def test_extras_chain_matches_jax(runs):
    got, want, _, _, wf, bl, _, splits = runs
    assert splits == {}
    assert len(got) == 34 + len(cs.EXTRAS_OUTPUTS)
    rest = [k for k in got if k not in EXACT + TAIL]
    assert_timing_columns({k: got[k] for k in rest}, {k: want[k] for k in rest})
    for k in EXACT:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    oracle = _tail_oracle(wf, bl)
    for k in TAIL:
        o = oracle[k]
        np.testing.assert_array_equal(np.isnan(got[k]), np.isnan(o), err_msg=k)
        np.testing.assert_array_equal(np.isnan(want[k]), np.isnan(o), err_msg=k)
        ok = ~np.isnan(o)
        e_port = np.abs(got[k][ok] - o[ok]).max()
        e_jax = np.abs(want[k][ok] - o[ok]).max()
        assert e_port <= e_jax, (k, e_port, e_jax)


def test_extras_columns_are_finite_and_physical(runs):
    """At least 90% of the events give a finite value in each new column
    (the first slot of the (m) columns); every good event one trigger of
    polarity 1, and a centroid on its rise."""
    got, _, _, _, _, _, t0, _ = runs
    good = np.ones(N_EVENTS, bool)
    good[[3, 5]] = False
    for k in cs.EXTRAS_OUTPUTS:
        v = np.asarray(got[k], np.float64).reshape(N_EVENTS, -1)[:, 0]
        assert np.isfinite(v).mean() >= 0.9, k
    assert (got["bl_ncross"][good] == 1).all()
    assert (got["bl_pol"][good, 0] == 1).all() and np.isnan(got["bl_pol"][good, 1:]).all()
    assert got["bl_ncross"][3] == 0 and np.isnan(got["bl_trig"][3]).all()
    rise = got["centroid"][good] / 16.0 - t0[good]
    assert (np.abs(rise) < 64).all()


def test_m_columns_are_written_as_jax_writes_them(runs):
    """The (m) outputs go through the port's
    ``LGDOArrayOfEqualSizedArraysIOManager`` as through the JAX package's:
    the same datasets, shapes, types and attributes in the file."""
    import h5py

    _, _, out_t, out_j, _, _, _, _ = runs
    with h5py.File(out_t, "r") as ft, h5py.File(out_j, "r") as fj:
        for k in ("bl_pol", "bl_trig", "tp_multi", "bl_ncross"):
            a, b = ft[f"geds/dsp/{k}"], fj[f"geds/dsp/{k}"]
            assert a.shape == b.shape and a.dtype == b.dtype, k
            assert dict(a.attrs) == dict(b.attrs), k


def _unnumbered(key: str) -> str:
    return re.sub(r"#\d+", "", key)


def _plan(chain, group_type):
    """The fused step list: each step's kind and kernel, each group's
    members, inputs and escapes, numbering stripped."""
    out = []
    for s in chain._steps:
        if isinstance(s, group_type):
            out.append(("group", tuple(
                (type(m).__name__, getattr(getattr(m, "kernel", None), "__name__", ""))
                for m in s.members),
                tuple(sorted(map(_unnumbered, s.ext_in))),
                tuple(sorted(map(_unnumbered, s.escapes)))))
        else:
            out.append((type(s).__name__,
                        getattr(getattr(s, "kernel", None), "__name__", "")))
    return out


@pytest.mark.parametrize("fuse", [True, "generic"])
def test_extras_plan_is_the_jax_plan(fuse, monkeypatch):
    """The hand fronts, the K7 groups and their members, inputs and escapes
    of ``optimize_fusions`` equal the JAX package's for the same config;
    every group lowers to K7's tape (no split)."""
    from dspeed_tpu.processing_chain import GroupStep as JaxGroupStep
    from dspeed_tpu.processing_chain import build_processing_chain as jax_build

    import dspeed_tpu

    wf, bl, _ = _events(8)
    cfg = cs.extras_config()
    if fuse == "generic":
        monkeypatch.setenv("DSPEED_TPU_FUSE", "generic")
    jc, _, _ = jax_build(cfg, _table(dspeed_tpu.lh5, wf, bl), db_dict=DB["geds"])
    tc, _, _ = torch_build_chain(cfg, _table(lh5, wf, bl), db_dict=DB["geds"],
                                 device="cpu", fuse=fuse)
    assert _plan(tc, GroupStep) == _plan(jc, JaxGroupStep)
    groups = [s for s in tc._steps if isinstance(s, GroupStep)]
    if fuse is True:
        kinds = [k[1] for k in _plan(tc, GroupStep) if k[0] != "group"]
        for front in ("fused_energy_front", "fused_t0_front", "chained_time_point_thresh",
                      "fused_current_front", "fused_conv_bank"):
            assert front in kinds, front
        assert [len(g.members) for g in groups] == [9, 2, 22]
    inputs, _ = tc._gather_inputs(0, len(wf))
    env = tc._to_device(inputs)
    env.update(tc._const_env())
    ops = set()
    for step in tc._steps:
        if isinstance(step, GroupStep):
            prog = _tile_program.lower(step.members, {k: env[k] for k in step.ext_in},
                                       step.escapes)
            ops |= {op.code for op in prog.ops}
            env.update(_cuda.generic_rows_plain(prog, {k: env[k] for k in step.ext_in}))
        else:
            step.run(env)
    names = {v: k for k, v in _tile_program.OPCODES.items()}
    new = {"poly_residual", "soft_pileup", "wf_correction", "wf_centroid",
           "time_point_thresh"}
    assert new <= {names[c] for c in ops}


def test_extras_groups_plain_walk_equals_unfused():
    """The default mode's groups (plain walk) against the unfused chain:
    bit for bit on the CPU."""
    wf, bl, _ = _events(16)
    cfg = cs.extras_config()
    tb = _table(lh5, wf, bl)
    fused = dspeed_tpu_torch.build_dsp(tb, dsp_config=cfg, database=DB["geds"],
                                       device="cpu")
    unfused = dspeed_tpu_torch.build_dsp(tb, dsp_config=cfg, database=DB["geds"],
                                         device="cpu", fuse=False)
    for k in cs.EXTRAS_OUTPUTS:
        a, b = np.asarray(fused[k].nda), np.asarray(unfused[k].nda)
        assert a.tobytes() == b.tobytes(), k


# ---------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [37, 1])
def test_k7_extras_groups_on_the_card(cuda_device, rows):
    """Each of the extras' three groups as one K7 launch on the card, every
    intermediate against the plain walk by ``chip_smoke.check_generic``'s
    rule (the new ops among them), the chain's steps between the groups run
    on the card."""
    import torch

    wf, bl, _ = _events(max(rows, 8))
    wf, bl = wf[:rows], bl[:rows]
    chain, _, _ = torch_build_chain(cs.extras_config(), _table(lh5, wf, bl),
                                    db_dict=DB["geds"], device="cpu")
    inputs, _ = chain._gather_inputs(0, rows)
    env = {k: v.to(cuda_device) for k, v in chain._to_device(inputs).items()}
    env.update({k: v.to(cuda_device) if isinstance(v, torch.Tensor) else v
                for k, v in chain._const_env().items()})
    seen = set()
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
            cs.check_generic(full, vals, got, want, f"extras {len(seen)}")
            seen |= {op.code for op in full.ops}
            env.update(_cuda.generic_rows(prog, vals))
    names = {v: k for k, v in _tile_program.OPCODES.items()}
    assert {"poly_residual", "soft_pileup", "wf_correction",
            "wf_centroid"} <= {names[c] for c in seen}
