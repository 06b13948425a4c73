"""K7 on float64 planes: the ops of the float64 flagship's, DPZ's and extras'
generic groups (of ``_tile_program.F64_OPS``), run by K7's float64 kernel
(``generic_rows_kernel_f64``) on the card and by the tape's plain walk here,
each member in its K7-order float64 variant (``k7_plain`` given ``f64``:
K7's prefix and block sums, true divisions, sums in a fixed order).

- Each op alone on float64 rows (``tests/torch_k7_ops.py``, 8 x 256, a NaN
  sample, an infinite sample and a flat row among them): the plain walk
  against the JAX package's ``_pallas.generic_rows`` in interpret mode in
  float64, and the member kernel's own body against the plain walk, each at
  the golden replay's tolerance of the column's scale (rtol 1e-9, atol
  1e-12; NaN and infinite positions exact). On the row with the infinite
  sample a convolution and ``double_pole_zero`` depart from the JAX package
  by ROADMAP §3's known difference, and that row is held to it
  (``_check_inf_row``). A slice of a float64 plane is a view in the
  program; a plane of another type mixed in splits.
- The float64 flagship, DPZ and extras (``chip_smoke.flagship_config``,
  ``dpz_config``, ``extras_config`` with ``"float64"``) at 32 events: the
  port's generic groups are the JAX package's member for member, lower as
  float64 programs, nothing splits, and the columns meet the JAX package's
  generic mode at that tolerance; the same with the fusion pass's card rule
  (``_hand_kernel_plane``: no hand kernel on a float64 plane) in the
  default mode.
- ``tests/test_torch_k7_f64_emulation.py`` runs the float64 kernel on the CPU
  (``tools/k7_emu``'s ``f64`` case) bit for bit against the plain walk.

The ``gpu`` tests hold each op and the groups on the card bit for bit
against the plain walk; they import neither JAX nor the JAX package.
"""

import itertools
import os
import sys

import numpy as np
import pytest
import torch

import dspeed_tpu_torch
from dspeed_tpu_torch.processing_chain import (
    GroupStep, ProcessingChain, SliceStep, _step_writes,
)
from dspeed_tpu_torch.processing_chain import build_processing_chain as torch_build
from dspeed_tpu_torch.processors import _cuda, _tile_program

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))
import chip_smoke as cs  # noqa: E402
from torch_k7_ops import (  # noqa: E402
    assert_f64_close, check_group, events, member_name, member_outputs, table,
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


def _amax(src, out):
    return {"function": "amax", "module": "numpy", "args": [src, 1, out],
            "kwargs": {"signature": "(n),()->()", "types": ["di->d"]}}


_T_EV = "baseline * 0.0 + "  # a per-row scalar from the float64 baseline
_TAU_DPZ = ["300.0", "20.0", "0.05"]

# case -> (processors, the members' names (a slice as "slice"; steps run as
# one group, in chain order), the ops they lower to)
OP_CASES = {
    "bl_subtract": ({}, ("bl_subtract",), ("bl_subtract",)),
    "windower": ({"wf_le": _p("windower", ["wf_blsub", _T_EV + "80", "wf_le(60, 'd')"]),
                  "wf_le2": _p("windower", ["wf_blsub", _T_EV + "220",
                                            "wf_le2(60, 'd')"])},
                 ("windower",), ("windower", "windower")),
    "avg_current": ({"curr": _p("avg_current", ["wf_blsub", "3",
                                                "curr(len(wf_blsub)-1, 'd')"])},
                    ("avg_current",), ("avg_current",)),
    "min_max": ({"tp_min, tp_max, wf_min, wf_max": _p(
        "min_max", ["wf_blsub", "tp_min", "tp_max", "wf_min", "wf_max"])},
        ("min_max",), ("min_max",)),
    "amax": ({"y": _amax("wf_blsub", "y")}, ("amax",), ("amax",)),
    "linear_slope_fit_of_a_slice": (
        {"b_mean, b_std, b_slope, b_icpt": _p(
            "linear_slope_fit", ["wf_blsub[20:120]", "b_mean", "b_std", "b_slope",
                                 "b_icpt"])},
        ("bl_subtract", "slice", "linear_slope_fit"),
        ("bl_subtract", "linear_slope_fit")),
    "pole_zero": ({"wf_pz": _p("pole_zero", ["wf_blsub", "300.0", "wf_pz"])},
                  ("pole_zero",), ("pole_zero",)),
    "trap_norm": ({"y": _p("trap_norm", ["wf_blsub", "20", "10", "y"])},
                  ("trap_norm",), ("trap",)),
    "trap_norm_short": ({"y": _p("trap_norm", ["wf_blsub", "40", "4", "y"])},
                        ("trap_norm",), ("trap",)),
    "asym_trap_filter": ({"y": _p("asym_trap_filter", ["wf_blsub", "8", "4", "40", "y"])},
                         ("asym_trap_filter",), ("trap",)),
    "trap_filter": ({"y": _p("trap_filter", ["wf_blsub", "20", "10", "y"])},
                    ("trap_filter",), ("trap",)),
    **{f"convolve_wf_{m}": (
        {"y": _p("convolve_wf", ["wf_blsub", "db.k40", f"'{m}'", f"y({p}, 'd')"])},
        ("convolve_wf",), ("conv",)) for m, p in (("s", 256), ("f", 295), ("v", 217))},
    "fft_convolve_wf_v": (
        {"y": _p("fft_convolve_wf", ["wf_blsub", "db.k40", "'v'", "y(217, 'd')"])},
        ("fft_convolve_wf",), ("conv",)),
    **{f"moving_window_multi_{t}": (
        {"y": _p("moving_window_multi", ["wf_blsub", "8", "3", str(t), "y"])},
        ("moving_window_multi",), ("moving_window_multi",)) for t in (0, 1, 2)},
    **{f"time_point_thresh_{w}": (
        {"y": _p("time_point_thresh", ["wf_blsub", _T_EV + "60",
                                       _T_EV + ("90" if w else "200"), str(w), "y"])},
        ("time_point_thresh",), ("time_point_thresh",)) for w in (0, 1)},
    **{f"interpolated_time_point_thresh_{m}_{w}": (
        {"y": _p("interpolated_time_point_thresh", [
            "wf_blsub", _T_EV + "60", _T_EV + ("90" if w else "200"), str(w), f"'{m}'",
            "y"])},
        ("interpolated_time_point_thresh",), ("time_point_thresh",))
       for m, w in [(m, 1) for m in "iabrnlfc"] + [(m, 0) for m in "ilr"]},
    **{f"fixed_time_pickoff_{m}": (
        {"y": _p("fixed_time_pickoff", ["wf_blsub", _T_EV + t, f"'{m}'", "y"])},
        ("fixed_time_pickoff",), ("fixed_time_pickoff",))
       for m, t in (("l", "120.25"), ("i", "121.0"), ("n", "122.5"), ("f", "123.75"),
                    ("c", "124.5"), ("h", "125.4"))},
    **{f"fixed_time_pickoff_h_{t}": (
        {"y": _p("fixed_time_pickoff", ["wf_blsub", t, "'h'", "y"])},
        ("fixed_time_pickoff",), ("fixed_time_pickoff",))
       for t in ("0.4", "254.6", "255.0")},
    "double_pole_zero": ({"y": _p("double_pole_zero", ["wf_blsub", *_TAU_DPZ, "y"])},
                         ("double_pole_zero",), ("double_pole_zero",)),
    "poly_diff": ({"bl_poly": {"function": "poly_fit", "module": K,
                               "init_args": ["100", "2"],
                               "args": ["wf_blsub[0:100]", "bl_poly(3, 'd')"]},
                   "p_mean, p_rms": _p("poly_diff", ["wf_blsub[0:100]", "bl_poly",
                                                     "p_mean", "p_rms"])},
                  ("poly_diff",), ("poly_residual",)),
    "poly_exp_rms": ({"e_poly": {"function": "poly_fit", "module": K,
                                 "init_args": ["106", "1"],
                                 "args": ["wf_blsub[150:256] * 0.01", "e_poly(2, 'd')"]},
                      "e_mean, e_rms": _p("poly_exp_rms", ["wf_blsub[150:256]", "e_poly",
                                                           "e_mean", "e_rms"])},
                     ("poly_exp_rms",), ("poly_residual",)),
    "soft_pileup_corr": ({"y": _p("soft_pileup_corr", ["wf_blsub", "90", "300.0", "y"])},
                         ("soft_pileup_corr",), ("soft_pileup", "soft_pileup_out")),
    "soft_pileup_corr_bl": (
        {"y": _p("soft_pileup_corr_bl", ["wf_blsub", "90", "300.0", "bmean", "y"]),
         "bmean": "baseline * 0.01"},
        ("soft_pileup_corr_bl",), ("soft_pileup", "soft_pileup_out")),
    "wf_correction": (
        {"step_kernel": _p("step", ["16", "step_kernel(64, 'd')"]),
         "y": _p("wf_correction", ["wf_blsub", "step_kernel", "90", "154", "y"])},
        ("wf_correction",), ("wf_correction",)),
    "wf_centroid": (
        {"step_kernel": _p("step", ["16", "step_kernel(64, 'd')"]),
         "wf_step": _p("convolve_wf", ["wf_blsub", "step_kernel", "'v'",
                                       "wf_step(193, 'd')"]),
         "y": _p("get_wf_centroid", ["wf_step", "shift_ev", "y"]),
         "shift_ev": "baseline * 0.02"},
        ("convolve_wf", "get_wf_centroid"), ("conv", "wf_centroid")),
}


def _db():
    return {"k40": np.random.default_rng(5).normal(0, 0.2, 40)}


def _rows(case, dtype="float64"):
    """The case's rows, an infinite sample among them (row ``INF_ROW``)."""
    wf, bl = events(dtype)
    wf[INF_ROW, INF_AT] = np.inf
    return wf, bl


def _inf_row_differs(case) -> bool:
    """Whether K7's float64 form of the case's op departs from the JAX
    package on the row with an infinite sample (ROADMAP §3's known
    differences): a convolution, whose direct sum is finite off the
    sample's window where the banded matrix product multiplies the band's
    zeros by it (NaN, in the JAX package and in the port's member alike),
    and ``double_pole_zero``, where the JAX package's pole by blocks of 128
    poisons the block before the sample."""
    return "conv" in OP_CASES[case][2] or case == "double_pole_zero"


def _check_inf_row(prog, vals, plain, jax, member):
    """What K7 gives on ``INF_ROW`` where it departs from the JAX package
    (``_inf_row_differs``), output by output (``member``: the member kernel's
    own outputs): wherever the JAX package is not NaN, its value (the window's
    infinities exact); a convolution's output the float64 direct sum of its
    overlaps (numpy's ``convolve``): ``±inf`` in the sample's window and
    finite off it, where the JAX package is NaN and the member is NaN
    exactly;
    ``double_pole_zero``'s the member's: finite before the sample (where the
    JAX package's block is NaN), ``inf`` at it, NaN after."""
    from dspeed_tpu_torch.processors.convolutions import _mode_window

    convs = {prog.slots[op.outs[0]].key: op for op in prog.ops
             if op.code == _tile_program.OPCODES["conv"]}
    for k, v in plain.items():
        got, want = v.numpy()[INF_ROW], jax[k][INF_ROW]
        if got.ndim == 0:
            assert_f64_close(got, want, f"{k}: infinite row")
            continue
        sure = ~np.isnan(want)
        assert_f64_close(got[sure], want[sure], f"{k}: infinite row, where JAX is not NaN")
        if k in convs:
            op = convs[k]
            row = vals[prog.slots[op.ins[0]].key].numpy()[INF_ROW]
            taps = op.args[1][1]
            lo, p = _mode_window(chr(int(op.args[2][1])), row.shape[-1], taps.shape[-1])
            ref = np.convolve(row, taps)[lo:lo + p]
            assert np.isinf(ref).any() and np.isnan(want).any()
            assert_f64_close(got, ref, f"{k}: infinite row against the direct sum")
            m = member[k].numpy()[INF_ROW]
            np.testing.assert_array_equal(np.isnan(m), np.isfinite(got), err_msg=k)
            np.testing.assert_array_equal(m[np.isinf(got)], got[np.isinf(got)], err_msg=k)
        else:
            i = np.arange(got.shape[-1])
            np.testing.assert_array_equal(np.isnan(got), i > INF_AT, err_msg=k)
            assert got[INF_AT] == np.inf and np.isnan(want[:INF_AT]).any(), k
            assert_f64_close(got, member[k].numpy()[INF_ROW], f"{k}: infinite row, member")


def _group(case, dtype="float64"):
    """``(steps, vals)``: the case's members (its chain built unfused on the
    CPU over ``dtype`` rows) and the env values they read."""
    procs, names, _ = OP_CASES[case]
    wf, bl = _rows(case, dtype)
    outs = sorted(k.strip() for key in procs for k in key.split(","))
    cfg = {"outputs": outs or ["wf_blsub"], "processors": {
        "wf_blsub": _p("bl_subtract", ["waveform", "baseline", "wf_blsub(unit='ADC')"]),
        **procs}}
    chain, _, _ = torch_build(cfg, table(dspeed_tpu_torch.lh5, wf, bl), db_dict=_db(),
                              device="cpu", fuse=False)
    inputs, _ = chain._gather_inputs(0, len(wf))
    env = chain._run_steps(chain._to_device(inputs))
    steps = [s for s in chain._steps if member_name(s) in names
             or ("slice" in names and isinstance(s, SliceStep))]
    ext, written = set(), set()
    for s in steps:
        ext |= ProcessingChain._step_env_reads(s) - written
        written |= _step_writes(s)
    return steps, {k: env[k] for k in sorted(ext)}


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_op_on_float64_rows_matches_pallas_and_its_member(case):
    """The plain walk of the float64 program against the JAX package, and
    each member's own body against the plain walk."""
    steps, vals = _group(case)
    differs = _inf_row_differs(case)
    jax = {}
    prog = check_group(steps, vals, OP_CASES[case][2], f64=True,
                       except_rows=(INF_ROW,) if differs else (), jax_out=jax)
    assert prog.f64
    plain = _cuda.generic_rows_plain(prog, vals)
    env = {**vals, **plain}
    member = {}
    for step in steps:
        if isinstance(step, SliceStep):
            continue
        ins = {k: env[k] for k in ProcessingChain._step_env_reads(step)}
        member.update(member_outputs(step, ins))
    convs = {prog.slots[op.outs[0]].key for op in prog.ops
             if op.code == _tile_program.OPCODES["conv"]}
    for k, v in member.items():
        # a convolution's member is NaN off the infinite sample's window
        # (_check_inf_row)
        keep = np.arange(v.shape[0]) != INF_ROW if k in convs else slice(None)
        assert_f64_close(v.numpy()[keep], plain[k].numpy()[keep], f"{case} {k}: member")
    if differs:
        _check_inf_row(prog, vals, plain, jax, member)


def test_float64_slice_is_a_view_in_words():
    """A slice of a float64 plane is a view of its root: its place is the
    root's plus two words a sample."""
    steps, vals = _group("linear_slope_fit_of_a_slice")
    prog = _tile_program.lower(steps, vals, sorted(_step_writes(steps[-1])))
    ints, _, _ = prog.encode()
    s = prog.slots[next(i for i, s in enumerate(prog.slots) if s.key.startswith("wf_blsub[20"))]
    root = prog.slots[s.root]
    assert root.dtype == s.dtype == torch.float64 and (s.start, s.length) == (20, 100)
    rec = ints[len(prog.ops) * _tile_program.OP_INTS + prog.by_key[s.key]
               * _tile_program.SLOT_INTS:][:_tile_program.SLOT_INTS]
    assert rec[2] == root.off + 40 and rec[1] == _tile_program.SLOT_TYPES[torch.float64]


@pytest.mark.parametrize("case, why", [
    ("poly_diff", "float32 parameters read as float64"),
    ("windower", "a float32 row"),
])
def test_mixed_plane_types_split(case, why):
    """A float32 plane among float64 ones, where no member makes the mix,
    splits the group visibly: the parameters of a float64 row's polynomial
    in float32 (the member casts them), and a float32 row beside the
    float64 program's."""
    steps, vals = _group(case)
    if case == "poly_diff":
        key = next(k for k in vals if k.startswith("bl_poly"))
        vals[key] = vals[key].float()
        steps[0].arg_specs[1].dtype = np.float64
    else:
        vals["extra"] = torch.zeros(8, 16)
    with pytest.raises(_tile_program.LoweringError, match="float"):
        _tile_program.lower(steps, vals, sorted(_step_writes(steps[0])))


# ---------------------------------------------------------------------------
# the float64 configs

N_CFG = 32
# the DPZ's pz_slope (the slope of the flat top, a fit that cancels) sits
# 3.3e-9 of its scale from the JAX package's in the port's own unfused
# float64 chain too, whose pole recursion runs in order where the JAX
# package's runs by blocks (ROADMAP §3): held at the golden tolerance against
# that chain, and within 1e-8 of its scale against the JAX package
KNOWN = {("dpz", "pz_slope"): 1e-8}
CONFIGS = {"flagship": (cs.flagship_config, (34, 19)),
           "dpz": (cs.dpz_config, (34, 19)),
           "extras": (cs.extras_config, (34, 19, 9, 2, 22))}


@pytest.fixture(scope="module")
def cfg_events():
    wf, _amp, _t0, bl, _rt = cs.make_hpge_waveforms(N_CFG)
    dwf, _amp, _t0, dbl, _rt = cs.make_hpge_dpz_waveforms(N_CFG)
    out = {}
    for name, (w, b) in (("hpge", (wf, bl)), ("dpz", (dwf, dbl))):
        w = w.astype(np.float64)
        w[cs.NAN_SAMPLE_ROW, 500] = np.nan
        b = b.copy()
        b[cs.NAN_BASELINE_ROW] = np.nan
        w[9, :] = w[9, 0]  # a flat row: the searches find nothing
        w[11, 2000] = np.inf
        out[name] = (w, b)
    return out


def _cfg_table(lh5, wf, bl):
    return lh5.Table({
        "waveform": lh5.WaveformTable(values=wf, t0=0.0, t0_units="ns", dt=16.0,
                                      dt_units="ns"),
        "baseline": lh5.Array(bl.astype("float32")),
    })


def _card_rule(monkeypatch):
    """The fusion pass's card rule on the CPU: no hand pattern over a
    float64 plane."""
    from dspeed_tpu_torch.processing_chain import ProcessingChain as PC

    monkeypatch.setattr(PC, "_hand_kernel_plane",
                        lambda self, spec: np.dtype(spec.dtype) == np.float32)


def _kinds(steps):
    return [(type(s).__name__, member_name(s) or getattr(s, "name", "")) for s in steps]


@pytest.mark.parametrize("mode", ["generic", "card_rule"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_float64_config_groups_and_columns_match_jax(monkeypatch, cfg_events, name, mode):
    """The port's groups are the JAX package's generic groups member for
    member, each a float64 program; nothing splits; the columns meet the
    JAX package's generic mode at the golden replay's tolerance of the
    column's scale."""
    import dspeed_tpu
    from dspeed_tpu.processing_chain import GroupStep as JaxGroupStep
    from dspeed_tpu.processing_chain import ProcChainVar as JaxVar
    from dspeed_tpu.processing_chain import build_processing_chain as jax_build
    from dspeed_tpu_torch.processing_chain import ProcChainVar as TorchVar

    make, members = CONFIGS[name]
    wf, bl = cfg_events["dpz" if name == "dpz" else "hpge"]
    db = {"pz": {"tau": cs.TAU}}
    monkeypatch.setenv("DSPEED_TPU_FUSE", "generic")
    monkeypatch.setattr(JaxVar, "_counter", itertools.count())
    monkeypatch.setattr(TorchVar, "_counter", itertools.count())
    jc, _, _ = jax_build(make("float64"), _cfg_table(dspeed_tpu.lh5, wf, bl), db_dict=db)
    fuse = "generic"
    if mode == "card_rule":
        _card_rule(monkeypatch)
        fuse = True
    tc, _, _ = torch_build(make("float64"), _cfg_table(dspeed_tpu_torch.lh5, wf, bl),
                           db_dict=db, device="cpu", fuse=fuse)
    jg = [s for s in jc._steps if isinstance(s, JaxGroupStep)]
    tg = [s for s in tc._steps if isinstance(s, GroupStep)]
    assert [len(g.members) for g in tg] == [len(g.members) for g in jg] == list(members)
    for t, j in zip(tg, jg):
        assert _kinds(t.members) == _kinds(j.members)
    inputs, _ = tc._gather_inputs(0, tc._buffer_len)
    env = tc._to_device(inputs)
    env.update(tc._const_env())
    for step in tc._steps:
        if isinstance(step, GroupStep):
            prog = _tile_program.lower(step.members, {k: env[k] for k in step.ext_in},
                                       step.escapes)
            assert prog.f64
        step.run(env)
    cfg = make("float64")
    _tile_program.reset_splits()
    got = dspeed_tpu_torch.build_dsp(_cfg_table(dspeed_tpu_torch.lh5, wf, bl),
                                     dsp_config=cfg, database=db, device="cpu", fuse=fuse)
    assert _tile_program.SPLITS == {}
    want = dspeed_tpu.build_dsp(_cfg_table(dspeed_tpu.lh5, wf, bl), dsp_config=cfg,
                                database=db)
    for k in cfg["outputs"]:
        g, w = np.asarray(got[k].nda), np.asarray(want[k].nda)
        assert g.dtype == np.float64 or g.dtype.kind in "iu", k
        if (name, k) not in KNOWN:
            assert_f64_close(g, w, f"{name} {k}")
            continue
        unfused = dspeed_tpu_torch.build_dsp(
            _cfg_table(dspeed_tpu_torch.lh5, wf, bl), dsp_config=cfg, database=db,
            device="cpu", fuse=False)
        assert_f64_close(g, np.asarray(unfused[k].nda), f"{name} {k} against unfused")
        ok = np.isfinite(w)
        assert np.array_equal(np.isnan(g), np.isnan(w)), k
        assert np.abs(g[ok] - w[ok]).max() <= KNOWN[name, k] * np.abs(w[ok]).max(), k


def test_float32_configs_split_nothing(cfg_events):
    """The float32 flagship, DPZ and extras in generic mode still lower
    every group as a float program."""
    for name, (make, members) in sorted(CONFIGS.items()):
        wf, bl = cfg_events["dpz" if name == "dpz" else "hpge"]
        wf = np.nan_to_num(wf[:8], posinf=0.0).astype(np.float32)
        chain, _, _ = torch_build(make(), _cfg_table(dspeed_tpu_torch.lh5, wf, bl[:8]),
                                  db_dict={"pz": {"tau": cs.TAU}}, device="cpu",
                                  fuse="generic")
        inputs, _ = chain._gather_inputs(0, chain._buffer_len)
        env = chain._to_device(inputs)
        env.update(chain._const_env())
        n = 0
        for step in chain._steps:
            if isinstance(step, GroupStep):
                prog = _tile_program.lower(step.members, {k: env[k] for k in step.ext_in},
                                           step.escapes)
                assert not prog.f64
                n += 1
            step.run(env)
        assert n == len(members), name


# ---------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _same(a, b):
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_k7_f64_op_on_the_card(case, cuda_device):
    """Each op on float64 rows on the card: one launch of the float64
    kernel, every output bit for bit against the plain walk."""
    steps, vals = _group(case)
    writes = sorted(set().union(*(_step_writes(s) for s in steps)))
    dev = {k: v.to(cuda_device) for k, v in vals.items()}
    prog = _tile_program.lower(steps, dev, writes)
    before = _cuda.LAUNCHES["generic_rows"]
    got = _cuda.generic_rows(prog, dev)
    assert _cuda.LAUNCHES["generic_rows"] == before + 1
    want = _cuda.generic_rows_plain(prog, dev)
    torch.cuda.synchronize()
    for k in writes:
        assert _same(got[k], want[k]), k


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_k7_f64_groups_on_the_card(name, cuda_device):
    """The float64 config's groups on the card at 600 rows: one launch each,
    every stored output bit for bit against the plain walk."""
    make, members = CONFIGS[name]
    gen = cs.make_hpge_dpz_waveforms if name == "dpz" else cs.make_hpge_waveforms
    wf, _amp, _t0, bl, _rt = gen(600)
    wf = wf.astype(np.float64)
    wf[3, 500] = np.nan
    bl[5] = np.nan
    chain, _, _ = torch_build(make("float64"), _cfg_table(dspeed_tpu_torch.lh5, wf, bl),
                              db_dict={"pz": {"tau": cs.TAU}}, device="cpu",
                              fuse="generic")
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
            vals = {k: env[k] for k in step.ext_in}
            prog = _tile_program.lower(step.members, vals, step.escapes)
            assert prog.f64
            got = _cuda.generic_rows(prog, vals)
            want = _cuda.generic_rows_plain(prog, vals)
            torch.cuda.synchronize()
            for k in step.escapes:
                assert _same(got[k], want[k]), k
            env.update(got)
            n += 1
    assert n == len(members)
