"""K7's plane ops: the unnormalised trapezoid (``trap_filter``, the
``trap`` op's third kind), the moving windows (``moving_window``),
``fixed_time_pickoff`` in modes ``n``, ``f``, ``c`` and ``h``, the direct
convolution (``conv_direct``, 32 taps or fewer, modes ``f``, ``v`` and
``s``), the conversions ``convert_floor``, ``convert_ceil``,
``convert_trunc`` and ``convert_int``, the elementwise ops over planes
(``ewise``: every ufunc of the JAX package's ``_GENERIC_UFUNC_SAFE``, bool
planes, ``where`` and conversions of planes), the same table on per-row
scalars (``ufunc``) and the row reductions (``reduce``); and the plane path
(``chip_smoke.plane_config``) that runs them all.

- Each op alone (with the steps that make its bool operands, where it has
  them): the tape's plain walk against the JAX package's
  ``_pallas.generic_rows`` in interpret mode at 8 x 256
  (``tests/test_tile_safety.py``'s tolerance, NaN positions exact), on rows
  with a NaN sample, an infinite sample and a flat row.
- The plane config at 64 events: the port's generic groups are the JAX
  package's (``DSPEED_TPU_FUSE=generic``) member for member, nothing
  splits, and its columns meet the JAX package's at the chain tolerance.
- ``tests/test_torch_k7_plane_emulation.py`` runs the kernel's new ops on
  the CPU under ThreadSanitizer and AddressSanitizer (``tools/k7_emu``).

The ``gpu`` tests hold each op on the card against the plain walk of the
same tape bit for bit; they import neither JAX nor the JAX package.
"""

import itertools
import os
import sys

import numpy as np
import pytest
import torch

import dspeed_tpu_torch
from dspeed_tpu_torch.processing_chain import (
    GroupStep, ProcessingChain, _step_writes,
)
from dspeed_tpu_torch.processing_chain import build_processing_chain as torch_build
from dspeed_tpu_torch.processors import _cuda, _tile_program

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)
sys.path.insert(0, REPO)
import chip_smoke as cs  # noqa: E402
from torch_k7_ops import (  # noqa: E402
    assert_f64_close, check_group, events, member_outputs, table, widen,
)
from torch_k7_ops import member_name as _name  # noqa: E402

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


def _np(fn, args, types):
    """A ``numpy`` processor: a ufunc (``types`` of one ``(),...->()``
    signature) or a reduction of a row (``(n),()->()``)."""
    red = fn in _tile_program.REDUCTIONS
    sig = "(n),()->()" if red else ",".join(["()"] * (len(args) - 1)) + "->()"
    return {"function": fn, "module": "numpy", "args": args,
            "kwargs": {"signature": sig, "types": types}}


_FIT = {"b_mean, b_std, b_slope, b_icpt": _p(
    "linear_slope_fit", ["wf_blsub[0:90]", "b_mean", "b_std", "b_slope", "b_icpt"])}
_MINMAX = {"tp_min, tp_max, wf_min, wf_max": _p(
    "min_max", ["wf_blsub", "tp_min", "tp_max", "wf_min", "wf_max"],
    ["ns", "ns", "ADC", "ADC"])}
_BINARY = ("add", "subtract", "multiply", "divide", "floor_divide",
           "power", "remainder", "maximum", "minimum", "greater", "greater_equal",
           "less", "less_equal", "equal", "not_equal", "logical_and", "logical_or")
_UNARY = ("negative", "absolute", "fabs", "sqrt", "square", "sign", "rint", "floor",
          "ceil", "trunc", "exp", "expm1", "log", "log1p", "log10", "logical_not",
          "isnan", "isfinite")
_BOOL_OUT = _tile_program.BOOL_UFUNCS


def _ufunc_types(fn, n):
    return [t * n + "->" + ("?" if fn in _BOOL_OUT else t) for t in "fd"]


def _ufunc_case(fn):
    """``fn`` over the row: a binary ufunc with a per-row scalar (the
    baseline's spread) as its second operand, a unary one on the row (over
    a tenth for the exponentials, which then stay finite)."""
    if fn in _UNARY:
        arg = "wf_blsub*0.1" if fn in ("exp", "expm1") else "wf_blsub"
        return ({**_FIT, "y": _np(fn, [arg, "y"], _ufunc_types(fn, 1))}, (fn,),
                ["y"], ("ewise",))
    arg = "wf_blsub*0.01" if fn == "power" else "wf_blsub"
    other = "1.5" if fn == "power" else "b_std"
    return ({**_FIT, "y": _np(fn, [arg, other, "y"], _ufunc_types(fn, 2))}, (fn,),
            ["y"], ("ewise",))


# case -> (processors, the members' names (steps run as one group, in chain
# order), the chain's outputs, the ops they lower to)
OP_CASES = {
    "trap_filter": ({"y": _p("trap_filter", ["wf_blsub", "20", "10", "y"])},
                    ("trap_filter",), ["y"], ("trap",)),
    "moving_window_left": ({"y": _p("moving_window_left", ["wf_blsub", "12.5", "y"])},
                           ("moving_window_left",), ["y"], ("moving_window",)),
    "moving_window_right": ({"y": _p("moving_window_right", ["wf_blsub", "12.5", "y"])},
                            ("moving_window_right",), ["y"], ("moving_window",)),
    "moving_window_left_1": ({"y": _p("moving_window_left", ["wf_blsub", "1", "y"])},
                             ("moving_window_left",), ["y"], ("moving_window",)),
    "moving_window_right_0": ({"y": _p("moving_window_right", ["wf_blsub", "0.5", "y"])},
                              ("moving_window_right",), ["y"], ("moving_window",)),
    **{f"fixed_time_pickoff_{m}": (
        {**_FIT, "y": _p("fixed_time_pickoff", ["wf_blsub", "100.5+b_mean", f"'{m}'",
                                                "y"])},
        ("fixed_time_pickoff",), ["y"], ("fixed_time_pickoff",)) for m in "nfch"},
    **{f"fixed_time_pickoff_h_{t}": (
        {"y": _p("fixed_time_pickoff", ["wf_blsub", t, "'h'", "y"])},
        ("fixed_time_pickoff",), ["y"], ("fixed_time_pickoff",))
       for t in ("0.4", "254.6", "255.0", "0.0")},
    **{f"convolve_wf_{m}": (
        {"y": _p("convolve_wf", ["wf_blsub", "db.k5", f"'{m}'", f"y({p}, 'f')"])},
        ("convolve_wf",), ["y"], ("conv_direct",))
       for m, p in (("s", 256), ("f", 260), ("v", 252))},
    "convolve_wf_t0_filter_f": (
        {"t0k": _p("t0_filter", ["16*ns/wf_blsub.period", "256*ns/wf_blsub.period",
                                 "t0k(round(272*ns/wf_blsub.period), 'f')"]),
         "y": _p("convolve_wf", ["wf_blsub", "t0k", "'f'", "y(272, 'f')"])},
        ("convolve_wf",), ["y"], ("conv_direct",)),
    "fft_convolve_wf_32_v": (
        {"y": _p("fft_convolve_wf", ["wf_blsub", "db.k32", "'v'", "y(225, 'f')"])},
        ("fft_convolve_wf",), ["y"], ("conv_direct",)),
    **{f"convert_{m}": (
        {**_MINMAX, "y": f"{m}(tp_max*1.001, 48*ns)"}, ("multiply", f"convert_{m}"),
        ["y"], ("ufunc", "convert")) for m in ("floor", "ceil", "trunc")},
    "convert_int": ({**_MINMAX, "t_idx": "round(tp_max, wf_blsub.grid, 'int64')"},
                    ("convert_int",), ["t_idx"], ("convert",)),
    **{f"ufunc_{fn}": _ufunc_case(fn) for fn in _BINARY + _UNARY},
    # quotients past 2^24: K7's fmod by long division
    **{f"ufunc_{fn}_large_quotient": (
        {"y": _np(fn, ["wf_blsub*1000000", "0.001", "y"], _ufunc_types(fn, 2))}, (fn,),
        ["y"], ("ewise",)) for fn in ("floor_divide", "remainder")},
    "where_planes": ({"y": "where(wf_blsub > 30, wf_blsub, 0.0)"}, ("greater", "where"),
                     ["y"], ("ewise", "ewise")),
    "where_scalar_condition": (
        {**_FIT, "y": "where(b_std > 2, wf_blsub, wf_blsub*2)"}, ("where",), ["y"],
        ("ewise",)),
    "logical_of_bool_planes": (
        {"y": _np("logical_and", ["wf_blsub > 20", "wf_blsub < 200", "y"], ["??->?"])},
        ("logical_and",), ["y"], ("ewise",)),
    "isnan_scalar": ({**_FIT, "y": _np("isnan", ["b_slope", "y"], ["f->?", "d->?"])},
                     ("isnan",), ["y"], ("ufunc",)),
    **{f"scalar_{fn}": ({**_FIT, "y": _np(fn, ["b_std*3", "0.7", "y"],
                                           _ufunc_types(fn, 2))}, (fn,), ["y"],
                        ("ufunc",))
       for fn in ("floor_divide", "remainder", "power", "maximum", "logical_or")},
    **{f"scalar_{fn}": ({**_FIT, "y": _np(fn, ["b_mean*3", "y"], _ufunc_types(fn, 1))},
                        (fn,), ["y"], ("ufunc",))
       for fn in ("sqrt", "sign", "log1p", "rint", "negative", "isfinite")},
    "convert_plane": (
        {"vt_max, vt_min, n_max, n_min": _p("get_multi_local_extrema", [
            "wf_blsub", "20", "20", "0", "20", "0", "vt_max(4, vector_len=n_max)",
            "vt_min(4, vector_len=n_min)", "n_max", "n_min"], ["ns", "ns", "", ""]),
         "y": "floor(vt_max, 48*ns)"},
        ("convert_floor",), ["y"], ("ewise",)),
    **{f"reduce_{fn}": ({"y": _np(fn, ["wf_blsub", 1, "y"], ["fi->f", "di->d"])}, (fn,), ["y"],
                        ("reduce",))
       for fn in _tile_program.REDUCTIONS},
    "reduce_mean_of_a_slice": ({"y": _np("mean", ["wf_blsub[10:200]", 1, "y"],
                                         ["fi->f"])}, ("mean",), ["y"], ("reduce",)),
    "reduce_sum_of_bools": ({"y": _np("sum", ["wf_blsub > 30", 1, "y"], ["?i->l"])},
                            ("sum",), ["y"], ("reduce",)),
}


def _db():
    rng = np.random.default_rng(5)
    return {"k5": np.float32([0.1, -0.2, 0.4, 0.25, 0.1]),
            "k32": rng.normal(0, 0.2, 32).astype("float32")}


def _rows(dtype="float32"):
    wf, bl = events(dtype)
    wf[INF_ROW, INF_AT] = np.inf
    return wf, bl


def _group(case, dtype="float32", wf=None, bl=None):
    """``(steps, vals)``: the case's members (its chain built unfused on the
    CPU, with the database of ``_db``; on float64 rows its float32 outputs
    declared float64) and the env values they read."""
    procs, names, outs, _ = OP_CASES[case]
    if dtype == "float64":
        procs = widen(procs)
    if wf is None:
        wf, bl = _rows(dtype)
    cfg = {"outputs": list(outs), "processors": {
        "wf_blsub": _p("bl_subtract", ["waveform", "baseline", "wf_blsub(unit='ADC')"]),
        **procs}}
    chain, _, _ = torch_build(cfg, table(dspeed_tpu_torch.lh5, wf, bl), db_dict=_db(),
                              device="cpu", fuse=False)
    inputs, _ = chain._gather_inputs(0, len(wf))
    env = chain._run_steps(chain._to_device(inputs))
    steps = [s for s in chain._steps if _name(s) in names]
    ext, written = set(), set()
    for s in steps:
        ext |= ProcessingChain._step_env_reads(s) - written
        written |= _step_writes(s)
    return steps, {k: env[k] for k in sorted(ext)}, env


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_op_matches_pallas_generic_rows(case):
    steps, vals, _ = _group(case)
    check_group(steps, vals, OP_CASES[case][3])


def test_convert_int_marks_a_result_that_is_not_an_integer():
    """``convert_int`` into a grid whose samples do not land on integers:
    the member's ``iinfo(int64).max`` where the value is 1e-5 or more from
    an integer, the integer elsewhere; the op's float64 copy of it
    saturates to that maximum (``_cuda.esc_value``)."""
    steps, vals, _ = _group("convert_int")
    (step,) = steps
    step.ratio = 0.25
    prog = check_group(steps, vals, ("convert",))
    got = _cuda.generic_rows_plain(prog, vals)[step.out_key]
    big = torch.iinfo(torch.int64).max
    assert got.dtype == torch.int64 and bool((got == big).any())
    assert bool((got != big).any())
    copy = torch.tensor([2.0**63, 12.0, -3.0], dtype=torch.float64)
    assert _cuda.esc_value(copy, torch.int64).tolist() == [big, 12, -3]


@pytest.mark.parametrize("case", ["moving_window_left", "convolve_wf_f",
                                  "ufunc_greater", "where_planes", "reduce_sum",
                                  "ufunc_isnan"])
def test_op_float64_rows_split(case):
    """A float64 row (these ops split it until K7's float64 kernel took
    them): the op lowers into a float64 program, bool planes and all; its
    plain walk meets the JAX package's ``_pallas.generic_rows`` in float64,
    and each member's own body the plain walk, at the golden replay's
    tolerance of the column's scale, on every row, the one with an infinite
    sample included."""
    steps, vals, _ = _group(case, "float64")
    check_float64_group(steps, vals, OP_CASES[case][3])


def check_float64_group(steps, vals, codes):
    """``steps`` on float64 rows as one float64 program (its ops ``codes``):
    the plain walk against the JAX package (``check_group`` with ``f64``),
    and each member's own body against the plain walk."""
    prog = check_group(steps, vals, codes, f64=True)
    assert prog.f64
    plain = _cuda.generic_rows_plain(prog, vals)
    env = {**vals, **plain}
    for step in steps:
        ins = {k: env[k] for k in ProcessingChain._step_env_reads(step)}
        for k, v in member_outputs(step, ins).items():
            assert_f64_close(v.numpy(), plain[k].numpy(), f"{k}: member")
    return prog


@pytest.mark.parametrize("case", ["fixed_time_pickoff_h", "scalar_floor_divide",
                                  "scalar_sqrt", "isnan_scalar", "convert_floor"])
def test_scalar_op_takes_float64(case):
    """The per-row ops take float64 rows' scalars; ``fixed_time_pickoff``
    reads its float64 plane in K7's float64 program."""
    steps, vals, _ = _group(case, "float64")
    prog = check_group(steps, vals, OP_CASES[case][3])
    assert prog.f64 == (case == "fixed_time_pickoff_h")


def test_k7_order_variants_hold_their_members():
    """The plain walk's K7-order variants (``trap_filter``, the moving
    windows, the reduce op's sums) equal their members within float32
    rounding."""
    import dspeed_tpu_torch.processors as tp
    from dspeed_tpu_torch._numpy_funcs import K7_SUMS, NUMPY_FUNCS, k7_reduce
    from dspeed_tpu_torch.processors.moving_windows import (
        moving_window_left_k7, moving_window_right_k7,
    )
    from dspeed_tpu_torch.processors.trap_filters import trap_filter_k7

    wf, _ = events()
    w = torch.from_numpy(wf)
    pairs = [(trap_filter_k7(w, 20, 10), tp.trap_filter(w, 20, 10)),
             (moving_window_left_k7(w, 12.5), tp.moving_window_left(w, 12.5)),
             (moving_window_right_k7(w, 12.5), tp.moving_window_right(w, 12.5))]
    pairs += [(k7_reduce(k, w), NUMPY_FUNCS[k](w, -1)) for k in sorted(K7_SUMS)]
    b = w > 150
    pairs += [(k7_reduce("sum", b), NUMPY_FUNCS["sum"](b, -1))]
    for got, want in pairs:
        got = got[0] if isinstance(got, tuple) else got
        want = want[0] if isinstance(want, tuple) else want
        assert got.dtype == want.dtype
        torch.testing.assert_close(got, want, rtol=2e-6, atol=1e-3, equal_nan=True)


def test_numpy_sign_keeps_nan():
    """numpy's ``sign`` of NaN is NaN (``torch.sign`` gives 0): the port's
    ufunc, its K7 entry and the JAX package agree."""
    from dspeed_tpu_torch.processing_chain import _np_to_torch_ufunc

    x = torch.tensor([np.nan, -2.0, 0.0, 3.0], dtype=torch.float32)
    got = _np_to_torch_ufunc(np.sign)(x)
    np.testing.assert_array_equal(got.numpy(), np.sign(x.numpy()))


# ---------------------------------------------------------------------------
# the plane config


N_PLANE = 64


def _plane_table(lh5, wf, bl):
    return lh5.Table({
        "waveform": lh5.WaveformTable(values=wf, t0=0.0, t0_units="ns", dt=16.0,
                                      dt_units="ns"),
        "baseline": lh5.Array(bl.astype("float32")),
    })


@pytest.fixture(scope="module")
def plane_events():
    wf, _amp, _t0, bl, _rt = cs.make_hpge_waveforms(N_PLANE)
    wf[cs.NAN_SAMPLE_ROW, 500] = np.nan
    bl[cs.NAN_BASELINE_ROW] = np.nan
    wf[9, :] = wf[9, 0]  # a flat row: the searches find nothing
    return wf, bl


def _kinds(steps):
    return [(type(s).__name__, _name(s) or getattr(s, "name", "")) for s in steps]


def test_plane_groups_match_jax_and_nothing_splits(monkeypatch, plane_events):
    from dspeed_tpu import lh5 as jlh5
    from dspeed_tpu.processing_chain import GroupStep as JaxGroupStep
    from dspeed_tpu.processing_chain import ProcChainVar as JaxVar
    from dspeed_tpu.processing_chain import build_processing_chain as jax_build
    from dspeed_tpu_torch.processing_chain import ProcChainVar as TorchVar

    wf, bl = plane_events
    monkeypatch.setenv("DSPEED_TPU_FUSE", "generic")
    monkeypatch.setattr(JaxVar, "_counter", itertools.count())
    monkeypatch.setattr(TorchVar, "_counter", itertools.count())
    db = {"pz": {"tau": cs.TAU}}
    jc, _, _ = jax_build(cs.plane_config(), _plane_table(jlh5, wf, bl), db_dict=db)
    tc, _, tout = torch_build(cs.plane_config(),
                              _plane_table(dspeed_tpu_torch.lh5, wf, bl), db_dict=db,
                              device="cpu", fuse="generic")
    jg = [s for s in jc._steps if isinstance(s, JaxGroupStep)]
    tg = [s for s in tc._steps if isinstance(s, GroupStep)]
    assert [len(g.members) for g in tg] == [len(g.members) for g in jg] == \
        list(cs.PLANE_MEMBERS)
    jkinds = [(t, n.replace("jnp.", "")) for t, n in _kinds(jc._steps)]
    assert _kinds(tc._steps) == jkinds
    for t, j in zip(tg, jg):
        assert t.ext_in == j.ext_in and t.escapes == j.escapes
    _tile_program.reset_splits()
    tc(_plane_table(dspeed_tpu_torch.lh5, wf, bl), tout)
    assert _tile_program.SPLITS == {}
    # every new op runs, each in a group
    inputs, _ = tc._gather_inputs(0, len(wf))
    env = tc._to_device(inputs)
    env.update(tc._const_env())
    seen = set()
    for step in tc._steps:
        if isinstance(step, GroupStep):
            prog = _tile_program.lower(step.members, {k: env[k] for k in step.ext_in},
                                       step.escapes)
            seen |= {cs.plane_op_label(prog, op) for op in prog.ops}
        step.run(env)
    assert set(cs.PLANE_OPS) <= seen, sorted(set(cs.PLANE_OPS) - seen)


def test_plane_columns_match_jax(monkeypatch, plane_events):
    import dspeed_tpu

    wf, bl = plane_events
    db = {"pz": {"tau": cs.TAU}}
    cfg = cs.plane_config()
    _tile_program.reset_splits()
    got = dspeed_tpu_torch.build_dsp(_plane_table(dspeed_tpu_torch.lh5, wf, bl),
                                     dsp_config=cfg, database=db, device="cpu",
                                     fuse="generic")
    assert _tile_program.SPLITS == {}
    unfused = dspeed_tpu_torch.build_dsp(_plane_table(dspeed_tpu_torch.lh5, wf, bl),
                                         dsp_config=cfg, database=db, device="cpu",
                                         fuse=False)
    monkeypatch.setenv("DSPEED_TPU_FUSE", "generic")
    want = dspeed_tpu.build_dsp(_plane_table(dspeed_tpu.lh5, wf, bl), dsp_config=cfg,
                                database=db)
    for k in cfg["outputs"]:
        g, u, w = got[k].nda, unfused[k].nda, np.asarray(want[k].nda)
        assert g.shape == w.shape and g.dtype == w.dtype, k
        for other, what in ((w, "jax"), (u, "unfused")):
            gf, of = g.astype(np.float64), other.astype(np.float64)
            keep = np.ones(len(gf), bool)
            if k in cs.PLANE_READS_T0 or k.startswith("tp_"):
                # a column that reads tp_0_est: excused where it moved a sample
                keep = np.abs(got["tp_0_est"].nda - np.asarray(
                    (want if what == "jax" else unfused)["tp_0_est"].nda)) == 0
            np.testing.assert_array_equal(np.isnan(gf)[keep], np.isnan(of)[keep],
                                          err_msg=f"{k} NaN vs {what}")
            ok = np.isfinite(of) & np.isfinite(gf) & keep
            scale = max(np.abs(of[ok]).max(initial=0.0), 1.0)
            tol = 16.0 if k.startswith("tp_") else 1e-5 * scale
            err = np.abs(gf[ok] - of[ok]).max(initial=0.0)
            assert err <= tol, f"{k} vs {what}: {err:.3e} > {tol:.3e}"
    for k in cs.PLANE_OUTPUTS:
        assert np.isfinite(got[k].nda.astype(np.float64)).mean() >= 0.9, k


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
    return bool(((a == b) | (torch.isnan(a.double()) & torch.isnan(b.double()))).all())


def _card_rows(seed, B=37, n=256):
    """``B`` rows of ``n`` samples: a baseline, a pulse, noise; a NaN sample
    (row 1), an infinite sample (row 3), a flat run (row 5) and a flat row
    (row 6)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)[None, :]
    bl = rng.uniform(100, 200, B)
    wf = bl[:, None] + rng.uniform(50, 500, (B, 1)) * np.clip((t - 100) / 20, 0, 1) \
        + rng.normal(0, 2, (B, n))
    wf[1, 200] = np.nan
    wf[3, 150] = np.inf
    wf[5, 40:60] = wf[5, 40]
    wf[6] = wf[6, 0]
    return wf.astype(np.float32), bl.astype(np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_op_on_the_card_equals_the_plain_walk(case, cuda_device):
    """Each op alone (with the steps that make its bool operands), one
    launch, every output bit for bit against the tape's plain walk on the
    same card, at 37 rows with a NaN, an infinite sample and flat rows."""
    wf, bl = _card_rows(len(case))
    steps, vals, _ = _group(case, wf=wf, bl=bl)
    vals = {k: v.to(cuda_device) for k, v in vals.items()}
    writes = sorted(set().union(*(_step_writes(s) for s in steps)))
    prog = _tile_program.lower(steps, vals, writes)
    before = _cuda.LAUNCHES["generic_rows"]
    got = _cuda.generic_rows(prog, vals)
    assert _cuda.LAUNCHES["generic_rows"] == before + 1
    want = _cuda.generic_rows_plain(prog, vals)
    torch.cuda.synchronize()
    for k in want:
        assert got[k].dtype == want[k].dtype and _same(got[k], want[k]), k


@pytest.mark.gpu
def test_plane_groups_on_the_card(cuda_device):
    """The plane config's three groups at 600 rows: every output of slice
    20's ops bit for bit against the plain walk (each group storing every key
    it writes, in as many launches as the kernel's stored outputs need)."""
    wf, _amp, _t0, bl, _rt = cs.make_hpge_waveforms(600)
    wf[3, 500] = np.nan
    bl[5] = np.nan
    wf[7, 2000] = np.inf
    chain, _, _ = torch_build(cs.plane_config(), _plane_table(dspeed_tpu_torch.lh5, wf, bl),
                              db_dict={"pz": {"tau": cs.TAU}}, device="cpu",
                              fuse="generic")
    inputs, _ = chain._gather_inputs(0, len(wf))
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
            full, got, want = cs.store_every(_cuda, step.members, vals, every)
            torch.cuda.synchronize()
            for op in full.ops:
                label = cs.plane_op_label(full, op)
                if label is None:
                    continue
                seen.add(label)
                for sid in op.outs:
                    key = full.slots[sid].key
                    assert _same(got[key], want[key]), (label, key)
            env.update({k: got[k] for k in step.escapes})
    assert seen == set(cs.PLANE_OPS)
