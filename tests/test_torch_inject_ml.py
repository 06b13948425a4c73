"""The pulse injectors (``pulse_injector.py``, ``pmt_pulse_injector.py``) and
the network layers (``ml.py``) of the port against the JAX package's, on the
same seeded inputs, and K7's ``inject`` and ``dense`` ops alone.

The JAX side runs on the CPU in x64 under ``jax.jit``
(``test_torch_filters._jax``). Rows of 24 x 96 and 8 x 256 samples, float32
and float64, with a NaN row and a parameter (or bias) given one a row with a
NaN in it. Tolerances: float64 outputs within ``1e-12`` of their scale
(``max |jax|``), float32 within ``REL`` (``2e-6``), NaN positions identical.
(The JAX package under x64 computes ``inject_sig_pulse``'s and
``inject_general_logistic``'s rise in float64, since ``4 ln 99`` is a numpy
float64 there; the port computes a float32 row's pulse in float32, as the
JAX package does without x64.)

Each op alone: the tape's plain walk on a one-op group against the JAX
package's ``_pallas.generic_rows`` in interpret mode at 8 x 256
(``tests/torch_k7_ops.py``, ``tests/test_tile_safety.py``'s tolerance).
The ``gpu`` tests hold each op on the card against the plain walk of the
same tape bit for bit; they import neither JAX nor the JAX package.
"""

import os
import sys

import numpy as np
import pytest
import torch

import dspeed_tpu_torch.processors as tp
from dspeed_tpu_torch.errors import DSPFatal
from dspeed_tpu_torch.processors import _cuda, _tile_program

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_filters import _jax, _t  # noqa: E402
from torch_k7_ops import check_against_pallas, check_float64_body, events, one_op  # noqa: E402

REL = {"float64": 1e-12, "float32": 2e-6}
K = "dspeed_tpu.processors"


def _jp():
    import dspeed_tpu.processors as jp

    return jp


def _close(got, want, dtype):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, (i, g.shape, w.shape, g.dtype)
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=f"{i}: NaN")
        ok = ~np.isnan(w)
        np.testing.assert_array_equal(np.isinf(g[ok]), np.isinf(w[ok]))
        fin = np.isfinite(w)
        if fin.any():
            err = np.abs(g[fin].astype(np.float64) - w[fin]).max()
            scale = np.abs(w[fin]).max()
            assert err <= REL[dtype] * scale, f"{i}: {err:.3e} > {REL[dtype]} * {scale:.3e}"


def _rows(shape, dtype, seed=5):
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 10, shape)
    w[1, shape[1] // 3] = np.nan
    return w.astype(dtype)


# name -> the parameters (six distinct values for the logistic), and which
# of them the per-event case gives one a row
INJECT = {
    "inject_sig_pulse": ((20.0, 5.0, 100.0, 30.0), 2),
    "inject_exp_pulse": ((20.0, 5.0, 100.0, 30.0), 0),
    "inject_gumbel": ((100.0, 20.0, 5.0), 1),
    "inject_general_logistic": ((100.0, 20.0, 5.0, 1.5, 2.0, 30.0), 4),
}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("shape, per_event", [((24, 96), True), ((8, 256), False)])
@pytest.mark.parametrize("name", sorted(INJECT))
def test_injector_matches_jax(name, shape, per_event, dtype):
    w = _rows(shape, dtype)
    params, k = INJECT[name]
    args = list(params)
    if per_event:
        v = np.linspace(0.5, 1.5, shape[0]) * params[k]
        v[5] = np.nan
        args[k] = v.astype(dtype)
    got = getattr(tp, name)(_t(w), *(_t(a) for a in args))
    _close(got, _jax(getattr(_jp(), name), w, *args), dtype)


def test_exp_pulse_rises_only_up_to_t0():
    """The JAX package's condition ``(t <= t0) & (t <= t0 + rt)``: the rising
    part stands up to t0, zero over ``(t0, t0 + rt]``, the decay after."""
    w = np.zeros((1, 64), np.float32)
    out = tp.inject_exp_pulse(_t(w), 20.0, 5.0, 100.0, 30.0)[0][0].numpy()
    assert (out[:21] > 0).all() and (out[21:26] == 0).all() and (out[26:] > 0).all()


# name -> (weights shape, bias, flags): every activation once or more
LAYERS = {
    "dense_layer_no_bias": ("nm", None, "rlm"),
    "dense_layer_with_bias": ("nm", "m", "ts"),
    "classification_layer_no_bias": ("n", None, "s"),
    "classification_layer_with_bias": ("n", "event", "l"),
    "normalisation_layer": (None, None, ""),
}


def _layer_args(name, n, n_ev, dtype, flag, rng):
    kern, bias, _ = LAYERS[name]
    if name == "normalisation_layer":
        return [rng.uniform(-1, 1, n).astype(dtype), rng.uniform(0.5, 4, n).astype(dtype)]
    args = [rng.normal(0, 0.3, (n, 8) if kern == "nm" else n).astype(dtype)]
    if bias == "m":
        args.append(rng.normal(0, 0.1, 8).astype(dtype))
    elif bias == "event":
        b = rng.normal(0, 0.1, n_ev)
        b[4] = np.nan
        args.append(b.astype(dtype))
    return args + [np.int8(ord(flag))]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name, flag, shape", [
    (name, f or "-", shape) for name, (_, _, flags) in sorted(LAYERS.items())
    for f, shape in zip(flags or [""], [(24, 96), (8, 256), (24, 96)])])
def test_layer_matches_jax(name, flag, shape, dtype):
    rng = np.random.default_rng(7)
    x = _rows(shape, dtype) / 10
    x[3, 0] = -np.inf  # 'r' gives NaN there, as t * (t > 0) does
    args = _layer_args(name, shape[1], shape[0], dtype, flag, rng)
    got = getattr(tp, name)(_t(x), *(_t(a) for a in args))
    _close(got, _jax(getattr(_jp(), name), x, *args), dtype)


@pytest.mark.parametrize("name", ["dense_layer_no_bias", "classification_layer_no_bias"])
def test_unknown_activation_raises_as_jax(name):
    x = _rows((4, 16), "float32")
    kern = np.ones((16, 2) if name.startswith("dense") else 16, np.float32)
    with pytest.raises(DSPFatal, match="unrecognized activation flag 'q'"):
        getattr(tp, name)(_t(x), _t(kern), ord("q"))
    with pytest.raises(Exception, match="unrecognized activation flag 'q'") as e:
        getattr(_jp(), name)(x, kern, ord("q"))
    assert type(e.value).__name__ == "DSPFatal"


@pytest.mark.parametrize("flag", "srlmt")
def test_layer_rows_is_the_layer_within_float32(flag):
    """The plain walk's fixed order (``ml.layer_rows``) against the member
    kernel's ``torch.matmul``: one float32 rounding of the sum apart."""
    from dspeed_tpu_torch.processors.ml import layer_rows

    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(0, 1, (16, 100)).astype(np.float32))
    x[2, 7] = np.nan
    kern = rng.normal(0, 0.3, (100, 12)).astype(np.float32)
    bias = rng.normal(0, 0.1, 12).astype(np.float32)
    want = tp.dense_layer_with_bias(x, torch.from_numpy(kern), torch.from_numpy(bias),
                                    ord(flag))[0]
    got = layer_rows(x, kern, bias, ord(flag), "dense_layer_with_bias")
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    ok = ~torch.isnan(want)
    assert float((got[ok] - want[ok]).abs().max()) <= 2e-6 * float(want[ok].abs().max())
    # a classification is the (n, 1) dense layer's one output, bit for bit
    vec = layer_rows(x, kern[:, 0], 0.5, ord(flag), "classification_layer_with_bias")
    one = layer_rows(x, kern[:, :1], np.float32([0.5]), ord(flag), "dense_layer_with_bias")
    assert torch.equal(torch.nan_to_num(vec, nan=-1.0), torch.nan_to_num(one[:, 0], nan=-1.0))


# ---------------------------------------------------------------------------
# K7's inject and dense ops alone


def _db(n=256, m=8, seed=13):
    rng = np.random.default_rng(seed)
    return {"nn": {"mu": rng.uniform(-5, 5, n).astype("float32"),
                   "var": rng.uniform(50, 200, n).astype("float32"),
                   "w": rng.normal(0, 0.05, (n, m)).astype("float32"),
                   "b": rng.normal(0, 0.1, m).astype("float32"),
                   "v": rng.normal(0, 0.05, n).astype("float32")}}


def _ml_cfg(c="f"):
    return {
        "xn": {"function": "normalisation_layer", "module": K,
               "args": ["wf_blsub", "db.nn.mu", "db.nn.var", "xn"]},
        "h_nb": {"function": "dense_layer_no_bias", "module": K,
                 "args": ["wf_blsub", "db.nn.w", "'l'", f"h_nb(8, '{c}')"]},
        "h_b": {"function": "dense_layer_with_bias", "module": K,
                "args": ["wf_blsub", "db.nn.w", "db.nn.b", "'t'", f"h_b(8, '{c}')"]},
        "c_nb": {"function": "classification_layer_no_bias", "module": K,
                 "args": ["wf_blsub", "db.nn.v", "'s'", "c_nb"]},
        # a bias one a row
        "c_b": {"function": "classification_layer_with_bias", "module": K,
                "args": ["wf_blsub", "db.nn.v", "baseline*0.001", "'m'", "c_b"]},
    }


def _inject_cfg():
    return {
        "wf_sig": {"function": "inject_sig_pulse", "module": K,
                   "args": ["wf_blsub", "150.0", "5.0", "baseline*0.5", "300.0", "wf_sig"]},
        "wf_exp": {"function": "inject_exp_pulse", "module": K,
                   "args": ["wf_blsub", "150.0", "8.0", "80.0", "200.0", "wf_exp"]},
        "wf_gum": {"function": "inject_gumbel", "module": K,
                   "args": ["wf_blsub", "60.0", "baseline*0.8", "4.0", "wf_gum"]},
        "wf_log": {"function": "inject_general_logistic", "module": K,
                   "args": ["wf_blsub", "90.0", "160.0", "6.0", "1.5", "2.5",
                            "250.0", "wf_log"]},
    }


OP_CASES = {
    "inject_sig_pulse": ("wf_sig", "inject"),
    "inject_exp_pulse": ("wf_exp", "inject"),
    "inject_gumbel": ("wf_gum", "inject"),
    "inject_general_logistic": ("wf_log", "inject"),
    "normalisation_layer": ("xn", "dense"),
    "dense_layer_no_bias": ("h_nb", "dense"),
    "dense_layer_with_bias": ("h_b", "dense"),
    "classification_layer_no_bias": ("c_nb", "dense"),
    "classification_layer_with_bias": ("c_b", "dense"),
}


def _op(name, dtype="float32", inf=False):
    out, code = OP_CASES[name]
    cfg = _inject_cfg() if code == "inject" else _ml_cfg("d" if dtype == "float64" else "f")
    wf, bl = events(dtype)
    if inf:  # an infinite sample in row 4
        wf[4, 180] = np.inf
    step, vals, _, _ = one_op(cfg, name, wf, bl, [out], db=_db())
    return step, vals, code


@pytest.mark.parametrize("name", sorted(OP_CASES))
def test_op_matches_pallas_generic_rows(name):
    step, vals, code = _op(name)
    prog = check_against_pallas(step, vals, getattr(_jp(), name), code)
    op = prog.ops[-1]
    if code == "inject":
        # the per-event parameters are operands; the rest ride in the taps
        assert bin(op.ip[2]).count("1") == len(op.ins) - 1
    # the row's load lands before the op reads it: one planned barrier
    assert op.plan == 1
    if code == "dense":
        kind = _tile_program.DENSE_KINDS[name]
        assert op.ip[0] == kind
        # a product's partial sums take the scratch: 8 warps x m doubles
        assert prog.scratch_dbl >= (8 * op.ip[5] if kind else 0)


@pytest.mark.parametrize("name", sorted(OP_CASES))
def test_op_float64_rows_split(name):
    """A float64 row (it split these ops' groups until K7's float64 kernel
    took them), an infinite sample among its rows: the op lowers into a
    float64 program, its constants in float64; its plain walk meets the JAX
    package in float64, and the member's own body the plain walk."""
    step, vals, code = _op(name, "float64", inf=True)
    check_float64_body(step, vals, getattr(_jp(), name), codes=code)


def test_ops_in_one_group_plan_their_barriers():
    """The normalisation reads the loaded row (a planned barrier), the dense
    layer the normalisation's plane, which other threads wrote (another),
    and the classifier the dense plane, and it would overwrite the scratch
    that the dense layer's threads read after its own barrier (a third)."""
    wf, bl = events()
    cfg = {**_inject_cfg(), **_ml_cfg(),
           "h2": {"function": "dense_layer_no_bias", "module": K,
                  "args": ["xn", "db.nn.w", "'r'", "h2(8, 'f')"]},
           "s2": {"function": "classification_layer_no_bias", "module": K,
                  "args": ["h2", "db.nn.v8", "'s'", "s2"]}}
    db = _db()
    db["nn"]["v8"] = np.linspace(-1, 1, 8).astype("float32")
    _, _, env, chain = one_op(cfg, "dense_layer_no_bias", wf, bl, ["s2", "wf_log"], db=db)
    from dspeed_tpu_torch.processing_chain import KernelStep

    members = [s for s in chain._steps if isinstance(s, KernelStep)
               and s.kernel.__name__ in ("normalisation_layer", "dense_layer_no_bias",
                                         "classification_layer_no_bias")
               and s.out_specs[0].key.split("#")[0] in ("xn", "h2", "s2")]
    reads = set()
    for s in members:
        reads |= chain._step_env_reads(s)
    writes = {sp.key for s in members for sp in s.out_specs}
    vals = {k: env[k] for k in sorted(reads - writes)}
    prog = _tile_program.lower(members, vals, sorted(writes))
    ops = [op for op in prog.ops if op.code != _tile_program.OPCODES["load"]]
    assert [op.ip[0] for op in ops] == [0, 1, 2]
    assert [op.plan for op in ops] == [1, 1, 1]
    got = _cuda.generic_rows_plain(prog, vals)
    want = {k: env[k] for k in writes}
    for k in writes:
        assert torch.equal(torch.isnan(got[k]), torch.isnan(want[k])), k
        ok = ~torch.isnan(want[k])
        assert float((got[k][ok] - want[k][ok]).abs().max()) <= 2e-6 * max(
            1.0, float(want[k][ok].abs().max())), k


def test_two_products_of_one_row_wait_for_the_scratch():
    """Two dense layers of the same row: the second writes its partial sums
    into the scratch that the first one's threads still read after its own
    barrier, so the plan puts a barrier before it though it reads nothing
    the first wrote."""
    wf, bl = events()
    step_a, vals, _, chain = one_op(_ml_cfg(), "dense_layer_no_bias", wf, bl,
                                    ["h_nb", "h_b"], db=_db())
    from dspeed_tpu_torch.processing_chain import KernelStep

    step_b = next(s for s in chain._steps if isinstance(s, KernelStep)
                  and s.kernel.__name__ == "dense_layer_with_bias")
    keys = [sp.key for s in (step_a, step_b) for sp in s.out_specs]
    prog = _tile_program.lower([step_a, step_b], vals, keys)
    assert [op.plan for op in prog.ops] == [0, 1, 1]


def test_dense_lowering_refusals():
    """A weight matrix given one a row has no op (the group splits), nor
    has an unknown activation flag (``DSPFatal``, as the layer raises)."""
    wf, bl = events()
    db = _db()
    step, vals, _, _ = one_op(_ml_cfg(), "dense_layer_with_bias", wf, bl, ["h_b"], db=db)
    step.arg_specs[-1].value = np.int8(ord("q"))
    with pytest.raises(DSPFatal, match="unrecognized activation flag"):
        _tile_program.lower([step], vals, [step.out_specs[0].key])
    step.arg_specs[-1].value = np.int8(ord("t"))
    step.arg_specs[1].value = np.zeros((3, 3), np.float32)
    with pytest.raises(_tile_program.LoweringError, match="a constant array of shape"):
        _tile_program.lower([step], vals, [step.out_specs[0].key])


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


def _card_rows(n_ev, nsamp, seed):
    """Rows for the card: pulses and noise, a NaN sample (row 1), a NaN
    baseline (row 2), an infinite sample (row 3)."""
    rng = np.random.default_rng(seed)
    t = np.arange(nsamp)[None, :]
    bl = rng.uniform(100, 200, n_ev)
    wf = bl[:, None] + rng.uniform(50, 500, (n_ev, 1)) * np.clip((t - 100) / 20, 0, 1) \
        + rng.normal(0, 2, (n_ev, nsamp))
    wf[1 % n_ev, nsamp // 2] = np.nan
    bl[2 % n_ev] = np.nan
    wf[3 % n_ev, nsamp // 3] = np.inf
    return wf.astype(np.float32), bl.astype(np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("n_ev, nsamp", [(37, 256), (1, 1001), (600, 4096)])
@pytest.mark.parametrize("name", sorted(OP_CASES))
def test_op_on_the_card_equals_the_plain_walk(name, n_ev, nsamp, cuda_device):
    """Each op alone, one launch, every output bit for bit against the
    tape's plain walk on the same card."""
    out, code = OP_CASES[name]
    cfg = _inject_cfg() if code == "inject" else _ml_cfg()
    wf, bl = _card_rows(n_ev, nsamp, seed=len(name))
    step, vals, _, _ = one_op(cfg, name, wf, bl, [out], db=_db(n=nsamp))
    vals = {k: v.to(cuda_device) for k, v in vals.items()}
    prog = _tile_program.lower([step], vals, [sp.key for sp in step.out_specs])
    before = _cuda.LAUNCHES["generic_rows"]
    got = _cuda.generic_rows(prog, vals)
    assert _cuda.LAUNCHES["generic_rows"] == before + 1
    want = _cuda.generic_rows_plain(prog, vals)
    torch.cuda.synchronize()
    for k in want:
        assert _same(got[k], want[k]), k
