"""The recursive-filter family and the small scalar processors of the port
against the JAX package's, on the same seeded inputs (64 events at most).

Each module has one parametrised test; every case hands the same numpy
arrays to a JAX processor (x64 CPU) and to its counterpart in
``dspeed_tpu_torch`` on the CPU, where the recurrences run their plain
version (:func:`dspeed_tpu_torch.processors._cuda.recurrence_plain`). The
tolerances: float64 outputs within ``1e-9`` of the output's scale
(``max |jax|``), float32 outputs within ``2e-6`` of it, counts and indices
exactly, NaN positions identical. The port accumulates every recurrence in
float64 where the JAX package runs a float32 row's in float32 (blocked
matmuls and associative scans), so a float32 output differs by the JAX
package's rounding, a few float32 ulps of the scale.

The ``gpu`` tests hold the recurrence kernel (``csrc/recurrence.cu``)
against its plain version bit for bit; they import neither JAX nor the JAX
package, and skip without a card.
"""

import numpy as np
import pytest
import torch

import dspeed_tpu_torch.processors as tp
from dspeed_tpu_torch.processors import _cuda

REL = {"float64": 1e-9, "float32": 2e-6}
N = 512
# samples a row of the cases whose JAX function runs an associative scan:
# each distinct scan shape compiles anew, so they share one length
RF_N = 96


def _jp():
    import dspeed_tpu.processors as jp

    return jp


def _jax(k, *args, **kw):
    """A JAX processor's outputs (a tuple) on the same arguments, traced
    once under ``jax.jit`` with the per-event arrays (the first argument,
    and arrays of as many rows) as its operands and every other argument
    static, as the chain passes constants: a scan's primitives then compile
    as one program instead of one by one."""
    import jax

    fn = getattr(k, "fn", k)
    rows = np.shape(args[0])[:1]
    pos = [i for i, a in enumerate(args)
           if isinstance(a, np.ndarray) and a.ndim and a.shape[:1] == rows]

    def f(*arrs):
        full = list(args)
        for i, a in zip(pos, arrs):
            full[i] = a
        return fn(*full, **kw)

    out = jax.jit(f)(*[args[i] for i in pos])
    return out if isinstance(out, tuple) else (out,)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x


def _batch(n_ev=24, n=N, seed=5, dtype="float32", tau1=300.0, tau2=20.0,
           frac=0.05):
    """Steps with a two-exponential tail (``(1 - frac) e^(-t/tau1) + frac
    e^(-t/tau2)``), a baseline, noise; row 3 holds a NaN sample."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)[None, :]
    t0 = rng.integers(n // 4, n // 3, (n_ev, 1))
    amp = rng.uniform(100, 4000, (n_ev, 1))
    dt = np.maximum(t - t0, 0)
    tail = (1 - frac) * np.exp(-dt / tau1) + frac * np.exp(-dt / tau2)
    wf = np.where(t >= t0, amp * tail, 0.0) + rng.normal(0, 2, (n_ev, n))
    wf[3, n // 2] = np.nan
    return wf.astype(dtype)


def _check(got, want, dtype, exact=False):
    """``got`` (tensors) against ``want`` (JAX arrays): the rule above."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    rel = REL[np.dtype(dtype).name]
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.shape == w.shape, (i, g.shape, w.shape)
        assert g.dtype == w.dtype, (i, g.dtype, w.dtype)
        if not np.issubdtype(w.dtype, np.floating):
            np.testing.assert_array_equal(g, w, err_msg=f"output {i}")
            continue
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w),
                                      err_msg=f"output {i}: NaN positions")
        ok = np.isfinite(w)
        np.testing.assert_array_equal(g[~ok & ~np.isnan(w)], w[~ok & ~np.isnan(w)])
        g64, w64 = g[ok].astype(np.float64), w[ok].astype(np.float64)
        if w64.size == 0:
            continue
        if exact:
            np.testing.assert_array_equal(g64, w64, err_msg=f"output {i}")
            continue
        err = np.abs(g64 - w64).max()
        scale = np.abs(w64).max()
        assert err <= rel * scale, f"output {i}: {err:.3e} > {rel:g} * {scale:.3e}"


# ---------------------------------------------------------------------------
# _numerics.iir_first_order and the pole-zero module


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("y_init", ["zero", "rows"])
def test_iir_first_order_matches_jax(dtype, y_init):
    from dspeed_tpu.processors import _numerics as jn
    from dspeed_tpu_torch.processors import _numerics as tn

    x = np.nan_to_num(_batch(dtype=dtype))
    y0 = (np.arange(x.shape[0], dtype=dtype) * 3.0 if y_init == "rows"
          else np.zeros((), dtype))
    want = _jax(jn.iir_first_order, x, 0.99, y_init=y0)
    got = tn.iir_first_order(_t(x), 0.99, y_init=_t(y0) if y0.ndim else 0.0)
    _check(got, want, dtype)


def _pz_case(name, dtype):
    jp = _jp()
    wf = _batch(dtype=dtype, n=RF_N if "oscillat" in name or "convolve" in name else N)
    taus = np.array([0.0, 5.0, 300.0, np.nan, 40.0] * 5, dtype)[: len(wf)]
    if name == "rc_exp":
        return _jax(jp.rc_exp, taus), tp.rc_exp(_t(taus))
    if name == "rc_exp_const":
        return _jax(jp.rc_exp, 300.0), tp.rc_exp(300.0)
    # double_pole_zero against the JAX package's body in float64, rounded to
    # the row's type: on a float32 row the JAX package rounds the numerator
    # to float32, where it cancels, and moves the output by up to ~4e-5 of
    # the scale (the known difference of tests/test_torch_dpz.py); the port
    # takes the numerator on the float64 prefix
    if name == "double_pole_zero":
        want = _jax(jp.double_pole_zero, wf.astype("float64"), 300.0, 20.0, 0.05)
        return ((np.asarray(want[0]).astype(dtype),),
                tp.double_pole_zero(_t(wf), 300.0, 20.0, 0.05))
    if name == "double_pole_zero_nan_frac":
        return (_jax(jp.double_pole_zero, wf, 300.0, 20.0, np.nan),
                tp.double_pole_zero(_t(wf), 300.0, 20.0, np.nan))
    if name == "convolve_exp":
        return _jax(jp.convolve_exp, wf, 30.0), tp.convolve_exp(_t(wf), 30.0)
    if name == "convolve_exp_per_event":
        tau = np.linspace(5.0, 80.0, len(wf))
        return _jax(jp.convolve_exp, wf, tau), tp.convolve_exp(_t(wf), _t(tau))
    if name == "convolve_damped_oscillator":
        return (_jax(jp.convolve_damped_oscillator, wf, 50.0, 0.3, 0.2),
                tp.convolve_damped_oscillator(_t(wf), 50.0, 0.3, 0.2))
    if name == "inject_damped_oscillation":
        return (_jax(jp.inject_damped_oscillation, wf, 50.0, 0.3, 0.2, 0.1),
                tp.inject_damped_oscillation(_t(wf), 50.0, 0.3, 0.2, 0.1))
    frac = np.linspace(0.0, 0.2, len(wf))
    return (_jax(jp.inject_damped_oscillation, wf, 50.0, 0.3, 0.2, frac),
            tp.inject_damped_oscillation(_t(wf), 50.0, 0.3, 0.2, _t(frac)))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", [
    "rc_exp", "rc_exp_const", "double_pole_zero", "double_pole_zero_nan_frac",
    "convolve_exp", "convolve_exp_per_event", "convolve_damped_oscillator",
    "inject_damped_oscillation", "inject_damped_oscillation_per_event",
])
def test_pole_zero_module_matches_jax(name, dtype):
    want, got = _pz_case(name, dtype)
    if name == "rc_exp_const":  # a number is taken in float64
        np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-15)
        return
    _check(got, want, dtype)


def test_double_pole_zero_inverts_its_tail():
    """On a noiseless step with the two-exponential tail it inverts, the
    output is the flat step (float64), as in the reference."""
    rng = np.random.default_rng(1)
    t = np.arange(N)
    amp = rng.uniform(100, 1000, 4)[:, None]
    dt = np.maximum(t - 100, 0)
    wf = np.where(t >= 100, amp * (0.95 * np.exp(-dt / 300.0) + 0.05 * np.exp(-dt / 20.0)), 0.0)
    got = tp.double_pole_zero(_t(wf), 300.0, 20.0, 0.05)[0].numpy()
    np.testing.assert_allclose(got[:, 100:], np.broadcast_to(amp, (4, N - 100)),
                               rtol=1e-9)


# ---------------------------------------------------------------------------
# recursive_filter, iir_filter, rc_cr2


def _rf_oracle(w, a, b, init_in, init_out):
    """The reference's recursion in float64 numpy, sample by sample:
    ``y[i] = (sum_j a[j] x[i-j] - sum_k b[k] y[i-k]) / b[0]``, with
    ``init_in`` / ``init_out`` before the row."""
    w = np.asarray(w, np.float64)
    B, n = w.shape
    p, q = len(a), len(b)
    xp = np.concatenate([np.broadcast_to(np.asarray(init_in, np.float64)[..., None]
                                         * np.ones((B, 1)), (B, p - 1)), w], axis=1)
    y = np.empty((B, n + q - 1))
    y[:, : q - 1] = np.asarray(init_out, np.float64)[..., None] * np.ones((B, 1))
    for i in range(n):
        u = sum(a[j] * xp[:, p - 1 + i - j] for j in range(p))
        acc = u / b[0]
        for k in range(1, q):
            acc = acc - (b[k] / b[0]) * y[:, q - 1 + i - k]
        y[:, q - 1 + i] = acc
    return y[:, q - 1 :]


def _rf_case(name, dtype):
    jp = _jp()
    wf = _batch(n=RF_N, dtype=dtype)
    if name == "order2":
        a, b = np.array([0.2, 0.3, 0.1]), np.array([1.0, -1.2, 0.4])
        return (_jax(jp.recursive_filter, wf, a, b, 0.0, 0.0),
                tp.recursive_filter(_t(wf), a, b, 0.0, 0.0))
    if name == "order1_init":
        a, b = np.array([0.5]), np.array([1.0, -0.9])
        return (_jax(jp.recursive_filter, wf, a, b, 2.0, 5.0),
                tp.recursive_filter(_t(wf), a, b, 2.0, 5.0))
    if name == "order0":
        a, b = np.array([0.5, 0.25]), np.array([2.0])
        return (_jax(jp.recursive_filter, wf, a, b, 1.0, 0.0),
                tp.recursive_filter(_t(wf), a, b, 1.0, 0.0))
    if name == "nan_taps":
        a, b = np.array([0.5, np.nan]), np.array([1.0, -0.5])
        return (_jax(jp.recursive_filter, wf, a, b, 0.0, 0.0),
                tp.recursive_filter(_t(wf), a, b, 0.0, 0.0))
    if name == "order4":
        import scipy.signal as sg

        b, a = sg.butter(4, 0.2)
        init = wf[:, 0].astype("float64")
        return (_jax(jp.recursive_filter, wf, b, a, init, init),
                tp.recursive_filter(_t(wf), b, a, _t(init), _t(init)),
                _rf_oracle(wf, b, a, init, init))
    b, a = _per_event_taps(len(wf))
    return (_jax(jp.recursive_filter, wf, b, a, 0.0, 0.0),
            tp.recursive_filter(_t(wf), _t(b), _t(a), 0.0, 0.0))


def _per_event_taps(n_ev):
    r = np.linspace(0.5, 0.95, n_ev)[:, None]
    b = np.concatenate([1 - r, np.zeros_like(r)], axis=1) + [[0.0, 0.01]]
    a = np.concatenate([np.ones_like(r), -r], axis=1)
    return b, a


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", ["order2", "order1_init", "order0", "nan_taps",
                                  "order4", "per_event"])
def test_recursive_filter_module_matches_jax(name, dtype):
    want, got, *oracle = _rf_case(name, dtype)
    if oracle and dtype == "float64":
        # a known difference: the JAX package's companion-matrix scan loses
        # ~1e-8 of the scale on a 4th-order Butterworth in float64; the
        # port's sequential float64 recursion is held to the reference's
        # recursion (a float64 numpy oracle) at 1e-9, and the JAX package
        # to the oracle at 1e-6
        w_or = oracle[0].astype(dtype)
        w_or[np.isnan(np.asarray(want[0]))] = np.nan
        _check(got, (w_or,), dtype)
        ok = np.isfinite(w_or)
        scale = np.abs(w_or[ok]).max()
        assert np.abs(np.asarray(want[0])[ok] - w_or[ok]).max() <= 1e-6 * scale
        return
    _check(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", ["iir_lowpass", "iir_bandpass", "notch", "peak"])
def test_iir_filter_module_matches_jax(name, dtype):
    jp = _jp()
    wf = _batch(n=RF_N, dtype=dtype)
    if name == "iir_lowpass":
        args = ("iir_filter", (0.1, 4))  # the order-4 scan of "order4"
    elif name == "iir_bandpass":
        args = ("iir_filter", ([0.05, 0.3], 2), {"btype": "bandpass"})  # order 4
    elif name == "notch":
        args = ("notch_filter", (0.2, 0.05))
    else:
        args = ("peak_filter", (0.2, 0.05))
    kw = args[2] if len(args) > 2 else {}
    jk = getattr(jp, args[0])(*args[1], **kw)
    tk = getattr(tp, args[0])(*args[1], **kw)
    assert tk.signature == jk.signature and tk.types == jk.types
    _check(tk(_t(wf))[0], _jax(jk, wf)[0], dtype)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("tau", ["static", "per_event", "zero", "nan"])
def test_rc_cr2_matches_jax(tau, dtype):
    """Rows 10, 11 and 12 hold an infinite sample at 0, 1 and 2 (F9: with a
    static tau the JAX package, and so the port, gives NaN from sample 3 on
    after an infinite first sample, which the checker flags; with a
    per-event tau both carry the infinity)."""
    jp = _jp()
    wf = _batch(n=RF_N, dtype=dtype)
    wf[10, 0], wf[11, 1], wf[12, 2] = -np.inf, np.inf, -np.inf
    if tau == "per_event":
        t = np.linspace(10.0, 200.0, len(wf)).astype(dtype)
        t[7] = np.nan
        want, got = _jax(jp.rc_cr2, wf, t), tp.rc_cr2(_t(wf), _t(t))
    else:
        t = {"static": 50.0, "zero": 0.0, "nan": np.nan}[tau]
        want, got = _jax(jp.rc_cr2, wf, t), tp.rc_cr2(_t(wf), t)
    _check(got, want, dtype)
    jc = np.asarray(jp.rc_cr2.checker(wf, 50.0))
    tc = tp.rc_cr2.checker(_t(wf), 50.0).numpy()
    np.testing.assert_array_equal(tc, jc)
    assert tc[10:13].tolist() == [1, 1, 1]
    if tau == "static":
        assert np.isnan(got[0].numpy()[10:13, 3:]).all()


def _sequential(name, w, a):
    """The reference's sequential recursions in float64 numpy, sample by
    sample: ``rc_cr2``'s third-order one (``y[0:3] = w[0:3]``; ``a`` one
    value a row) and ``double_pole_zero``'s second-order one (``y[0:2] =
    w[0:2]``; ``a`` = ``(a, b, p)``); the recursive filters' is
    :func:`_rf_oracle`."""
    w = np.asarray(w, np.float64)
    y = w.copy()
    with np.errstate(invalid="ignore", over="ignore"):
        if name.startswith("rc_cr2"):
            a = np.broadcast_to(np.asarray(a, np.float64), (len(w),))
            for i in range(3, w.shape[1]):
                y[:, i] = (3 * a * y[:, i - 1] - 3 * a * a * y[:, i - 2]
                           + a**3 * y[:, i - 3] + w[:, i] - 2 * w[:, i - 1] + w[:, i - 2])
        else:
            pa, pb, p = a
            for i in range(2, w.shape[1]):
                y[:, i] = (w[:, i] - (pa + pb) * w[:, i - 1] + pa * pb * w[:, i - 2]
                           + (1 + p) * y[:, i - 1] - p * y[:, i - 2])
    return y


# the positions of the infinity fuzz: the first three samples, the middle
# and the last
INF_AT = (0, 1, 2, RF_N // 2, RF_N - 1)
# where the JAX package's scans spread NaN from an infinity to samples the
# reference's recursion leaves finite or infinite (ROADMAP §3, known
# differences): its blocked first-order scan backward (rc_cr2 with a static
# tau, double_pole_zero over its whole row from sample 1 on), its
# companion-matrix scan one sample later than the recursion after an
# infinity at sample 1; the port is held to the reference's sequential
# recursion there
SEQUENTIAL = {"rc_cr2": (RF_N // 2, RF_N - 1),
              "double_pole_zero": (1, 2, RF_N // 2, RF_N - 1),
              "recursive_filter": (1,), "iir_filter": (1,)}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", ["rc_cr2", "rc_cr2_per_event", "double_pole_zero",
                                  "recursive_filter", "convolve_exp", "iir_filter",
                                  "notch_filter"])
def test_recurrence_clients_on_an_infinity(name, dtype):
    """Every client of the recurrence with an infinity at sample 0, 1, 2,
    the middle and the last (rows 0-4 +inf, rows 5-9 -inf; row 10 clean):
    against the JAX package, or where its blocked scan spreads NaN backward
    (``SEQUENTIAL``) against the reference's sequential recursion, NaN and
    infinite positions identical (the fuzz that would have caught F9)."""
    jp = _jp()
    wf = np.nan_to_num(_batch(n_ev=11, n=RF_N, dtype=dtype))
    for r, k in enumerate(INF_AT * 2):
        wf[r, k] = np.inf if r < 5 else -np.inf
    taus = np.linspace(20.0, 80.0, len(wf)).astype(dtype)
    b4, a4 = np.array([0.2, 0.3, 0.1]), np.array([1.0, -1.2, 0.4])
    if name == "rc_cr2":
        want, got = _jax(jp.rc_cr2, wf, 50.0), tp.rc_cr2(_t(wf), 50.0)
        seq = _sequential(name, wf, np.exp(-1 / 50.0))
    elif name == "rc_cr2_per_event":
        want, got = _jax(jp.rc_cr2, wf, taus), tp.rc_cr2(_t(wf), _t(taus))
    elif name == "double_pole_zero":
        # as test_pole_zero_module_matches_jax holds it: the JAX body on
        # float64 rows, rounded to the row's type
        want = (np.asarray(_jax(jp.double_pole_zero, wf.astype("float64"), 300.0, 20.0,
                                0.05)[0]).astype(dtype),)
        got = tp.double_pole_zero(_t(wf), 300.0, 20.0, 0.05)
        a, b = np.exp(-1 / 300.0), np.exp(-1 / 20.0)
        seq = _sequential(name, wf, (a, b, b + 0.05 * (a - b)))
    elif name == "recursive_filter":
        want = _jax(jp.recursive_filter, wf, b4, a4, 0.0, 0.0)
        got = tp.recursive_filter(_t(wf), b4, a4, 0.0, 0.0)
        with np.errstate(invalid="ignore"):
            seq = _rf_oracle(wf, b4, a4, 0.0, 0.0)
    elif name == "convolve_exp":
        want, got = _jax(jp.convolve_exp, wf, 30.0), tp.convolve_exp(_t(wf), 30.0)
    elif name == "iir_filter":
        import scipy.signal as sg

        want, got = _jax(jp.iir_filter(0.1, 4), wf), tp.iir_filter(0.1, 4)(_t(wf))
        # the factory's initial state: the first sample in, its DC-gain
        # scaled value out
        num, den = sg.iirfilter(4, 0.1, btype="lowpass", ftype="butter")
        w0 = wf[:, 0].astype(np.float64)
        with np.errstate(invalid="ignore"):
            seq = _rf_oracle(wf, num, den, w0, w0 * (num.sum() / den.sum()))
    else:
        want, got = _jax(jp.notch_filter(0.2, 0.05), wf), tp.notch_filter(0.2, 0.05)(_t(wf))
    want = np.array(want[0], copy=True)
    rows = [r for r, k in enumerate(INF_AT * 2) if k in SEQUENTIAL.get(name, ())]
    if rows:
        want[rows] = seq[rows].astype(dtype)
    _check(got[0], want, dtype)


# ---------------------------------------------------------------------------
# the spline, fixed_time_pickoff 's', interpolating_upsampler


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", ["w2", "forward", "reverse"])
def test_spline_matches_jax(name, dtype):
    from dspeed_tpu.processors import _spline as js
    from dspeed_tpu_torch.processors import _spline as ts

    wf = _batch(n=RF_N, dtype=dtype)
    if name == "w2":
        _check(ts.natural_spline_w2(_t(wf)), _jax(js.natural_spline_w2, wf), dtype)
        return
    m = np.linspace(-0.3, 0.6, wf.shape[-1]).astype(dtype)
    rev = name == "reverse"
    _check(ts.affine_recurrence(_t(m), _t(wf), reverse=rev),
           _jax(js.affine_recurrence, m, wf, reverse=rev), dtype)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("t", ["static", "per_event"])
def test_pickoff_spline_mode_matches_jax(t, dtype):
    jp = _jp()
    wf = _batch(n=RF_N, dtype=dtype)
    if t == "static":
        args = (40.25,)
    else:
        tt = np.linspace(-1.0, RF_N + 1.0, len(wf)).astype(dtype)
        tt[2], tt[4] = 17.0, np.nan
        args = (tt,)
    want = _jax(jp.fixed_time_pickoff, wf, *args, ord("s"))
    got = tp.fixed_time_pickoff(_t(wf), *map(_t, args), ord("s"))
    _check(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("mode", list("infclhs"))
@pytest.mark.parametrize("m", [4 * RF_N, 5 * RF_N // 2 + 1])
def test_interpolating_upsampler_matches_jax(mode, m, dtype):
    jp = _jp()
    wf = _batch(n=RF_N, dtype=dtype)
    if mode == "i" and m % RF_N:
        pytest.raises(Exception, tp.interpolating_upsampler, _t(wf), ord("i"),
                      dims={"m": m})
        return
    want = jp.interpolating_upsampler.fn(wf, ord(mode), dims={"m": m})
    got = tp.interpolating_upsampler(_t(wf), ord(mode), dims={"m": m})
    _check(got, want, dtype)


# ---------------------------------------------------------------------------
# get, get_default, mean_below_threshold, misc, and the additions to
# trap_filters, min_max and linear_slope_fit


@pytest.mark.parametrize("name", ["get_f", "get_i", "get_static", "default_f",
                                  "default_i", "default_nan_value"])
def test_get_module_matches_jax(name):
    jp = _jp()
    rng = np.random.default_rng(2)
    a = rng.normal(0, 10, (12, 30))
    a[1, 4] = np.nan
    idx = np.array([0, 4, -1, -30, -31, 29, 30, 100, 5, 3, -2, 7])
    if name.endswith("_i"):
        a = rng.integers(-50, 50, a.shape).astype("int32")
    if name == "get_f":
        want, got = _jax(jp.get, a, idx), tp.get(_t(a), _t(idx))
    elif name == "get_i":
        want, got = _jax(jp.get, a, idx), tp.get(_t(a), _t(idx))
    elif name == "get_static":
        want, got = _jax(jp.get, a, -3), tp.get(_t(a), -3)
    elif name == "default_f":
        want, got = _jax(jp.get_default, a, idx, 7.5), tp.get_default(_t(a), _t(idx), 7.5)
    elif name == "default_i":
        want, got = _jax(jp.get_default, a, idx, -1), tp.get_default(_t(a), _t(idx), -1)
    else:
        want = _jax(jp.get_default, a, np.full(12, 4), np.nan)
        got = tp.get_default(_t(a), _t(np.full(12, 4)), np.nan)
    _check(got, want, "float64", exact=True)
    np.testing.assert_array_equal(tp.get.checker(_t(a), _t(idx)).numpy(),
                                  np.asarray(jp.get.checker(a, idx)))


def _misc_case(name, dtype):
    jp = _jp()
    wf = _batch(dtype=dtype)
    if name == "mean_below_threshold":
        return _jax(jp.mean_below_threshold, wf, 50.0), tp.mean_below_threshold(_t(wf), 50.0)
    if name == "mean_below_threshold_none":
        return (_jax(jp.mean_below_threshold, wf, -1e9),
                tp.mean_below_threshold(_t(wf), -1e9))
    if name == "time_over_threshold":
        thr = np.linspace(0, 500, len(wf)).astype(dtype)
        return (_jax(jp.time_over_threshold, wf, thr),
                tp.time_over_threshold(_t(wf), _t(thr)))
    if name == "saturation":
        w = np.round(np.abs(np.nan_to_num(wf))) % 9
        w[3, 0] = np.nan
        return _jax(jp.saturation, w, 3), tp.saturation(_t(w), 3)
    if name.startswith("presum"):
        norm = int(name[-1])
        return (_jax(jp.presum, wf, norm, dims={"m": N // 8}),
                tp.presum(_t(wf), norm, dims={"m": N // 8}))
    if name == "pad":
        li = np.arange(len(wf)) * 17 % N
        off = (np.arange(len(wf)) % 5 * 3).astype(dtype)
        off[6] = 2.5
        return (_jax(jp.pad, wf, li, off, -1.0, -2.0, dims={"m": N + 40}),
                tp.pad(_t(wf), _t(li), _t(off), -1.0, -2.0, dims={"m": N + 40}))
    if name == "log_check":
        w = np.abs(wf) + 1
        w[5, 7] = 0.0
        return _jax(jp.log_check, w), tp.log_check(_t(w))
    if name == "sort":
        return _jax(jp.sort, wf), tp.sort(_t(wf))
    if name == "trap_pickoff":
        t = np.linspace(0, N + 5, len(wf)).astype(dtype)
        t = np.round(t)
        t[4] = 300.5
        return (_jax(jp.trap_pickoff, wf, 40, 10, t), tp.trap_pickoff(_t(wf), 40, 10, _t(t)))
    if name == "trap_pickoff_static":
        return (_jax(jp.trap_pickoff, wf, 40, 10, 300), tp.trap_pickoff(_t(wf), 40, 10, 300))
    if name == "min_max_norm":
        amin = np.nanmin(wf, axis=1)
        amax = np.nanmax(wf, axis=1)
        amin[2], amax[8] = 0.0, 0.0
        return (_jax(jp.min_max_norm, wf, amin, amax),
                tp.min_max_norm(_t(wf), _t(amin), _t(amax)))
    slope = np.linspace(-0.1, 0.1, len(wf)).astype(dtype)
    icpt = np.linspace(-5, 5, len(wf)).astype(dtype)
    icpt[9] = np.nan
    return (_jax(jp.linear_slope_diff, wf, slope, icpt),
            tp.linear_slope_diff(_t(wf), _t(slope), _t(icpt)))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", [
    "mean_below_threshold", "mean_below_threshold_none", "time_over_threshold",
    "saturation", "presum0", "presum1", "pad", "log_check", "sort",
    "trap_pickoff", "trap_pickoff_static", "min_max_norm", "linear_slope_diff",
])
def test_scalar_processors_match_jax(name, dtype):
    want, got = _misc_case(name, dtype)
    _check(got, want, dtype)


def test_tile_safe_flags_match_jax():
    jp = _jp()
    from dspeed_tpu_torch.processors import _modules

    for name in ("double_pole_zero", "get", "get_default", "mean_below_threshold",
                 "time_over_threshold", "saturation", "presum", "log_check",
                 "trap_pickoff", "min_max_norm", "linear_slope_diff", "rc_cr2",
                 "recursive_filter", "convolve_exp", "interpolating_upsampler",
                 "pad", "sort"):
        assert name in _modules
        assert getattr(getattr(tp, name), "tile_safe", False) == getattr(
            getattr(jp, name), "tile_safe", False), name


# ---------------------------------------------------------------------------
# the recurrence kernel on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _same(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and bool(
        ((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def recurrence_cases(B, n, dtype, device, seed=0):
    """``{name: (u, kwargs)}``: every mode of the recurrence kernel, with a
    NaN row, an infinite sample and rows that decay or grow."""
    g = torch.Generator().manual_seed(seed)
    u = torch.randn(B, n, generator=g, dtype=torch.float64).to(dtype)
    if B > 2:
        u[1, n // 3] = float("nan")
        u[2, n // 2] = float("inf")
    u = u.to(device)
    rows = torch.linspace(-0.99, 0.999, B, dtype=torch.float64).to(device)
    pos = torch.linspace(-0.3, 0.6, n, dtype=torch.float64).to(device)
    y0 = torch.linspace(-5, 5, B, dtype=torch.float64).to(device)
    c3 = torch.tensor([-1.2, 0.5, -0.06], dtype=torch.float64, device=device)
    c9 = torch.linspace(-0.3, 0.2, 9, dtype=torch.float64).to(device)
    cases = {
        "const": dict(m=0.9993),
        "const_y0": dict(m=0.97, y0=y0),
        "rows": dict(m=rows, y0=y0),
        "pos": dict(m=pos, per_position=True),
        "pos_reverse": dict(m=pos, per_position=True, reverse=True),
        "const_reverse": dict(m=-0.5, reverse=True, y0=y0),
        "order3": dict(c=c3, y0=y0[:, None].expand(B, 3)),
        "order3_rows": dict(c=c3 * (1 + rows[:, None] / 10)),
        "order9": dict(c=c9 / 10, y0=y0[:, None].expand(B, 9)),
        "order600": dict(c=torch.full((600,), 1e-4, dtype=torch.float64,
                                      device=device)),
    }
    return {k: (u, v) for k, v in cases.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B, n", [(37, 1001), (1, 64), (70, 4096)])
def test_recurrence_kernel_equals_plain(cuda_device, dtype, B, n):
    for name, (u, kw) in recurrence_cases(B, n, dtype, cuda_device).items():
        before = _cuda.LAUNCHES["recurrence"]
        got = _cuda.recurrence(u, **kw)
        assert _cuda.LAUNCHES["recurrence"] == before + 1
        want = _cuda.recurrence_plain(u, **kw)
        assert _same(got, want), (name, B, n, dtype)


@pytest.mark.gpu
def test_recurrence_kernel_takes_strided_rows(cuda_device):
    u = torch.randn(40, 300, dtype=torch.float32, device=cuda_device)
    got = _cuda.recurrence(u[:, 10:250], 0.9)
    assert _same(got, _cuda.recurrence_plain(u[:, 10:250], 0.9))
    launch = _cuda.recurrence_launch()
    assert launch["local_bytes"] == 0 and launch["rows"] == 32


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["double_pole_zero", "rc_cr2", "rc_cr2_rows",
                                  "notch", "recursive_filter", "spline"])
def test_filters_on_the_card_equal_the_cpu(cuda_device, name):
    """Each client of the kernel on the card against the same call on the
    CPU (the plain recurrence): bit for bit where the rest of the body is
    elementwise, else within the float32 rule."""
    wf = torch.from_numpy(_batch(n_ev=40, n=1001, dtype="float32"))
    fns = {
        "double_pole_zero": lambda w: tp.double_pole_zero(w, 300.0, 20.0, 0.05),
        "rc_cr2": lambda w: tp.rc_cr2(w, 50.0),
        "rc_cr2_rows": lambda w: tp.rc_cr2(
            w, torch.linspace(10, 90, 40, device=w.device)),
        "notch": lambda w: tp.notch_filter(0.2, 0.05)(w),
        "recursive_filter": lambda w: tp.recursive_filter(
            w, np.array([0.2, 0.3, 0.1]), np.array([1.0, -1.2, 0.4, -0.1]), 0.0, 0.0),
        "spline": lambda w: tp.fixed_time_pickoff(
            w, torch.linspace(0, 1000, 40, device=w.device), ord("s")),
    }
    got = fns[name](wf.to(cuda_device))[0].cpu()
    want = fns[name](wf)[0]
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    ok = ~torch.isnan(want)
    err = (got[ok].double() - want[ok].double()).abs().max().item()
    assert err <= 2e-6 * want[ok].double().abs().max().item(), (name, err)
