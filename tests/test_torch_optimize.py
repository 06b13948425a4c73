"""The fitting processors of the port against the JAX package's on the same
seeded inputs: the pole-zero optimisers (``optimize.py``), the
non-negative least squares (``nnls.py``) and the DPLMS filter factory
(``energy_kernels.dplms``).

- ``optimize_1pz`` within ``1e-6`` relative of the JAX package's tau in
  float64, on ``tests/ref_oracle/test_parity_models.py``'s decay batch
  (:118-131), and on the true tau;
- ``optimize_2pz`` by the objective it reaches, as that file holds it
  (:136-180): at most ``max(2 x`` the JAX package's ``, 1e-2)``;
- ``optimize_nnls`` within ``1e-9`` relative of the JAX package's in
  float64, and against ``scipy.optimize.nnls`` as
  ``tests/processors/test_ml_optimize.py:84`` holds the JAX package's;
- ``dplms`` bit for bit in float64.

The optimisers run at 512 samples. The ``gpu`` test holds
``optimize_2pz``'s pole (the recurrence kernel, one row per event and
simplex vertex) bit for bit against ``recurrence_plain``; it imports neither
JAX nor the JAX package.
"""

import os
import sys

import numpy as np
import pytest
import torch

import dspeed_tpu_torch.processors as tp
from dspeed_tpu_torch.errors import DSPFatal
from dspeed_tpu_torch.processors import _cuda

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_filters import _jax, _t  # noqa: E402


def _jp():
    import dspeed_tpu.processors as jp

    return jp


def _decay_batch(seed, tau=120.0, n_ev=4, n=512):
    """``tests/ref_oracle/test_parity_models.py``'s decay batch."""
    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float64)
    amp = rng.uniform(500, 2000, size=(n_ev, 1))
    return np.where(t >= 20, amp * np.exp(-(t - 20) / tau), 0.0)


# ---------------------------------------------------------------------------
# optimize_1pz


@pytest.mark.parametrize("tau", [120.0, 1500.0])
def test_optimize_1pz_matches_jax(tau):
    w = _decay_batch(4, tau)
    got = tp.optimize_1pz(_t(w), 0.0, 40.0, 500.0, 100.0)[0].numpy()
    want = np.asarray(_jax(_jp().optimize_1pz, w, 0.0, 40.0, 500.0, 100.0)[0])
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got, tau, rtol=1e-2)


def test_optimize_1pz_per_event_rows():
    """Rows with noise and a baseline, a baseline and a start one an event:
    one NaN sample, one NaN baseline, one NaN start give NaN there; the rest
    within 1e-6 of the JAX package's in float64. The port's float32 rows
    give float32 taus within 1e-4 of its float64 ones (the JAX package's own
    scan cannot take float32 rows under x64: its golden ratio is a numpy
    float64 that widens the scan's carry)."""
    rng = np.random.default_rng(8)
    w = _decay_batch(5, 300.0, n_ev=6) + 40.0 + rng.normal(0, 0.05, (6, 512))
    w[1, 100] = np.nan
    base = np.full(6, 40.0)
    base[2] = np.nan
    p0 = np.array([200.0, 250, 300, np.nan, 350, 400])
    args = (w, base, 40.0, 500.0, p0)
    got = tp.optimize_1pz(*(_t(a) for a in args))[0].numpy()
    want = np.asarray(_jax(_jp().optimize_1pz, *args)[0])
    np.testing.assert_array_equal(np.isnan(got), [False, True, True, True, False, False])
    np.testing.assert_allclose(got, want, rtol=1e-6)
    args32 = [a.astype(np.float32) if isinstance(a, np.ndarray) else a for a in args]
    got32 = tp.optimize_1pz(*(_t(a) for a in args32))[0].numpy()
    assert got32.dtype == np.float32
    np.testing.assert_allclose(got32, got, rtol=1e-4)


@pytest.mark.parametrize("name, extra", [("optimize_1pz", (100.0,)),
                                         ("optimize_2pz", (1000.0, 1.0, 120.0, 30.0, 0.25))])
def test_optimizer_range_raises_as_jax(name, extra):
    w = _decay_batch(4)
    with pytest.raises(DSPFatal, match="the time range is out of range"):
        getattr(tp, name)(_t(w), 0.0, 40.0, 600.0, *extra)
    with pytest.raises(Exception, match="the time range is out of range") as e:
        getattr(_jp(), name)(w, 0.0, 40.0, 600.0, *extra)
    assert type(e.value).__name__ == "DSPFatal"


# ---------------------------------------------------------------------------
# optimize_2pz


def _two_exp(seed, n_ev=3, n=512, t1=150.0, t2=20.0, frac=0.3):
    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float64)
    amp = rng.uniform(500, 2000, size=(n_ev, 1))
    return np.where(t >= 20, amp * ((1 - frac) * np.exp(-(t - 20) / t1)
                                    + frac * np.exp(-(t - 20) / t2)), 0.0)


def _objective(w, tau1, tau2, frac, beg=40, end=500):
    """The JAX package's objective at ``(tau1, tau2, frac)`` per event."""
    import jax.numpy as jnp

    from dspeed_tpu.processors.optimize import _dpz_traced, _slope_objective

    y = _dpz_traced(jnp.asarray(w), *(jnp.asarray(np.asarray(v, np.float64))
                                      for v in (tau1, tau2, frac)))
    return np.asarray(_slope_objective(y, beg, end))


@pytest.mark.parametrize("start", [(120.0, 30.0, 0.25), (400.0, 5.0, 0.6)])
def test_optimize_2pz_reaches_the_jax_objective(start):
    w = _two_exp(6)
    args = (w, 0.0, 40.0, 500.0, 1000.0, 1.0, *start)
    got = tuple(g.numpy() for g in tp.optimize_2pz(*(_t(a) for a in args)))
    want = _jax(_jp().optimize_2pz, *args)
    o_got, o_want = _objective(w, *got), _objective(w, *want)
    assert np.all(o_got <= np.maximum(2.0 * o_want, 1e-2)), (o_got, o_want)
    assert np.all(_objective(w, *start) > 1e3 * o_got)


def test_optimize_2pz_nan_rows_and_bounds():
    """A NaN sample or baseline gives NaN in all three outputs (a NaN start
    fraction does not, as in the JAX package); the taus stay at or under
    their bound and the fraction under its bound."""
    w = _two_exp(7, n_ev=4)
    w[1, 200] = np.nan
    base = np.array([0.0, 0.0, np.nan, 0.0])
    got = tp.optimize_2pz(_t(w), _t(base), 40.0, 500.0, 100.0, 0.5, 120.0, 30.0, 0.25)
    for g in got:
        np.testing.assert_array_equal(np.isnan(g.numpy()), [False, True, True, False])
    tau1, tau2, frac = (g.numpy()[[0, 3]] for g in got)
    assert (tau1 <= 100.0 * (1 + 1e-12)).all() and (tau2 <= 100.0 * (1 + 1e-12)).all()
    assert ((frac > 0) & (frac < 0.5)).all()


def test_dpz_traced_is_the_jax_pole():
    """The objective's double pole zero (numerator, prefix, the pole on the
    recurrence's plain version) against the JAX package's associative scan,
    one parameter set a row."""
    import jax.numpy as jnp

    from dspeed_tpu.processors.optimize import _dpz_traced
    from dspeed_tpu_torch.processors.optimize import dpz_traced

    w = _two_exp(9, n_ev=5)
    tau1 = np.array([150.0, 200, 90, 1000, 150])
    tau2 = np.array([20.0, 5, 40, 10, 20])
    frac = np.array([0.3, 0.1, 0.5, 0.05, 0.0])
    got = dpz_traced(_t(w), _t(tau1), _t(tau2), _t(frac)).numpy()
    want = np.asarray(_dpz_traced(jnp.asarray(w), jnp.asarray(tau1), jnp.asarray(tau2),
                                  jnp.asarray(frac)))
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-9 * np.abs(want).max())


# ---------------------------------------------------------------------------
# optimize_nnls


def _nnls_case(seed, n_ev=3, m=20, n=8):
    rng = np.random.default_rng(seed)
    A = np.abs(rng.normal(0, 1, (m, n)))
    xs = np.abs(rng.normal(0, 1, (n_ev, n))) * np.array([1, 0, 1, 1, 0, 1, 0, 1.0])
    return A, np.einsum("mn,bn->bm", A, xs), xs


@pytest.mark.parametrize("maxiter, min_value", [(1000, 0.0), (0, 0.0), (40, 0.0),
                                                (0, 0.5)])
def test_optimize_nnls_matches_jax(maxiter, min_value):
    A, b, _ = _nnls_case(2)
    b[1, 3] = np.nan
    args = (A, b, maxiter, 1e-10, False, min_value)
    dims = {"m": 20, "n": 8}
    got = tp.optimize_nnls(*(_t(a) for a in args), dims=dims)[0].numpy()
    want = np.asarray(_jp().optimize_nnls(*args, dims=dims)[0])
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-9,
                               atol=1e-9 * np.abs(want[ok]).max())


def test_optimize_nnls_matches_scipy():
    from scipy.optimize import nnls as scipy_nnls

    A, b, _ = _nnls_case(0)
    (sol,) = tp.optimize_nnls(_t(A), _t(b), 0, 1e-8, 0, 0.0, dims={"m": 20, "n": 8})
    for i in range(3):
        exp, _ = scipy_nnls(A, b[i])
        np.testing.assert_allclose(sol.numpy()[i], exp, atol=1e-10)


def test_optimize_nnls_takes_the_first_events_matrix():
    """A matrix given one an event: the first event's serves every event,
    as in the JAX package; float32 vectors give float32 results."""
    A, b, _ = _nnls_case(3)
    A_ev = np.stack([A, 2 * A, 3 * A])
    got = tp.optimize_nnls(_t(A_ev), _t(b), 0, 0.0, 0, 0.0, dims={"m": 20, "n": 8})[0]
    same = tp.optimize_nnls(_t(A), _t(b), 0, 0.0, 0, 0.0, dims={"m": 20, "n": 8})[0]
    assert torch.equal(got, same)
    b32 = b.astype(np.float32)
    A32 = A.astype(np.float32)
    got32 = tp.optimize_nnls(_t(A32), _t(b32), 0, 0.0, 0, 0.0, dims={"m": 20, "n": 8})[0]
    want32 = np.asarray(_jp().optimize_nnls(A32, b32, 0, 0.0, 0, 0.0,
                                            dims={"m": 20, "n": 8})[0])
    assert got32.dtype == torch.float32
    np.testing.assert_allclose(got32.numpy(), want32, atol=2e-5 * np.abs(want32).max())


# ---------------------------------------------------------------------------
# dplms


def _dplms_inputs(length=64, ssize=200, seed=1):
    rng = np.random.default_rng(seed)
    noise = rng.normal(0, 1, (4000, length))
    nm = np.cov(noise.T)
    t = np.arange(ssize)
    ref = np.clip((t - ssize / 2 + 5) / 10, 0, 1) * np.exp(-np.maximum(t - ssize / 2, 0) / 400)
    return nm, ref


@pytest.mark.parametrize("a3, ff", [(0.0, 1.0), (1e-3, 0.0), (0.5, 1.0)])
def test_dplms_matches_jax_bit_for_bit(a3, ff):
    nm, ref = _dplms_inputs()
    got = tp.dplms(nm, ref, 1.0, 5.0, a3, ff, dims={"n": 64})
    want = _jp().dplms(nm, ref, 1.0, 5.0, a3, ff, dims={"n": 64})
    got, want = (np.asarray(g if not isinstance(g, tuple) else g[0]) for g in (got, want))
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    assert tp.dplms_filter is tp.dplms


@pytest.mark.parametrize("args, err", [
    ((1.0, 5.0, 0.0, 2.0), "must be 0 or 1"),
    ((0.0, 5.0, 0.0, 1.0), "for the noise must be positive"),
    ((1.0, -1.0, 0.0, 1.0), "for the reference must be positive"),
    ((1.0, 5.0, -1.0, 1.0), "must not be negative"),
])
def test_dplms_limits_raise_as_jax(args, err):
    nm, ref = _dplms_inputs()
    with pytest.raises(DSPFatal, match=err):
        tp.dplms(nm, ref, *args, dims={"n": 64})
    with pytest.raises(Exception, match=err) as e:
        _jp().dplms(nm, ref, *args, dims={"n": 64})
    assert type(e.value).__name__ == "DSPFatal"
    with pytest.raises(DSPFatal, match="not consistent with the noise matrix"):
        tp.dplms(nm, ref, 1.0, 5.0, 0.0, 1.0, dims={"n": 32})


# ---------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_optimize_2pz_pole_on_the_card_is_the_plain_recurrence(dtype, cuda_device):
    """``dpz_traced``'s pole: the recurrence kernel with one coefficient a
    row (events x vertices) against ``recurrence_plain`` on the same card,
    bit for bit; one launch."""
    from dspeed_tpu_torch.processors.optimize import dpz_traced

    rng = np.random.default_rng(4)
    w = torch.from_numpy(_two_exp(2, n_ev=96, n=4096)).to(cuda_device, dtype)
    w[5, 100] = float("nan")
    tau1 = torch.from_numpy(rng.uniform(50, 3000, 96)).to(cuda_device, dtype)
    tau2 = torch.from_numpy(rng.uniform(2, 50, 96)).to(cuda_device, dtype)
    frac = torch.from_numpy(rng.uniform(0, 1, 96)).to(cuda_device, dtype)
    before = _cuda.LAUNCHES["recurrence"]
    got = dpz_traced(w, tau1, tau2, frac, end=3000)
    assert _cuda.LAUNCHES["recurrence"] == before + 1
    real = _cuda.recurrence
    try:
        _cuda.recurrence = _cuda.recurrence_plain
        want = dpz_traced(w, tau1, tau2, frac, end=3000)
    finally:
        _cuda.recurrence = real
    torch.cuda.synchronize()
    assert got.shape == (96, 3000)
    assert bool(((got == want) | (torch.isnan(got) & torch.isnan(want))).all())
