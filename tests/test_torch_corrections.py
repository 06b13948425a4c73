"""The waveform corrections (``inl_correction``, ``wf_correction``,
``wf_alignment``, ``get_wf_centroid``) of the port against the JAX
package's, on the same seeded inputs (at most 64 events), their checkers
against the JAX checkers, their ``DSPFatal`` limits, and K7's
``wf_correction`` and ``wf_centroid`` ops alone. The cases mirror
``tests/ref_oracle/test_parity_misc.py:118-151``. Tolerances are
``test_torch_filters``'s (float64 within ``1e-9`` of the scale, float32
within ``2e-6``, NaN positions identical); the centroid and the aligned
samples are exact in both types.
"""

import os
import sys

import numpy as np
import pytest

import dspeed_tpu_torch.processors as tp
from dspeed_tpu_torch.errors import DSPFatal

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_filters import _check, _jax, _t  # noqa: E402
from torch_k7_ops import (  # noqa: E402
    check_against_pallas, check_float64_body, events, one_op,
)


def _jp():
    import dspeed_tpu.processors as jp

    return jp


def _checker(kern, jkern, *args):
    """The port's checker against the JAX package's on the same rows."""
    want = np.asarray(jkern.checker(*args))
    got = kern.checker(*(_t(a) for a in args)).numpy()
    np.testing.assert_array_equal(got, want)
    return got


# ---------------------------------------------------------------------------
# inl_correction


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("table", ["shared", "per_event", "nan_shared", "nan_event"])
def test_inl_correction_matches_jax(table, dtype):
    """Codes in range, one event with a code past the table (row 3) and one
    with a negative code (row 5)."""
    rng = np.random.default_rng(2)
    w = rng.integers(0, 1024, size=(8, 128), dtype=np.int32)
    w[3, 17] = 1024
    w[5, 90] = -1
    if table.endswith("shared"):
        inl = rng.uniform(-0.5, 0.5, 1024).astype(dtype)
    else:
        inl = rng.uniform(-0.5, 0.5, (8, 1024)).astype(dtype)
    if table == "nan_shared":
        inl[10] = np.nan
    elif table == "nan_event":
        inl[6, 10] = np.nan
    _check(tp.inl_correction(_t(w), _t(inl)), _jax(_jp().inl_correction, w, inl), dtype)


# ---------------------------------------------------------------------------
# wf_correction


def _wf(dtype, n=256, n_ev=8, seed=4):
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 10, (n_ev, n))
    w[1, 40] = np.nan
    return w.astype(dtype)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("corr, window", [
    ("shared", (32, 96)), ("shared", (0, 64)), ("shared", (200, 256)),
    ("per_event", (10, 50)), ("nan", (32, 96))])
def test_wf_correction_matches_jax(corr, window, dtype):
    rng = np.random.default_rng(6)
    w = _wf(dtype)
    c = rng.normal(0, 1, (8, 64) if corr == "per_event" else 64).astype(dtype)
    if corr == "nan":
        c[70 % 64] = np.nan
    args = (w, c, np.int32(window[0]), np.int32(window[1]))
    _check(tp.wf_correction(*(_t(a) for a in args)),
           _jax(_jp().wf_correction, *args), dtype)


@pytest.mark.parametrize("start, stop, err", [
    (-1, 10, "start_idx must be positive"),
    (300, 301, "start_idx must be shorter"),
    (0, -1, "stop_idx must be positive"),
    (0, 300, "stop_idx must be shorter"),
    (50, 50, "start_idx must be smaller"),
    (0, 100, "smaller than len"),
])
def test_wf_correction_limits_raise_as_jax(start, stop, err):
    w, c = _wf("float32"), np.zeros(64, np.float32)
    with pytest.raises(DSPFatal, match=err):
        tp.wf_correction(_t(w), _t(c), start, stop)
    with pytest.raises(Exception, match=err) as e:
        _jp().wf_correction(w, c, start, stop)
    assert type(e.value).__name__ == "DSPFatal"


# ---------------------------------------------------------------------------
# wf_alignment


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("centroid", [60.0, 18.0, 120.0, "per_event"])
@pytest.mark.parametrize("shift", [5.0, 0.0, "per_event"])
def test_wf_alignment_matches_jax(centroid, shift, dtype):
    """The three index cases (the window inside the row, near its start,
    the fallback to its first samples), per event and constant, a NaN
    centroid and a NaN shift; the checker too."""
    jp = _jp()
    rng = np.random.default_rng(8)
    w = rng.normal(0, 1, (8, 128)).astype(dtype)
    w[2, 5] = np.nan
    if centroid == "per_event":
        centroid = np.array([60, 18, 120, 21.5, 19.5, 107.9, 3, np.nan], dtype)
    if shift == "per_event":
        shift = np.array([5, 0, 5, 3, np.nan, 5, 30, 5], dtype)
    args = (w, centroid, shift, 40)
    want = _jax(jp.wf_alignment, *args, dims={"m": 40})
    got = tp.wf_alignment(*(_t(a) for a in args), dims={"m": 40})
    _check(got, want, dtype, exact=True)
    _checker(tp.wf_alignment, jp.wf_alignment, *args)


def test_wf_alignment_checker_codes():
    """Each of the JAX checker's codes: a NaN centroid, a NaN, negative and
    too large shift; a NaN row flags nothing."""
    w = np.random.default_rng(1).normal(0, 1, (6, 64)).astype("float32")
    w[5, 3] = np.nan
    c = np.array([np.nan, 20, 20, 20, 20, 20], np.float32)
    sh = np.array([1, np.nan, -1, 65, 2, 2], np.float32)
    got = _checker(tp.wf_alignment, _jp().wf_alignment, w, c, sh, 20)
    assert got.tolist() == [1, 2, 3, 4, 0, 0]


@pytest.mark.parametrize("size, err", [(0, "size must be positive"),
                                       (200, "size must be shorter")])
def test_wf_alignment_limits_raise_as_jax(size, err):
    w = _wf("float32", n=128)
    with pytest.raises(DSPFatal, match=err):
        tp.wf_alignment(_t(w), 30.0, 5.0, size, dims={"m": 40})
    with pytest.raises(Exception, match=err) as e:
        _jp().wf_alignment(w, 30.0, 5.0, size, dims={"m": 40})
    assert type(e.value).__name__ == "DSPFatal"


# ---------------------------------------------------------------------------
# get_wf_centroid


def _steps(dtype, n=256, n_ev=16, seed=9):
    """A step-convolution pattern (negative, a ramp through 0, positive)
    with noise: row 1 NaN, row 3 all positive (nothing found), row 4 with
    exact ties at its minimum and maximum, row 5 with its maximum first."""
    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float64)
    c = rng.uniform(100, 156, (n_ev, 1))
    w = np.clip((t - c) / 28.0, -1, 1) + rng.normal(0, 0.01, (n_ev, n))
    w[1] = np.nan
    w[3] = np.abs(w[3]) + 1
    w[4, [10, 20]] = -3.0
    w[4, [200, 210]] = 3.0
    w[5] = -w[5]
    return w.astype(dtype)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("shift", [5.0, 0.0, 2.5, "per_event"])
def test_get_wf_centroid_matches_jax(shift, dtype):
    jp = _jp()
    w = _steps(dtype)
    if shift == "per_event":
        shift = (np.arange(16) * 0.5).astype(dtype)
        shift[7] = np.nan
    _check(tp.get_wf_centroid(_t(w), _t(shift)), _jax(jp.get_wf_centroid, w, shift),
           dtype, exact=True)
    _checker(tp.get_wf_centroid, jp.get_wf_centroid, w, shift)


def test_get_wf_centroid_checker_codes():
    w = _steps("float32")[:5]
    sh = np.array([np.nan, 1, -2, 300, 4], np.float32)
    got = _checker(tp.get_wf_centroid, _jp().get_wf_centroid, w, sh)
    # row 1 is a NaN row: it flags nothing
    assert got.tolist() == [1, 0, 2, 3, 0]


# ---------------------------------------------------------------------------
# K7's wf_correction and wf_centroid ops


def _corr_cfg(dtype):
    c = "d" if dtype == "float64" else "f"
    return {
        "step_kernel": {"function": "step", "module": "dspeed_tpu.processors",
                        "args": ["16", f"step_kernel(64, '{c}')"]},
        "wf_corr": {"function": "wf_correction", "module": "dspeed_tpu.processors",
                    "args": ["wf_blsub", "step_kernel", "90", "154", "wf_corr"],
                    "unit": "ADC"},
        "wf_step": {"function": "convolve_wf", "module": "dspeed_tpu.processors",
                    "args": ["wf_blsub", "step_kernel", "'v'", f"wf_step(193, '{c}')"],
                    "unit": "ADC"},
        "centroid": {"function": "get_wf_centroid", "module": "dspeed_tpu.processors",
                     "args": ["wf_step", "shift_ev", "centroid"], "unit": "ns"},
        "shift_ev": "baseline * 0.02",
        "centroid_c": {"function": "get_wf_centroid", "module": "dspeed_tpu.processors",
                       "args": ["wf_step", "3", "centroid_c"], "unit": "ns"},
    }


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_wf_correction_op_matches_pallas_generic_rows(dtype):
    wf, bl = events(dtype)
    step, vals, _, _ = one_op(_corr_cfg(dtype), "wf_correction", wf, bl, ["wf_corr"])
    if dtype == "float64":
        check_float64_body(step, vals, _jp().wf_correction, "wf_correction")
        return
    prog = check_against_pallas(step, vals, _jp().wf_correction, "wf_correction")
    # the constant correction rides in the taps; no NaN among them
    assert prog.ops[-1].ip == [90, 154, 0, 0] and prog.n_taps == 64


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("out", ["centroid", "centroid_c"])
def test_wf_centroid_op_matches_pallas_generic_rows(out, dtype):
    """A per-event and a constant shift, both float32 (the chain casts a
    constant to the signature's type): the midpoint in float32."""
    wf, bl = events(dtype)
    step, vals, _, _ = one_op(_corr_cfg(dtype), "get_wf_centroid", wf, bl, [out])
    if dtype == "float64":
        check_float64_body(step, vals, _jp().get_wf_centroid, "wf_centroid")
        return
    prog = check_against_pallas(step, vals, _jp().get_wf_centroid, "wf_centroid")
    assert prog.ops[-1].ip[7] == 2
