"""The rest of ``time_point_thresh.py`` in the port against the JAX package:
``interpolated_time_point_thresh``, ``multi_time_point_thresh``,
``bi_level_zero_crossing_time_points`` and the checkers (with
``time_point_thresh``'s), on the same seeded inputs (at most 64 events);
the bi-level trigger's sweep (``_cuda.bilevel_scan_plain``, and on the card
``csrc/bilevel_scan.cu`` bit for bit against it); K7's
``time_point_thresh`` op in its interpolation modes. The cases mirror
``tests/ref_oracle/test_parity_timing.py:59-160``. Tolerances are
``test_torch_filters``'s (float64 within ``1e-9`` of the scale, float32
within ``2e-6``, NaN positions identical), counts and indices exactly.

The ``gpu`` tests import neither JAX nor the JAX package and skip without
a card.
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
from test_torch_filters import _check, _jax, _t  # noqa: E402


def _jp():
    import dspeed_tpu.processors as jp

    return jp


def _steps(dtype, n_ev=8, n=256, seed=4):
    """Noisy rising edges at varied positions and amplitudes (the parity
    fixture ``step_batch``); row 3 all NaN, row 5 with an infinite sample
    after its rise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float64)
    pos = rng.integers(60, 180, size=(n_ev, 1))
    amp = rng.uniform(200, 3000, size=(n_ev, 1))
    w = amp / (1.0 + np.exp(-(t - pos) / 3.0)) + rng.normal(0, 0.3, (n_ev, n))
    w[3] = np.nan
    w[5, 230] = np.inf
    return w.astype(dtype), amp[:, 0]


# ---------------------------------------------------------------------------
# interpolated_time_point_thresh


# every mode in float32, two in float64 (each case compiles the JAX side)
CASES_32_64 = [(m, "float32") for m in "iabrnlfc"] + [(m, "float64") for m in "il"]


@pytest.mark.parametrize("mode, dtype", CASES_32_64)
@pytest.mark.parametrize("walk", [0, 1])
def test_interpolated_matches_jax(mode, walk, dtype):
    """Per-event thresholds (row 6's NaN) and starts: integral, not
    integral (it is truncated here), out of range and NaN."""
    jp = _jp()
    w, amp = _steps(dtype)
    thr = (amp * 0.3).astype(dtype)
    thr[6] = np.nan
    start = np.array([10, 200, 10.5, 199.7, -0.5, 256, np.nan, 100],
                     dtype)[:: 1 if walk else -1].copy()
    if not walk:
        start[[0, 2]] = [200, 210.5]
    for t_start in (start, 10.0 if walk else 200.0):
        args = (w, thr, t_start, walk, ord(mode))
        _check(tp.interpolated_time_point_thresh(*(_t(a) for a in args)),
               _jax(jp.interpolated_time_point_thresh, *args), dtype)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_interpolated_per_event_walk_matches_jax(dtype):
    jp = _jp()
    w, amp = _steps(dtype)
    walk = np.array([1, 0] * 4, np.int32)
    start = np.array([10, 200] * 4, dtype)
    args = (w, (amp * 0.5).astype(dtype), start, walk, ord("l"))
    _check(tp.interpolated_time_point_thresh(*(_t(a) for a in args)),
           _jax(jp.interpolated_time_point_thresh, *args), dtype)


def test_interpolated_backward_walk_stops_at_sample_2():
    """A crossing between samples 0 and 1 is not found walking back, one
    between 1 and 2 is (``i`` = 2), reported at 2 - 1 = 1 (the reference's
    loop runs ``i`` down to 2 and reports ``i - 1``)."""
    w = np.zeros((2, 16), np.float32)
    w[0, 1:] = 10.0  # crosses 5 between samples 0 and 1
    w[1, 2:] = 10.0  # between 1 and 2
    args = (w, 5.0, 10.0, 0, ord("i"))
    got = tp.interpolated_time_point_thresh(*(_t(a) for a in args))[0].numpy()
    want = np.asarray(_jax(_jp().interpolated_time_point_thresh, *args)[0])
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got[0]) and got[1] == 1.0


@pytest.mark.parametrize("mode", [0, ord("x")])
def test_interpolated_bad_mode_raises_as_jax(mode):
    w, _ = _steps("float32")
    with pytest.raises(DSPFatal, match="Unrecognized"):
        tp.interpolated_time_point_thresh(_t(w), 100.0, 10.0, 1, mode)
    with pytest.raises(Exception, match="Unrecognized") as e:
        _jp().interpolated_time_point_thresh(w, 100.0, 10.0, 1, mode)
    assert type(e.value).__name__ == "DSPFatal"


# ---------------------------------------------------------------------------
# multi_time_point_thresh


@pytest.mark.parametrize("mode, dtype", CASES_32_64)
@pytest.mark.parametrize("polarity", [1.0, -1.0])
def test_multi_matches_jax(mode, polarity, dtype):
    jp = _jp()
    rng = np.random.default_rng(12)
    w, _ = _steps(dtype)
    thr = rng.uniform(20, 160, (8, 8)).astype(dtype)
    thr[4, 2] = np.nan
    for t_start in (128.0, np.array([128, 0, 255, 64, 300, -1, np.nan, 10], dtype)):
        args = (w, thr, t_start, polarity, ord(mode))
        _check(tp.multi_time_point_thresh(*(_t(a) for a in args)),
               _jax(jp.multi_time_point_thresh, *args), dtype)


@pytest.mark.parametrize("polarity", [1.0, -1.0])
@pytest.mark.parametrize("t_start", [0.0, 1.0, 17.0, 31.0])
@pytest.mark.parametrize("mode, dtype", [("i", "float64"), ("a", "float64"),
                                         ("r", "float32"), ("l", "float32")])
def test_multi_chained_nonmonotone_matches_jax(mode, t_start, polarity, dtype):
    """Rows that are not monotone: each threshold walks on from its sorted
    predecessor's crossing, and a threshold not found ends its side
    (independent first-crossing searches differ here); ``t_start = 0`` with
    polarity -1 starts the down side at the virtual sample -1, which reads
    the row's wrapped last samples."""
    jp = _jp()
    rng = np.random.default_rng(int(t_start) + 7)
    w = rng.normal(0, 3, size=(6, 32))
    w[:, -1] = -5.0
    w[:, -2] = 5.0
    thr = rng.normal(0, 3, size=(6, 4))
    thr[:, 0] = thr[:, -1]  # duplicate thresholds share a crossing
    args = (w.astype(dtype), thr.astype(dtype), t_start, polarity, ord(mode))
    _check(tp.multi_time_point_thresh(*(_t(a) for a in args)),
           _jax(jp.multi_time_point_thresh, *args), dtype)


def test_multi_polarity_raises_as_jax():
    w, _ = _steps("float32")
    thr = np.full((8, 2), 100.0, np.float32)
    with pytest.raises(DSPFatal, match="polarity cannot be 0"):
        tp.multi_time_point_thresh(_t(w), _t(thr), 10.0, 0.0, ord("i"))
    with pytest.raises(Exception, match="polarity cannot be 0"):
        _jp().multi_time_point_thresh(w, thr, 10.0, 0.0, ord("i"))
    with pytest.raises(DSPFatal, match="static polarity"):
        tp.multi_time_point_thresh(_t(w), _t(thr), 10.0, torch.ones(8), ord("i"))
    with pytest.raises(DSPFatal, match="Unrecognized"):
        tp.multi_time_point_thresh(_t(w), _t(thr), 10.0, 1.0, ord("q"))


def test_multi_checker_matches_jax():
    jp = _jp()
    w, _ = _steps("float32")
    thr = np.full((8, 2), 100.0, np.float32)
    thr[2, 1] = np.nan
    t = np.array([10, 10, 10, 10, -1, 300, 10, 10], np.float32)
    for pol in (0.0, 1.0, np.array([0, 1, 0, 0, 0, 0, 0, 1], np.float32)):
        want = np.asarray(jp.multi_time_point_thresh.checker(w, thr, t, pol, ord("i")))
        got = tp.multi_time_point_thresh.checker(_t(w), _t(thr), _t(t), _t(pol),
                                                 ord("i")).numpy()
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the checkers of time_point_thresh and the bi-level trigger


def test_start_index_checkers_match_jax():
    """Each start-index flag: integral, not integral (1), out of range (2),
    a NaN start, row or threshold (no flag)."""
    jp = _jp()
    w, _ = _steps("float32")
    a = np.full(8, 100.0, np.float32)
    a[7] = np.nan
    t = np.array([10, 10.5, -1, 256, np.nan, 3, 3, 3], np.float32)
    for args in ((w, a, t, 1), (w, 100.0, 20.5, 0), (w, a, 300.0, 1)):
        want = np.asarray(jp.time_point_thresh.checker(*args))
        got = tp.time_point_thresh.checker(*(_t(x) for x in args)).numpy()
        np.testing.assert_array_equal(got, want)
    neg = np.full(8, -50.0, np.float32)
    neg[6] = np.nan
    for tt, codes in ((t, [0, 1, 2, 0, 0, 0, 0, 0]), (1.5, [1, 1, 1, 0, 1, 1, 0, 0])):
        want = np.asarray(jp.bi_level_zero_crossing_time_points.checker(
            w, a, neg, 20.0, tt))
        got = tp.bi_level_zero_crossing_time_points.checker(
            _t(w), _t(a), _t(neg), 20.0, _t(tt)).numpy()
        np.testing.assert_array_equal(got, want)
        # a NaN row (3), threshold (7, 6) or start (4) flags nothing
        assert got.tolist() == codes


# ---------------------------------------------------------------------------
# bi_level_zero_crossing_time_points and its sweep


def _bipolar(dtype, n_ev=12, n=512, seed=5):
    """Differentiated-pulse-like rows (the parity fixture ``bipolar_batch``:
    a positive lobe, then a negative one through zero), made to hit the
    state machine's corners: row 2 NaN; row 6 two pulses back to back
    inside one gate; row 7 two far apart; row 8 a sine that crosses more
    often than the slots hold; row 9 a negative pulse first."""
    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float64)

    def pulse(c, a, s=8.0):
        return a * (t - c) / s * np.exp(-((t - c) ** 2) / (2 * s**2))

    w = np.zeros((n_ev, n))
    for i in range(n_ev):
        for c in rng.integers(60, 400, size=rng.integers(1, 4)):
            w[i] += pulse(c, rng.uniform(100, 1000))
    w[6] = pulse(100, 500) + pulse(125, 500)
    w[7] = pulse(100, 500) + pulse(400, 500)
    w[8] = 300 * np.sin(2 * np.pi * t / 24)
    w[9] = -pulse(200, 600)
    w += rng.normal(0, 0.5, size=w.shape)
    w[2] = np.nan
    return w.astype(dtype)


@pytest.mark.parametrize("gate, t_start, dtype", [
    (20.0, 0.0, "float32"), (60.0, 0.0, "float64"), (60.0, 110.0, "float32"),
    (60.0, "per_event", "float32"), (60.0, "per_event", "float64"),
    (5.0, 0.0, "float32")])
def test_bi_level_matches_jax(gate, t_start, dtype):
    """Counts past the slots (row 8), gates that do and do not hold both
    pulses of row 6, a start in the middle of a pulse (110), and per-event
    starts that are integral, not integral, out of range and NaN."""
    jp = _jp()
    w = _bipolar(dtype)
    if t_start == "per_event":
        t_start = np.array([0, 5, 0, 101.5, 600, -3, 110, 0, 3, np.nan, 0, 200], dtype)
    args = (w, 40.0, -40.0, gate, t_start)
    want = _jax(jp.bi_level_zero_crossing_time_points, *args, dims={"m": 8})
    got = tp.bi_level_zero_crossing_time_points(*(_t(a) for a in args), dims={"m": 8})
    _check(got, want, dtype, exact=True)
    if np.ndim(t_start) == 0 and t_start == 0.0 and gate > 10:
        assert int(got[0][8]) > 8  # the sine's triggers outnumber the slots


@pytest.mark.parametrize("dtype, rows", [
    ("float32", "bipolar"), ("float64", "bipolar"), ("float32", "edge"),
    ("float64", "edge")], ids=["float32", "float64", "edge-float32", "edge-float64"])
def test_bi_level_per_event_thresholds_match_jax(dtype, rows):
    """Per-event thresholds, gates and starts: on ``_bipolar``'s rows, and
    on ``chip_smoke.bilevel_edge_rows`` (the rows that ``tools/scan_emu``
    holds the kernel to, 4096 samples), where the plain sweep is also held
    against the JAX package's scan on each row it does not set to NaN."""
    jp = _jp()
    if rows == "bipolar":
        w = _bipolar(dtype)
        pos = np.linspace(20, 200, len(w)).astype(dtype)
        neg = -pos[::-1].copy()
        pos[4] = np.nan
        gate = np.linspace(10, 80, len(w)).astype(dtype)
        args, m = (w, pos, neg, gate, 0.0), 3
    else:
        sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        import chip_smoke as cs

        w, (pos, neg), (gate, start) = cs.bilevel_edge_rows(4096)
        args = (w.astype(dtype), pos.astype(dtype), neg.astype(dtype),
                gate.astype(dtype), start.astype(dtype))
        m = 8
    want = _jax(jp.bi_level_zero_crossing_time_points, *args, dims={"m": m})
    _check(tp.bi_level_zero_crossing_time_points(*(_t(a) for a in args), dims={"m": m}),
           want, dtype, exact=True)
    if rows == "edge":
        nc, pol, trig = _cuda.bilevel_scan_plain(_t(args[0]), _t(args[1]), _t(args[2]),
                                                 _t(gate), _t(start), m)
        good = ~np.isnan(args[0]).any(1)
        np.testing.assert_array_equal(nc.numpy()[good], np.asarray(want[0])[good])
        for got, ref in ((pol, want[1]), (trig, want[2])):
            np.testing.assert_array_equal(got.numpy()[good], np.asarray(ref)[good])
        assert (nc.numpy()[good] > m).sum() >= 2 and nc.numpy()[good].sum() > 1000


def test_bi_level_on_rc_cr2_matches_jax():
    """The trigger on its filter's output: the extras chain's pair at 64
    events of 4096 samples (``rc_cr2`` at 20 samples, thresholds +-500, a
    gate of 200 samples), one trigger an event."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke as cs

    jp = _jp()
    wf, _, _, bl, _ = cs.make_hpge_waveforms(64)
    x = wf - bl[:, None].astype(np.float32)
    rc = tp.rc_cr2(_t(x), float(cs.EXTRAS_RC_TAU))[0]
    args = (rc.numpy(), 500.0, -500.0, 200.0, 0.0)
    got = tp.bi_level_zero_crossing_time_points(rc, *args[1:], dims={"m": 8})
    _check(got, _jax(jp.bi_level_zero_crossing_time_points, *args, dims={"m": 8}),
           "float32", exact=True)
    assert (got[0].numpy() == 1).all()


def test_bilevel_scan_updates_in_the_jax_order():
    """The three places the step's order decides, each on a row made for
    it (the JAX package gives the same): a rise through +5 (above = 1),
    through 0 at 4 and -5 at 5 inside the gate, one trigger of polarity 1 at
    4; the same with -5 only at 6, so that ``i - above`` is 5 - 1 = 4: no
    trigger with a gate of 4, one with 5 (the test ``i - above < gate``);
    a negative lobe first, polarity 0 at 3; slots stop at ``m`` while the
    count goes on."""
    jp = _jp()
    w = np.array([
        [0, 1, 6, 6, 1, -6, -6, -6],
        [0, 1, 6, 1, -1, -1, -6, -6],
        [0, -1, -6, -1, 1, 6, -1, -6],
    ], dtype=np.float32)
    for gate, counts in ((4, [1, 0, 1]), (5, [1, 1, 1])):
        g = torch.full((3,), gate, dtype=torch.int32)
        nc, pol, trig = _cuda.bilevel_scan_plain(
            _t(w), torch.full((3,), 5.0), torch.full((3,), -5.0), g,
            torch.zeros(3, dtype=torch.int32), 1)
        assert nc.tolist() == counts
        assert pol[0, 0] == 1 and trig[0, 0] == 4 and pol[2, 0] == 0 and trig[2, 0] == 3
        want = jp.bi_level_zero_crossing_time_points.fn(w, 5.0, -5.0, float(gate), 0.0,
                                                         dims={"m": 1})
        np.testing.assert_array_equal(np.asarray(want[0]), nc.numpy())
        np.testing.assert_array_equal(np.asarray(want[2]), trig.numpy())
    # the sine of _bipolar's row 8 counts every trigger and keeps the first m
    w8 = torch.from_numpy(_bipolar("float32")[8:9])
    one = torch.ones(1, dtype=torch.int32)
    nc8, pol8, _ = _cuda.bilevel_scan_plain(w8, 40 * one.float(), -40 * one.float(),
                                            60 * one, 0 * one, 3)
    assert int(nc8[0]) > 3 and not torch.isnan(pol8).any()


# ---------------------------------------------------------------------------
# K7's time_point_thresh op in its interpolation modes


@pytest.mark.parametrize("mode, walk, dtype", [(m, 1, "float32") for m in "iabrnlfc"]
                         + [(m, 0, "float32") for m in "ilr"] + [("l", 1, "float64")])
def test_interpolated_op_matches_pallas_generic_rows(mode, walk, dtype):
    from torch_k7_ops import check_against_pallas, check_float64_body, events, one_op

    jp = _jp()
    wf, bl = events(dtype)
    cfg = {"tp_i": {"function": "interpolated_time_point_thresh",
                    "module": "dspeed_tpu.processors",
                    "args": ["wf_blsub", "a_ev", "t_ev", walk, f"'{mode}'", "tp_i"],
                    "unit": "ns"},
           "a_ev": "baseline * 0.5",
           "t_ev": "baseline * 0.0 + " + ("90" if walk else "200")}
    step, vals, _, _ = one_op(cfg, "interpolated_time_point_thresh", wf, bl, ["tp_i"])
    if dtype == "float64":
        check_float64_body(step, vals, jp.interpolated_time_point_thresh,
                           "time_point_thresh")
        return
    prog = check_against_pallas(step, vals, jp.interpolated_time_point_thresh,
                                "time_point_thresh")
    assert prog.ops[-1].ip[:2] == [walk, ord(mode)]


# ---------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _same(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and bool(
        ((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B, n, m", [(37, 512, 8), (1, 513, 1), (70, 4096, 3),
                                     (33, 1001, 40)])
def test_bilevel_scan_kernel_equals_plain(cuda_device, dtype, B, n, m):
    """Bit for bit: rows of every corner above, odd lengths (no 16-byte
    copies), a block's worth plus one row, strided rows."""
    w = torch.from_numpy(np.resize(_bipolar("float64", n=n), (B, n))).to(dtype)
    w = torch.cat([w, w[:, :7]], 1)[:, :n].contiguous().to(cuda_device)
    g = torch.Generator().manual_seed(B)
    pos = (20 + 60 * torch.rand(B, generator=g)).to(dtype).to(cuda_device)
    neg = -pos
    gate = torch.randint(5, 80, (B,), generator=g, dtype=torch.int32).to(cuda_device)
    start = torch.randint(0, n // 4, (B,), generator=g, dtype=torch.int32).to(cuda_device)
    for rows in (w, torch.cat([w, w], 1)[:, 3:3 + n]):
        before = _cuda.LAUNCHES["bilevel_scan"]
        got = _cuda.bilevel_scan(rows, pos, neg, gate, start, m)
        assert _cuda.LAUNCHES["bilevel_scan"] == before + 1
        want = _cuda.bilevel_scan_plain(rows, pos, neg, gate, start, m)
        for a, b in zip(got, want):
            assert _same(a, b), (B, n, m, dtype)


@pytest.mark.gpu
def test_bi_level_on_the_card_equals_the_cpu(cuda_device):
    w = _bipolar("float32")
    args = (40.0, -40.0, 60.0, 0.0)
    got = tp.bi_level_zero_crossing_time_points(_t(w).to(cuda_device), *args,
                                                 dims={"m": 8})
    want = tp.bi_level_zero_crossing_time_points(_t(w), *args, dims={"m": 8})
    for a, b in zip(got, want):
        assert _same(a.cpu(), b)
    launch = _cuda.bilevel_scan_launch()
    assert launch["local_bytes"] == 0 and launch["rows"] == 4
