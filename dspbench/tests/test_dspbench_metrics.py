"""Each metric reader on a hand-made record, and the trace reductions."""

import math

import pytest

import run
import tracing

RECORD = {
    "first_call_s": 1.25,
    "setup_s": 14.5,
    "window_s": 2.0,
    "events": 400,
    "chunks": 4,
    "stats": {"loading_s": 0.02, "processing_s": 0.5, "write_s": 0.1},
    "handover": [0.0, 1.0, 2.0, 3.0],
    "spans": {
        "stage": [(0.0, 0.1), (1.0, 1.3), (2.0, 2.1), (3.0, 3.1)],
        "dispatch": [(0.2, 0.25), (1.3, 1.35), (2.2, 2.25), (3.2, 3.25)],
        "fetch": [(0.3, 0.5), (1.4, 1.6), (2.4, 2.6), (3.4, 4.0)],
    },
    # two kernels overlapping by 0.1 s and one copy, in a 2 s window
    "device": {"kernels": [(0.0, 0.3, "a"), (0.2, 0.5, "b")],
               "copies": [(1.0, 1.5, "Memcpy HtoD")]},
    "bytes_per_event": 1e9,
    "peak_bytes_s": 4e12,
}
WANT = {
    "first_call_ms": 1250.0,
    "setup_s": 14.5,
    "wf_per_s": 200.0,
    "input_wait_ms": 5.0,
    # latencies 0.5, 0.6, 0.6, 1.0: numpy's 95th percentile interpolates
    "chunk_ms_p95": 940.0,
    "stage_ms": 150.0,
    "dispatch_ms": 50.0,
    "fetch_ms": 300.0,
    "kernels_per_chunk": 0.5,
    # 400 events x 1 GB over 4 TB/s = 0.1 s against 0.5 s of kernels
    "kernels_roofline": 20.0,
    # 0.5 s of kernels and 0.5 s of the copy busy of 2 s
    "device_idle_pct": 50.0,
}


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader(name):
    got = run.read_metrics([name], RECORD, {name: "u"})
    assert math.isclose(got[name]["value"], WANT[name], rel_tol=1e-9), got


@pytest.mark.parametrize("name", ["chunk_ms_p95", "stage_ms", "kernels_per_chunk",
                                  "kernels_roofline", "device_idle_pct",
                                  "input_wait_ms"])
def test_a_reader_with_nothing_to_read_gives_nothing(name):
    assert run.read_metrics([name], {"events": 0, "chunks": 0}, {name: "u"}) == {}


def test_union_and_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0)]
    assert tracing.union_s(iv) == 3.0
    assert tracing.gaps(iv, -1.0, 5.0) == [(-1.0, 0.0), (2.0, 3.0), (4.0, 5.0)]


def test_breakdown_names_idle_time_by_host_state():
    b = tracing.breakdown(RECORD["device"], RECORD["spans"], [(0.0, 4.0)], 0.0, 2.0)
    assert b["device_ops"][0] == ["Memcpy HtoD", 0.5]
    idle = dict(b["idle_gaps"])
    # idle 0.5-1.0 (midpoint 0.75: inside the file, no wrapped call) and
    # 1.5-2.0 (midpoint 1.75: no call either)
    assert idle == {"build_dsp, no wrapped call (waits, chain lookup, output append)": 1.0}


def test_judge():
    ok, checks = run.judge({"bad_share": 0.0, "energy_gap": 2e-7},
                           {"bad_share": 1e-4, "energy_gap": 1e-6})
    assert ok and checks["energy_gap"] == {"value": 2e-7, "limit": 1e-6}
    assert not run.judge({"bad_share": 2e-4}, {"bad_share": 1e-4})[0]
    assert not run.judge({"bad_share": 0.0}, {"bad_share": None})[0]
    assert not run.judge({"bad_share": float("nan")}, {"bad_share": 1.0})[0]
