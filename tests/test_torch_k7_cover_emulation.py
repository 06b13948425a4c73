"""K7's ops of slice 19 run on the CPU by the emulation of ``tools/k7_emu``,
in its ``cover`` case (``run_k7_emu.COVER_CONFIG``: two groups at 4 rows of
600 samples with a NaN sample, a NaN baseline and an infinite sample):
every intermediate against the plain walk under ThreadSanitizer,
AddressSanitizer and the call-path build; and for each op with a barrier of
its own (``mean_below_threshold``, the ``count`` op of
``time_over_threshold`` and ``saturation``, ``linear_slope_diff``,
``log_check`` and ``trap_pickoff``), the same case with that barrier taken
out of the source must fail under ThreadSanitizer (a race on the reduction
buffers, on ``trap_pickoff``'s prefix, or on the plane space ``log_check``
writes while ``presum``'s threads still read it).
"""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(REPO, "tools", "k7_emu", "run_k7_emu.py")

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="needs g++ to build the emulation")


def _run(tmp_path, mode, *extra):
    return subprocess.run(
        [sys.executable, TOOL, "--mode", mode, "--rows", "4", "--build", str(tmp_path),
         *extra, "cover"],
        capture_output=True, text=True, timeout=600)


@pytest.mark.parametrize("mode", ["tsan", "asan", "sites"])
def test_k7_cover_emulation(tmp_path, mode):
    r = _run(tmp_path, mode)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    assert r.stdout.strip().endswith("OK")


@pytest.mark.parametrize("op", ["mean_below_threshold", "count", "linear_slope_diff",
                                "log_check", "trap_pickoff"])
def test_k7_cover_op_without_its_barrier_races(tmp_path, op):
    r = _run(tmp_path, "tsan", "--drop-barrier", op)
    assert r.returncode != 0
    assert "ThreadSanitizer: data race" in r.stdout + r.stderr, r.stdout[-4000:]
