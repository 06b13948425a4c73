"""K7's ops of the flagship extras (``poly_residual``, ``soft_pileup``,
``time_point_thresh`` in an interpolation mode, ``wf_correction``,
``wf_centroid``) run on the CPU by the emulation of ``tools/k7_emu``, in one
group (``run_k7_emu.EXTRAS_CONFIG``) at 4 rows of 600 samples with a NaN
sample, a NaN baseline and an infinite sample: every intermediate against
the plain walk under ThreadSanitizer, AddressSanitizer and the call-path
build; and for each op with a barrier of its own, the same case with that
barrier taken out of the source must fail under ThreadSanitizer (a race on
the reduction buffers, or on the samples the op reads after it).
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
         *extra, "extras"],
        capture_output=True, text=True, timeout=600)


@pytest.mark.parametrize("mode", ["tsan", "asan", "sites"])
def test_k7_extras_emulation(tmp_path, mode):
    r = _run(tmp_path, mode)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    assert r.stdout.strip().endswith("OK")


@pytest.mark.parametrize("op", ["poly_residual", "soft_pileup", "wf_centroid"])
def test_k7_extras_op_without_its_barrier_races(tmp_path, op):
    r = _run(tmp_path, "tsan", "--drop-barrier", op)
    assert r.returncode != 0
    assert "ThreadSanitizer: data race" in r.stdout + r.stderr, r.stdout[-4000:]
