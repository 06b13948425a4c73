"""K7's plane ops run on the CPU by the emulation of ``tools/k7_emu``,
in its ``plane`` case (``run_k7_emu.PLANE_CONFIG``: one group at 4 rows of
600 samples with a NaN sample, a NaN baseline and an infinite sample, each
new op in it): every intermediate bit for bit against the plain walk, on
every row, under ThreadSanitizer, AddressSanitizer and the call-path build;
and for each new op with a barrier of its own (``moving_window``, whose
barrier ends its prefix, ``gen_prefix``, as ``trap_filter``'s does, and
``reduce``), the same case with that barrier taken out of the source must
fail under ThreadSanitizer.
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
         *extra, "plane"],
        capture_output=True, text=True, timeout=600)


@pytest.mark.parametrize("mode", ["tsan", "asan", "sites"])
def test_k7_plane_emulation(tmp_path, mode):
    r = _run(tmp_path, mode)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    assert r.stdout.strip().endswith("OK")
    assert "every row bit for bit" in r.stdout


@pytest.mark.parametrize("op", ["moving_window", "reduce"])
def test_k7_plane_op_without_its_barrier_races(tmp_path, op):
    r = _run(tmp_path, "tsan", "--drop-barrier", op)
    assert r.returncode != 0
    assert "ThreadSanitizer: data race" in r.stdout + r.stderr, r.stdout[-4000:]
