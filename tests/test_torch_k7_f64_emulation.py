"""K7's float64 kernel (``generic_rows_kernel_f64``) run on the CPU by the
emulation of ``tools/k7_emu``, in its ``f64`` case: the float64 flagship's two
groups, the float64 DPZ's energy front and the float64 extras' three groups,
at 4 rows of 4096 samples (a NaN sample, a NaN baseline, an infinite sample
and a flat row), and the emulation's injection + ML, coverage (two groups)
and plane groups widened to float64 at 600 samples (every op of a float64
program: ``inject``, ``dense``, the coverage ops, the plane ops, ``ewise``
with bool planes, ``reduce``), and the SiPM chain's group on
``chip_smoke.sipm_edge_rows`` widened to float64 (the float64
``reflected_conv``), each also with every row 8 bytes off 16-byte
alignment. Every intermediate equals the plain walk bit for bit, on every
row, under ThreadSanitizer, AddressSanitizer and the call-path build (the
plain walk's float64 ``sqrt``, ``exp``, ``log``, ``pow``, ``tanh`` and the
rest taken from the host's libm, as the emulated kernel takes them). With
the float64 convolution's barrier taken out of the source (the one after it
stages the row's window, ``--drop-barrier conv_f64``), or the float64 dense
layer's (after its warps' partial sums, ``--drop-barrier dense_f64``), the
case must fail under ThreadSanitizer; so must the float64 SiPM group run
with the planned barrier before its ``reflected_conv`` cleared (the op reads
the row's neighbours and reflected edges that other threads loaded), which
the ``tsan`` run does on its own build.
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
         *extra, "f64"],
        capture_output=True, text=True, timeout=900)


@pytest.mark.parametrize("mode", ["tsan", "asan", "sites"])
def test_k7_f64_emulation(tmp_path, mode):
    r = _run(tmp_path, mode)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    assert r.stdout.strip().endswith("OK")
    assert r.stdout.count("every row bit for bit") == 22
    # the float64 SiPM group, both alignments, with its planned barrier
    # cleared: a race, under ThreadSanitizer
    races = r.stdout.count("without the planned barrier before reflected_conv: a race")
    assert races == (2 if mode == "tsan" else 0), r.stdout[-4000:]


def test_k7_f64_convolution_without_its_barrier_races(tmp_path):
    r = _run(tmp_path, "tsan", "--drop-barrier", "conv_f64")
    assert r.returncode != 0
    assert "ThreadSanitizer: data race" in r.stdout + r.stderr, r.stdout[-4000:]


def test_k7_f64_dense_layer_without_its_barrier_races(tmp_path):
    r = _run(tmp_path, "tsan", "--drop-barrier", "dense_f64")
    assert r.returncode != 0
    assert "ThreadSanitizer: data race" in r.stdout + r.stderr, r.stdout[-4000:]
