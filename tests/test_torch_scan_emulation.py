"""The two sweep kernels (``dspeed_tpu_torch/csrc/peakdet_scan.cu`` and
``csrc/bilevel_scan.cu``, one warp a row) run on the CPU by the emulation of
``tools/scan_emu``: the kernels' own sources, compiled with ``g++`` and one
host thread per CUDA thread, held bit for bit against their plain versions.

- The peak finder's sweep, float32 and float64, both directions, on
  ``chip_smoke.peakdet_edge_rows`` at 1019 samples and 20 + 20 slots: a NaN
  ``amax``, a sine that fills every slot, plateaus, infinite and NaN
  samples, a constant row, signed zeros, zigzags that declare at every
  sample across sweep positions 31/32 and 127/128 and in the ragged last
  step; rows contiguous and at a stride past an offset.
- The bi-level trigger's sweep, float32 and float64, on
  ``chip_smoke.bilevel_edge_rows`` at 4096 samples (and a ragged 4093): a
  sine past its slots, starts 1000, 333 and 7, a gate of 5, NaN and
  infinite samples, pairs that cross zero and a threshold at once,
  threshold pairs straddling two steps, thresholds at 0; rows aligned (16-
  byte loads) and unaligned at a stride of 2n, with 8, 40 and 1 slots.
- Under AddressSanitizer every buffer has exactly its size (no block has
  shared memory); in the call-path build every lane of a warp collective
  must arrive by one path (neither kernel has a block barrier, so there is
  no ThreadSanitizer build).
"""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(REPO, "tools", "scan_emu", "run_scan_emu.py")

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="needs g++ to build the emulation")


@pytest.mark.parametrize("mode, cases", [
    ("asan", ["peakdet_f32", "peakdet_f64", "bilevel_f32", "bilevel_f64"]),
    ("sites", ["peakdet_f64", "bilevel_f32"]),
])
def test_scan_emulation(tmp_path, mode, cases):
    r = subprocess.run(
        [sys.executable, TOOL, "--mode", mode, "--build", str(tmp_path), *cases],
        capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    assert r.stdout.strip().endswith("OK")
    assert r.stdout.count("bit for bit") == len(cases)
