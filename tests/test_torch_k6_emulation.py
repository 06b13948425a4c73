"""K6 (the up-domain kernel of ``dspeed_tpu_torch/csrc/fused_current.cu``)
run on the CPU by the emulation of ``tools/k6_emu``: the kernel's own source,
compiled with ``g++`` and one host thread per CUDA thread, beside a reference
kernel of the reference order (the whole row in shared memory,
``mw_cascade.cuh``'s block scan and stages, ``block_reduce.cuh``'s extrema),
on rows of full width.

- All four outputs equal the reference's bit for bit, at the flagship
  geometry, at L = 128 (301 -> 4788 and the chain's 300 -> 4784), at the
  other cascade types, with no stage, with a 3-sample window, on the
  generic instance (runs in shared memory; L = 128 too), at short rows and
  at L = 1; on rows whose samples span 120 binary orders,
  constant rows, extrema at both ends, denormal and large samples, NaN rows
  and infinite samples read and unread.
- Under ThreadSanitizer, a shared-memory access not ordered by a barrier is
  a reported race (dropping the barrier after the prefix stores fails).
- Under AddressSanitizer each block has exactly the launch's shared bytes;
  the same build checks ``k6_div`` against the division for every window
  length.
- In the call-path build every thread of a block barrier and every lane of
  a warp collective must arrive by one path.
"""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(REPO, "tools", "k6_emu", "run_k6_emu.py")

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="needs g++ to build the emulation")


@pytest.mark.parametrize("mode, args", [
    ("tsan", ["flagship_all", "generic_short"]),
    ("asan", ["--div", "50000", "L128", "chain_L128", "all_right", "no_stage",
              "L3", "generic", "generic_L128", "L1_ratio1"]),
    ("sites", ["short"]),
])
def test_k6_emulation(tmp_path, mode, args):
    r = subprocess.run(
        [sys.executable, TOOL, "--mode", mode, "--build", str(tmp_path), *args],
        capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    assert r.stdout.strip().endswith("OK")
    assert "0 of" in r.stdout or "--div" not in args
