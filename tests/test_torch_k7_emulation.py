"""K7 (``dspeed_tpu_torch/csrc/generic_rows.cu``) run on the CPU by the
emulation of ``tools/k7_emu``: the kernel's own source, compiled with
``g++`` and one host thread per CUDA thread, on the small chains at 4 rows.

- Under ThreadSanitizer, two threads' accesses to shared memory with no
  barrier between them are a reported race: a barrier that the host's
  plan leaves out, or a reduction buffer taken again too early, fails
  (``RED_CONFIG`` puts reductions back to back).
- Under AddressSanitizer each block has exactly the launch's shared bytes,
  so a plan that sizes its planes, scratch or tape too small fails; rows
  of 1001 samples start 4 bytes off 16-byte alignment.
- In the call-path build every thread of a block barrier and every lane of
  a warp collective must arrive by one path.
- The SiPM chain's group (``reflected_convolve_wf``'s op and ``avg_current``
  over float64 planes) equals the plain walk bit for bit on every row; the
  barrier before the op's reads of other threads' samples is what keeps
  ThreadSanitizer quiet there.

Every output of the group's ``full`` lowering is held against the plain
walk by ``chip_smoke.check_generic``'s rule (the convolution within its
tolerance: the CPU's plain convolution sums in another order).
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


# each build in a process of its own: building chains numbers their
# variables, which the tests that compare keys with the JAX package's count on
@pytest.mark.parametrize("mode, cases", [
    ("tsan", ["reductions", "ops256"]),
    ("asan", ["reductions", "ops1001"]),
    ("sites", ["ops256"]),
    ("tsan", ["sipm"]),
    ("asan", ["sipm"]),
    ("sites", ["sipm"]),
])
def test_k7_emulation(tmp_path, mode, cases):
    r = subprocess.run(
        [sys.executable, TOOL, "--mode", mode, "--rows", "4",
         "--build", str(tmp_path), *cases],
        capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    assert r.stdout.strip().endswith("OK")
