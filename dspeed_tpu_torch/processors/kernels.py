"""FIR kernel generators (reference ``dspeed/processors/kernels.py``).

These are one-shot generators (the reference runs them in numba object mode
once per config): they always receive constant arguments, execute on the
host in numpy, and their outputs are const-folded into the chain. A copy of
the JAX package's generators (``dspeed_tpu/processors/kernels.py:20, :42,
:53``).
"""

from __future__ import annotations

import numpy as np

from ..errors import DSPFatal
from ._helpers import static_float
from ._kernel import kernel

__all__ = ["t0_filter", "moving_slope", "step"]


@kernel("(),(),(n)", ["fff", "ddd"], nout=1, uses_dims=True)
def t0_filter(rise, fall, dims):
    """Asymmetric t0 kernel: weighted-average rise, uniform negative fall
    (reference ``kernels.py:19``)."""
    rise = static_float(rise, "t0_filter", "rise")
    fall = static_float(fall, "t0_filter", "fall")
    n = dims["n"]
    if rise < 0:
        raise DSPFatal("The length of the rise section must be positive")
    if fall < 0:
        raise DSPFatal("The length of the fall section must be positive")
    if n != int(rise + fall):
        raise DSPFatal("The length of the output kernel must equal rise+fall")
    k = np.empty(n, dtype="float64")
    ir = int(rise)
    i = np.arange(ir)
    k[:ir] = 2 * (ir - i) / (rise * (rise + 1))
    k[ir:] = -1.0 / fall
    return k


@kernel("(n)", ["f", "d"], nout=1, uses_dims=True)
def moving_slope(dims):
    """Linear-slope FIR kernel over ``n`` samples (reference ``kernels.py:71``)."""
    n = dims["n"]
    sum_x = n * (n + 1) / 2
    sum_x2 = n * (n + 1) * (2 * n + 1) / 6
    k = (np.arange(1, n + 1, dtype="float64") * n) - sum_x
    k /= n * sum_x2 - sum_x * sum_x
    return k[::-1].copy()


@kernel("(),(n)", ["ff", "dd"], nout=1, uses_dims=True)
def step(weight_pos, dims):
    """Step kernel: -1 on the outer quarters, +1 in the middle half
    (reference ``kernels.py:110``)."""
    n = dims["n"]
    x = np.arange(n)
    k = np.where((x >= n / 4) & (x < 3 * n / 4), 1.0, -1.0)
    return k
