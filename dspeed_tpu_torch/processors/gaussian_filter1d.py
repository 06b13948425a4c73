"""Gaussian kernel generator (reference
``dspeed/processors/gaussian_filter1d.py:56``; JAX package
``dspeed_tpu/processors/gaussian_filter1d.py:22``).

Like the reference, it runs once per configuration on the host in numpy and
is const-folded when the chain is built: the truncated, normalised Gaussian
taps in float64. Convolve with
:func:`~dspeed_tpu_torch.processors.convolutions.reflected_convolve_wf` for
scipy's ``mode="reflect"`` smoothing.
"""

from __future__ import annotations

import numpy as np

from ..errors import DSPFatal
from ._helpers import static_float
from ._kernel import kernel

__all__ = ["gaussian_filter1d"]


@kernel("(),(),(n)", ["fff", "ddd"], nout=1, uses_dims=True)
def gaussian_filter1d(sigma, truncate, dims):
    """Fill a length-``n`` buffer with normalised truncated-Gaussian taps;
    ``n`` must be ``2*int(truncate*sigma + 0.5) + 1``."""
    sd = static_float(sigma, "gaussian_filter1d", "sigma")
    trunc = static_float(truncate, "gaussian_filter1d", "truncate")
    if sd <= 0:
        raise DSPFatal("sigma must be positive")
    lw = int(trunc * sd + 0.5)
    n = dims["n"]
    if n != 2 * lw + 1:
        raise DSPFatal(
            f"weights buffer must have length 2*int(truncate*sigma+0.5)+1 = "
            f"{2 * lw + 1}"
        )
    x = np.arange(-lw, lw + 1)
    phi = np.exp(-0.5 / (sd * sd) * x**2)
    return phi / phi.sum()
