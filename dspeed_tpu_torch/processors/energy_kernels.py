"""CUSP / ZAC / DPLMS energy-filter kernel generators.

Reference: ``dspeed/processors/energy_kernels.py`` (:22 ``cusp_filter``,
:86 ``zac_filter``). Like the reference (numba object mode, run once per
configuration), these execute host-side in numpy when the chain is built and
are const-folded; the resulting FIR kernels feed the device-side convolution
processors. A copy of the JAX package's generators
(``dspeed_tpu/processors/energy_kernels.py:46, :60``); ``dplms`` is queued in
ROADMAP.
"""

from __future__ import annotations

import numpy as np

from ..errors import DSPFatal
from ._helpers import static_float
from ._kernel import kernel

__all__ = ["cusp_filter", "zac_filter"]


def _cusp_checks(sigma, flat, decay):
    if sigma < 0:
        raise DSPFatal("The curvature parameter must be positive")
    if flat < 0:
        raise DSPFatal("The length of the flat section must be positive")
    if np.floor(flat) != flat:
        raise DSPFatal("The length of the flat section must be an integer")
    if decay < 0:
        raise DSPFatal("The decay constant must be positive")


def _cusp_shape(n: int, sigma: float, flat: int) -> np.ndarray:
    """sinh rise, flat top, sinh fall."""
    lt = int((n - flat) / 2)
    fi = int(flat)
    k = np.empty(n, dtype="float64")
    i = np.arange(n)
    denom = np.sinh(lt / sigma)
    k[:lt] = np.sinh(i[:lt] / sigma) / denom
    k[lt : lt + fi + 1] = 1.0
    k[lt + fi + 1 :] = np.sinh((n - i[lt + fi + 1 :]) / sigma) / denom
    return k


@kernel("(),(),(),(n)", ["ffff", "dddd"], nout=1, uses_dims=True)
def cusp_filter(sigma, flat, decay, dims):
    """Sinh-CUSP kernel deconvolved with ``[1, -exp(-1/decay)]``
    (reference ``energy_kernels.py:22``)."""
    sigma = static_float(sigma, "cusp_filter", "sigma")
    flat = static_float(flat, "cusp_filter", "flat")
    decay = static_float(decay, "cusp_filter", "decay")
    _cusp_checks(sigma, flat, decay)
    n = dims["n"]
    cusp = _cusp_shape(n, sigma, flat)
    den = [1.0, -np.exp(-1.0 / decay)]
    return np.convolve(cusp, den, "same")


@kernel("(),(),(),(n)", ["ffff", "dddd"], nout=1, uses_dims=True)
def zac_filter(sigma, flat, decay, dims):
    """Zero-area CUSP: CUSP minus area-matched parabolas, deconvolved
    (reference ``energy_kernels.py:86``)."""
    sigma = static_float(sigma, "zac_filter", "sigma")
    flat = static_float(flat, "zac_filter", "flat")
    decay = static_float(decay, "zac_filter", "decay")
    _cusp_checks(sigma, flat, decay)
    n = dims["n"]
    lt = int((n - flat) / 2)
    fi = int(flat)
    cusp = _cusp_shape(n, sigma, flat)
    par = np.zeros(n, dtype="float64")
    i = np.arange(n)
    par[:lt] = (i[:lt] - lt / 2) ** 2 - (lt / 2) ** 2
    par[lt + fi + 1 :] = ((n - i[lt + fi + 1 :]) - lt / 2) ** 2 - (lt / 2) ** 2
    par = -par / par.sum() * cusp.sum()
    zac = cusp + par
    den = [1.0, -np.exp(-1.0 / decay)]
    return np.convolve(zac, den, "same")
