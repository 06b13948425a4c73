"""CUSP / ZAC / DPLMS energy-filter kernel generators.

Reference: ``dspeed/processors/energy_kernels.py`` (:22 ``cusp_filter``,
:86 ``zac_filter``, :170 ``dplms``). Like the reference (numba object mode,
run once per configuration), these execute host-side in float64 numpy when
the chain is built and are const-folded; the resulting FIR kernels feed the
device-side convolution processors. A copy of the JAX package's generators
(``dspeed_tpu/processors/energy_kernels.py:46, :60, :82``), which gives
their filters bit for bit.
"""

from __future__ import annotations

import numpy as np

from ..errors import DSPFatal
from ._helpers import static_float
from ._kernel import kernel

__all__ = ["cusp_filter", "zac_filter", "dplms", "dplms_filter"]


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


@kernel("(n,n),(m),(),(),(),()->(n)", ["ffffff->f", "dddddd->d"], uses_dims=True)
def dplms(noise_mat, reference, a1, a2, a3, ff, dims):
    """Optimum DPLMS filter: the solution of the penalised normal equations
    ``(a1 * noise + a2 * ref + a3 * ones) k = ref_sig``, reversed and scaled
    so that its response to the reference peaks at 1 (reference
    ``energy_kernels.py:170``; method of V. D'Andrea et al., Eur. Phys. J. C
    83, 149 (2023))."""
    noise_mat = np.asarray(noise_mat, dtype="float64")
    reference = np.asarray(reference, dtype="float64")
    a1 = static_float(a1, "dplms", "a1")
    a2 = static_float(a2, "dplms", "a2")
    a3 = static_float(a3, "dplms", "a3")
    ff = static_float(ff, "dplms", "ff")
    length = dims["n"]

    if length != noise_mat.shape[-1]:
        raise DSPFatal(
            "The length of the filter is not consistent with the noise matrix"
        )
    if len(reference) <= 0:
        raise DSPFatal("The length of the reference signal must be positive")
    # Divergence (the JAX package's): the reference demands a1, a2, a3, ff > 0
    # yet its own body (and its sipm-dplms test config) use a3 = 0 / ff = 0;
    # the mathematically valid >= 0 superset is accepted here.
    for name, val in (("noise", a1), ("reference", a2)):
        if val <= 0:
            raise DSPFatal(f"The penalized coefficient for the {name} must be positive")
    if a3 < 0 or ff < 0:
        raise DSPFatal("The penalized coefficients must not be negative")

    ssize = len(reference)
    flo = int(ssize / 2 - length / 2)
    fhi = int(ssize / 2 + length / 2)
    if ff == 1:
        shifts = [-1, 0, 1]
    elif ff == 0:
        shifts = [0]
    else:
        raise DSPFatal("The penalized coefficient for the ref matrix must be 0 or 1")

    ref_mat = np.zeros((length, length))
    ref_sig = np.zeros(length)
    for s in shifts:
        seg = reference[flo + s : fhi + s]
        ref_mat += np.outer(seg, seg)
        ref_sig += seg
    ref_mat /= len(shifts)

    mat = a1 * noise_mat + a2 * ref_mat + a3 * np.ones((length, length))
    k = np.flip(np.linalg.solve(mat, ref_sig))
    y = np.convolve(reference, k, mode="valid")
    return k / np.amax(y)


# the reference's sipm-dplms test config names the processor "dplms_filter"
# (a name its own registry never defined)
dplms_filter = dplms
