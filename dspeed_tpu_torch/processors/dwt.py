"""Discrete wavelet transform (reference ``dspeed/processors/dwt.py:23``;
JAX package ``dspeed_tpu/processors/dwt.py``).

The reference wraps :func:`pywt.downcoef` for the Haar (db1) wavelet; as in
the JAX package, the transform is written out: ``level`` pairwise (sum,
difference) / sqrt(2) reductions, the detail coefficients from the last
level's difference (``pywt.downcoef('d', w, wavelet, level)``).
"""

from __future__ import annotations

import math

from ..errors import DSPFatal
from ._helpers import isnan_any, nanmask, static_int
from ._kernel import kernel

__all__ = ["discrete_wavelet_transform"]

_SQRT2 = math.sqrt(2.0)


@kernel("(n),(),(),(),(m)", ["fibbf", "dlbbd"], nout=1, static=[1, 2, 3],
        uses_dims=True)
def discrete_wavelet_transform(w_in, level, wave_type, coeff, dims):
    """Haar (db1) approximation or detail coefficients at ``level``."""
    lvl = static_int(level, "discrete_wavelet_transform", "level")
    wt = static_int(wave_type, "discrete_wavelet_transform", "wave_type")
    cf = static_int(coeff, "discrete_wavelet_transform", "coeff")
    if lvl <= 0:
        raise DSPFatal("The level must be a positive number")
    if chr(wt) not in ("h", "d"):
        raise DSPFatal("Unrecognized wavelet type (use 'h' = haar or 'd' = db1)")
    if chr(cf) not in ("a", "d"):
        raise DSPFatal("Unrecognized coefficient choice (use 'a' or 'd')")
    m = dims["m"]
    w = w_in
    for i in range(lvl):
        half = w.shape[-1] // 2
        pairs = w[..., : 2 * half].reshape(*w.shape[:-1], half, 2)
        if i == lvl - 1 and chr(cf) == "d":
            w = (pairs[..., 0] - pairs[..., 1]) / _SQRT2
        else:
            w = (pairs[..., 0] + pairs[..., 1]) / _SQRT2
    if w.shape[-1] < m:
        raise DSPFatal(f"output length {m} larger than coefficient count {w.shape[-1]}")
    return nanmask(isnan_any(w_in, 1), w[..., :m].to(w_in.dtype))
