"""Natural cubic spline second derivatives (JAX package
``dspeed_tpu/processors/_spline.py``).

The reference solves the natural spline's tridiagonal system with a
sequential sweep inside its numba kernels (``fixed_time_pickoff.py:104-117``,
``upsampler.py:176-199``). For unit sample spacing the sweep's pivots do not
depend on the data, so they are computed on the host in float64; the
forward and backward substitutions are first-order recurrences with one
multiplier a position, which the JAX package runs as ``associative_scan`` calls
(:27) and the port runs on the recurrence kernel (forward, then reverse).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

__all__ = ["natural_spline_w2", "affine_recurrence"]


def affine_recurrence(mult, add, reverse: bool = False):
    """Solve ``y[i] = mult[i] * y[i-1] + add[i]`` with ``y[-1] = 0`` along
    the last axis of ``add`` (``mult`` one value a position); with
    ``reverse`` from the end, ``y[i] = mult[i] * y[i+1] + add[i]``. In
    float64, written in ``add``'s type."""
    from ._cuda import recurrence

    *lead, n = add.shape
    u = add.reshape(-1, n)
    if u.stride(-1) != 1:
        u = u.contiguous()
    m = mult.to(add.device, torch.float64).expand(n)
    return recurrence(u, m, reverse=reverse, per_position=True).reshape(*lead, n)


@lru_cache(maxsize=16)
def _pivots(n: int):
    """The sweep's data-independent coefficients: ``(c, a_fwd, b_fwd)`` in
    float64, ``c[i] = -0.5 / p[i]`` with ``p[i] = 0.5*c[i-1] + 2``."""
    c = np.zeros(n, dtype=np.float64)
    p = np.full(n, np.inf, dtype=np.float64)
    for i in range(1, n - 1):
        p[i] = 0.5 * c[i - 1] + 2.0
        c[i] = -0.5 / p[i]
    fin = np.isfinite(p)
    return c, np.where(fin, -0.5 / p, 0.0), np.where(fin, 3.0 / p, 0.0)


def natural_spline_w2(w, dtype=None):
    """Second derivatives of the natural cubic spline through ``w`` (unit dx).

    Follows the reference recursion:
      p[i] = 0.5*c[i-1] + 2 ;  c[i] = -0.5/p[i]        (host, data-independent)
      u[i] = (3*(w[i+1]-2w[i]+w[i-1]) - 0.5*u[i-1]) / p[i]
      w2[n-1] = 0 ;  w2[i] = c[i]*w2[i+1] + u[i]
    with w2[0] = u[0] = 0 (natural boundary). The coefficients are rounded
    to ``dtype`` (default ``w``'s), as the JAX package rounds them.
    """
    n = w.shape[-1]
    dtype = w.dtype if dtype is None else dtype
    w = w.to(dtype)
    c, a_fwd, b_fwd = _pivots(n)

    def coef(v):
        return torch.from_numpy(v).to(w.device, dtype)

    d2 = torch.zeros_like(w)
    if n > 2:
        d2[..., 1:-1] = w[..., 2:] - 2.0 * w[..., 1:-1] + w[..., :-2]
    u = affine_recurrence(coef(a_fwd), coef(b_fwd) * d2)
    w2 = affine_recurrence(coef(c), u, reverse=True)
    w2[..., 0] = 0.0
    w2[..., n - 1] = 0.0
    return w2
