"""Pole-zero cancellation (reference ``dspeed/processors/pole_zero.py:29``).

The reference runs the first-order recursion
``y[i] = y[i-1] + x[i] - c*x[i-1]`` in a float64 buffer. It telescopes to

    ``y[i] = x[i] + (1-c) * sum_{j<i} x[j]``

i.e. one prefix sum scaled by ``(1-c) = -expm1(-1/tau)``, as in the JAX
package (``dspeed_tpu/processors/pole_zero.py:48``). Only ``pole_zero`` is
ported so far; the rest of the module is queued in ROADMAP.
"""

from __future__ import annotations

import numpy as np
import torch

from ._helpers import any_bad, cdim, isnan_any, nanmask
from ._kernel import kernel
from ._numerics import hp_cumsum, shift_right

__all__ = ["pole_zero"]


@kernel("(n),()->(n)", ["ff->f", "dd->d"])
def pole_zero(w_in, t_tau):
    """Apply a single pole-zero cancellation with time constant ``t_tau``."""
    dtype = w_in.dtype
    if isinstance(t_tau, torch.Tensor) and t_tau.ndim > 0:
        one_minus_c = -torch.expm1(-1.0 / t_tau)
        bad_tau = isnan_any(t_tau)
    else:
        tau = float(t_tau)
        one_minus_c = -np.expm1(-1.0 / tau) if tau != 0 else 1.0
        bad_tau = np.isnan(tau)
    prefix = shift_right(hp_cumsum(w_in), 1)
    out = (w_in + (cdim(one_minus_c) * prefix).to(dtype)).to(dtype)
    return nanmask(any_bad(isnan_any(w_in, 1), bad_tau), out)


# generic row-tile fusion (the JAX package's flags)
pole_zero.tile_safe = True
