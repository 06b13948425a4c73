"""RC-CR² shaper (reference ``dspeed/processors/rc_cr2.py:17``).

Matched z-transform: numerator ``(1 - z⁻¹)²``, denominator ``(1 - a z⁻¹)³``
with ``a = exp(-1/tau)``; the reference runs the third-order recursion from
``i = 3`` with ``w_out[0:3] = w_in[0:3]`` as history. As in the JAX package
(``dspeed_tpu/processors/rc_cr2.py:59``), the triple pole is factored into
a cascade of three first-order stages

    s1ᵢ = a·s1ᵢ₋₁ + uᵢ,   s2ᵢ = a·s2ᵢ₋₁ + s1ᵢ,   yᵢ = a·yᵢ₋₁ + s2ᵢ

with ``s1₂ = y₂ - 2a·y₁ + a²·y₀``, ``s2₂ = y₂ - a·y₁``, ``y₂ = w₂``. Each
stage is one launch of the recurrence kernel in float64, with ``a`` a
constant (a static tau) or one value a row (a per-event tau).
"""

from __future__ import annotations

import numpy as np
import torch

from ..errors import DSPFatal
from ._helpers import any_bad, isnan_any, nanmask
from ._kernel import kernel
from ._numerics import iir_first_order

__all__ = ["rc_cr2"]


def _one_pole_rows(u, a, y0):
    """``y[i] = a*y[i-1] + u[i]`` with ``y[-1] = y0``, ``a`` one value a row."""
    from ._cuda import recurrence

    *lead, n = u.shape
    return recurrence(u.reshape(-1, n).contiguous(), a.expand(*lead).reshape(-1),
                      y0.expand(*lead).reshape(-1)).reshape(*lead, n)


@kernel("(n),()->(n)", ["ff->f", "dd->d"])
def rc_cr2(w_in, t_tau):
    n = w_in.shape[-1]
    if n <= 3:
        raise DSPFatal(
            "The length of the waveform must be larger than 3 for the filter "
            "to work safely"
        )
    acc = torch.float64
    w = w_in.to(acc)
    if not isinstance(t_tau, torch.Tensor) or t_tau.ndim == 0:
        # IEEE semantics for tau == 0 (-1/0 -> -inf -> a = 0), as the
        # reference's numpy arithmetic
        with np.errstate(divide="ignore"):
            a = float(np.exp(np.divide(-1.0, float(t_tau))))
        bad_tau = bool(np.isnan(a))

        def one_pole(u, y0):
            return iir_first_order(u, a, y_init=y0)

    else:
        tau = t_tau.to(w.device, acc)
        a = torch.exp(-1.0 / tau)
        bad_tau = isnan_any(tau)

        def one_pole(u, y0):
            return _one_pole_rows(u, a, y0)

    # u[i] = w[i] - 2 w[i-1] + w[i-2] for i in [3, n)
    u = w[..., 3:] - 2.0 * w[..., 2:-1] + w[..., 1:-2]
    y0, y1, y2 = w[..., 0], w[..., 1], w[..., 2]
    s1 = one_pole(u, y2 - 2.0 * a * y1 + a * a * y0)
    s2 = one_pole(s1, y2 - a * y1)
    y = one_pole(s2, y2)
    if not isinstance(a, torch.Tensor):
        # an infinite y0 makes the first stage's seed infinite, and the
        # stages would carry ±inf to the end; with a static tau the JAX
        # package gives NaN from sample 3 on there, which rc_cr2.checker
        # flags (with a per-event tau its scan carries ±inf, as this does)
        y = torch.where(torch.isinf(y0)[..., None], torch.full(
            (), float("nan"), dtype=acc, device=w.device), y)
    out = torch.cat([w[..., :3], y], dim=-1).to(w_in.dtype)
    return nanmask(any_bad(isnan_any(w_in, 1), bad_tau), out)


def _rc_cr2_checker(w_in, t_tau):
    """Checked-mode flag for the reference's output-NaN fatal
    (``rc_cr2.py:93-94``): NaN inputs give NaN outputs first (``:47-48``),
    so the flag is set only where finite inputs overflow the recursion into
    NaN."""
    skip = any_bad(isnan_any(w_in, 1), isnan_any(t_tau))
    code = isnan_any(rc_cr2.fn(w_in, t_tau), 1)
    code = code & ~skip if isinstance(skip, torch.Tensor) else code & (not skip)
    return code.to(torch.int32).expand(
        torch.broadcast_shapes(code.shape, w_in.shape[:-1]))


rc_cr2.checker = _rc_cr2_checker
rc_cr2.check_messages = {1: "RC-CR^2 filter produced nans in output."}
