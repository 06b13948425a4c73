"""Generic IIR filter (reference ``dspeed/processors/recursive_filter.py:21``).

The numerator (feedforward) is a PyTorch convolution with ``init_in``
left-padding, as in the JAX package (``dspeed_tpu/processors/
recursive_filter.py:76``). The denominator recursion
``y[i] = u[i] - c·y[i-1..i-d]``, which the JAX package runs as an
``associative_scan`` of companion matrices (:41), runs on the recurrence
kernel's order-d mode (:func:`._cuda.recurrence`), one thread per row in
float64.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..errors import DSPFatal
from ._helpers import any_bad, as_tensor, isnan_any, nanmask
from ._kernel import kernel

__all__ = ["recursive_filter", "iir_companion"]


def iir_companion(u, c, init_state):
    """Solve ``y[i] = u[i] - sum_j c[j] * y[i-1-j]`` along the last axis.

    ``c`` has shape ``(..., d)``; ``init_state`` is ``[y[-1], ..., y[-d]]``
    shaped ``(..., d)``. Runs in float64 and returns ``u``'s type.
    """
    from ._cuda import recurrence

    *lead, n = u.shape
    c = as_tensor(c, u, torch.float64)
    d = c.shape[-1]
    if d == 0:
        return u
    u2 = u.reshape(-1, n)
    if u2.stride(-1) != 1:
        u2 = u2.contiguous()
    c2 = c if c.ndim == 1 else c.expand(*lead, d).reshape(-1, d)
    s0 = as_tensor(init_state, u, torch.float64).expand(*lead, d).reshape(-1, d)
    return recurrence(u2, c=c2, y0=s0).reshape(*lead, n)


def _coef(x, like: torch.Tensor) -> torch.Tensor:
    """A coefficient array or initial value in float64 on ``like``'s device."""
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x, np.float64)
    return as_tensor(x, like, torch.float64)


def recursive_filter_impl(w_in, a, b, init_in, init_out):
    """Batched recursive-filter body shared with the iir_filter factories."""
    n = w_in.shape[-1]
    a_host = a
    a, b = _coef(a, w_in), _coef(b, w_in)
    p = a.shape[-1] if a.ndim else 1
    q = b.shape[-1] if b.ndim else 0
    if q == 0:
        raise DSPFatal("b cannot be scalar")
    if n <= q:
        raise DSPFatal(
            f"The length of the waveform must be larger than {q} for the "
            f"filter to work safely"
        )
    w = w_in.to(torch.float64)
    lead = w.shape[:-1]
    init_in_v, init_out_v = _coef(init_in, w_in), _coef(init_out, w_in)

    # feedforward: u[i] = sum_j a[j] * (w[i-j], init_in for i-j < 0)
    if p == 1:
        u = a[..., :1] * w if a.ndim else a * w
    else:
        pad = init_in_v.expand(lead)[..., None].expand(*lead, p - 1)
        wp = torch.cat([pad, w], dim=-1)
        if a.ndim == 1:
            # conv1d is a correlation: reverse the taps to convolve
            u = F.conv1d(wp.reshape(-1, 1, wp.shape[-1]),
                         a.flip(0).reshape(1, 1, p)).reshape(*lead, n)
        else:
            # per-event taps: a sliding dot over each row's window
            u = (wp.unfold(-1, p, 1) * a.flip(-1)[..., None, :]).sum(-1)

    b0 = b[..., 0]
    c = b[..., 1:] / b0[..., None]
    u = u / (b0[..., None] if b0.ndim else b0)
    d = q - 1
    if d == 0:
        y = u
    else:
        s0 = init_out_v.expand(lead)[..., None].expand(*lead, d)
        y = iir_companion(u, c, s0)
    out = y.to(w_in.dtype)
    nan_taps = isinstance(a_host, np.ndarray) and bool(np.isnan(a_host).any())
    bad = any_bad(isnan_any(w_in, 1), nan_taps, isnan_any(init_in_v),
                  isnan_any(init_out_v))
    return nanmask(bad, out)


@kernel("(n),(p),(q),(),()->(n)", ["fddff->f", "ddddd->d"])
def recursive_filter(w_in, a, b, init_in, init_out):
    """Apply a recursive (IIR) filter with feedforward ``a`` and feedback
    ``b`` polynomial coefficients, padding the start with ``init_in`` /
    ``init_out`` (reference ``recursive_filter.py:21``)."""
    return recursive_filter_impl(w_in, a, b, init_in, init_out)
