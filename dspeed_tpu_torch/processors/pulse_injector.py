"""Pulse injection for pile-up and robustness studies (reference
``dspeed/processors/pulse_injector.py:21,74`` and
``pmt_pulse_injector.py:19,68``; JAX package
``dspeed_tpu/processors/pulse_injector.py``).

Closed-form elementwise adds, in the row's type, each operation rounded
once in the JAX package's order. Parameters are numbers or one value per
event. A NaN in the row or in any parameter gives a NaN row. All four are
tile safe: inside a generic group they run as K7's ``inject`` op, which
computes each sample with the same operations (``csrc/generic_rows.cu``).
"""

from __future__ import annotations

import numpy as np
import torch

from ._helpers import any_bad, isnan_any, nanmask
from ._kernel import kernel

__all__ = [
    "inject_sig_pulse",
    "inject_exp_pulse",
    "inject_gumbel",
    "inject_general_logistic",
]

_LOG99x4 = 4.0 * np.log(99.0)


def _bparam(x, w):
    """A parameter in ``w``'s type on its device: a ``(..., 1)`` column for
    one value per event, else a 0-d tensor (filled in on the device)."""
    if isinstance(x, torch.Tensor):
        v = x.to(w.device, w.dtype)
        return v[..., None] if v.ndim else v
    return torch.full((), float(x), dtype=torch.float64, device=w.device).to(w.dtype)


def _const(v, w):
    """A number in ``w``'s type, as a 0-d tensor on its device: divisions
    by it are true divisions on the card too."""
    return torch.full((), v, dtype=torch.float64, device=w.device).to(w.dtype)


def _bad(w_in, *params):
    return any_bad(isnan_any(w_in, 1), *(
        isnan_any(p) if isinstance(p, torch.Tensor) else isnan_any(float(p))
        for p in params))


@kernel("(n),(),(),(),()->(n)", ["fffff->f", "ddddd->d"])
def inject_sig_pulse(wf_in, t0, rt, a, decay):
    """Add ``a / (1 + exp(-4 ln99 (t - t0 - rt/2) / rt)) * exp(-(t - t0) /
    decay)`` (reference ``pulse_injector.py:21``)."""
    n = wf_in.shape[-1]
    t = torch.arange(n, dtype=wf_in.dtype, device=wf_in.device)
    t0b, rtb, ab, db = (_bparam(x, wf_in) for x in (t0, rt, a, decay))
    rise = _const(_LOG99x4, wf_in) / rtb
    pulse = ab / (1.0 + torch.exp(-rise * (t - (t0b + rtb / 2.0)))) * torch.exp(
        -(t - t0b) / db)
    return nanmask(_bad(wf_in, t0, rt, a, decay), (wf_in + pulse).to(wf_in.dtype))


@kernel("(n),(),(),(),()->(n)", ["fffff->f", "ddddd->d"])
def inject_exp_pulse(wf_in, t0, rt, a, decay):
    """Add an exponentially rising, then decaying pulse (reference
    ``pulse_injector.py:74``). The rising part stands where ``t <= t0`` and
    ``t <= t0 + rt``, that is ``t <= t0``, as in the JAX package; the decay
    where ``t > t0 + rt``; zero between."""
    n = wf_in.shape[-1]
    t = torch.arange(n, dtype=wf_in.dtype, device=wf_in.device)
    t0b, rtb, ab, db = (_bparam(x, wf_in) for x in (t0, rt, a, decay))
    tail = torch.exp(-(t - t0b) / db)
    during = ab * torch.exp((t - t0b - rtb) / rtb) * tail
    after = ab * tail
    end = t0b + rtb
    pulse = torch.where((t <= t0b) & (t <= end), during,
                        torch.where(t > end, after, torch.zeros((), dtype=t.dtype,
                                                                device=t.device)))
    return nanmask(_bad(wf_in, t0, rt, a, decay), (wf_in + pulse).to(wf_in.dtype))


@kernel("(n),(),(),()->(n)", ["ffff->f", "dddd->d"])
def inject_gumbel(wf_in, a, t0, beta):
    """Add a Gumbel-distribution PMT pulse over ``[t0, mu + 8 beta)`` with
    ``mu = t0 + 2 beta`` (reference ``pmt_pulse_injector.py:19``)."""
    n = wf_in.shape[-1]
    t = torch.arange(n, dtype=wf_in.dtype, device=wf_in.device)
    ab, t0b, bb = (_bparam(x, wf_in) for x in (a, t0, beta))
    mu = t0b + 2.0 * bb
    z = (t - mu) / bb
    pulse = (ab / bb) * torch.exp(-(z + torch.exp(-z)))
    window = (t >= t0b) & (t < mu + 8.0 * bb)
    pulse = torch.where(window, pulse, torch.zeros((), dtype=t.dtype, device=t.device))
    return nanmask(_bad(wf_in, a, t0, beta), (wf_in + pulse).to(wf_in.dtype))


@kernel("(n),(),(),(),(),(),()->(n)", ["fffffff->f", "ddddddd->d"])
def inject_general_logistic(wf_in, a, t0, rt, q, v, decay):
    """Add a generalized-logistic pulse, ``a / (1 + q exp(-4 ln99 (t - t0 -
    rt/2) / rt))^(1/v) * exp(-(t - t0) / decay)`` (reference
    ``pmt_pulse_injector.py:68``; arguments in its order: a, t0, rt, q, v,
    decay)."""
    n = wf_in.shape[-1]
    t = torch.arange(n, dtype=wf_in.dtype, device=wf_in.device)
    t0b, rtb, ab, db, qb, vb = (_bparam(x, wf_in) for x in (t0, rt, a, decay, q, v))
    rise = _const(_LOG99x4, wf_in) / rtb
    base = 1.0 + qb * torch.exp(-rise * (t - t0b - rtb / 2.0))
    pulse = ab / torch.pow(base, torch.reciprocal(vb)) * torch.exp(-(t - t0b) / db)
    return nanmask(_bad(wf_in, a, t0, rt, q, v, decay),
                   (wf_in + pulse).to(wf_in.dtype))


# generic row-tile fusion (the JAX package's flags, so that both packages
# form the same groups)
inject_sig_pulse.tile_safe = True
inject_exp_pulse.tile_safe = True
inject_gumbel.tile_safe = True
inject_general_logistic.tile_safe = True
