"""Moving-window averages and the averaged derivative (reference
``dspeed/processors/moving_windows.py``; JAX package
``dspeed_tpu/processors/moving_windows.py``).

The reference's running-average recursions telescope into differences of a
prefix sum taken at accumulation precision (:func:`._numerics.hp_cumsum`):
the left window is ``(S[i] - S[i-L]) / L`` with a ramp-in
``w[0] + (S[i] - (i+1) w[0]) / L`` over its first ``L`` samples, and the
right window is the same algebra on suffix sums, without a time reversal.
Each window rounds to the input's type, as the JAX package does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..errors import DSPFatal
from ._helpers import isnan_any, nanmask, static_float
from ._kernel import kernel
from ._numerics import hp_cumsum, shift_right, true_div

__all__ = [
    "moving_window_left",
    "moving_window_right",
    "moving_window_multi",
    "avg_current",
]


def _mwl(w_in, length: float):
    """Left-to-right moving average of ``length`` samples (JAX package
    ``moving_windows.py:32``)."""
    n = w_in.shape[-1]
    li = int(length)
    s = hp_cumsum(w_in)
    w0 = w_in[..., :1].to(s.dtype)
    i = torch.arange(n, device=w_in.device)
    ramp = w0 + true_div(s - (i + 1) * w0, length)
    steady = true_div(s - shift_right(s, li), length)
    return torch.where(i < li, ramp, steady).to(w_in.dtype)


def _shift_left(x, k: int):
    """``x[..., k:]`` padded with zeros at the end."""
    if k <= 0:
        return x
    return F.pad(x[..., k:], (0, k))


def _mwr(w_in, length: float):
    """Right-to-left moving average without the time reversal (JAX package
    ``moving_windows.py:53``): with ``S`` the inclusive prefix sum and
    ``T[i] = S[n-1] - S[i-1]`` the suffix sum, ``(S[i+L-1] - S[i-1]) / L``
    in the steady part and ``w[n-1] + (T[i] - (n-i) w[n-1]) / L`` over the
    last ``L`` samples."""
    n = w_in.shape[-1]
    li = int(length)
    s = hp_cumsum(w_in)
    s_e = shift_right(s, 1)  # S[i-1]
    s_l = _shift_left(s, li - 1) if li > 0 else s  # S[i+L-1]
    steady = s_l - s_e
    t_suffix = s[..., n - 1 : n] - s_e
    w_last = w_in[..., n - 1 : n].to(s.dtype)
    i = torch.arange(n, device=w_in.device)
    ramp = w_last + true_div(t_suffix - (n - i) * w_last, length)
    out = torch.where(i > n - 1 - li, ramp, true_div(steady, length))
    return out.to(w_in.dtype)


def _check_len(length, n, name):
    ln = static_float(length, name, "length")
    if not (0 <= ln < n):
        raise DSPFatal(
            "length is out of range, must be between 0 and the length of the waveform"
        )
    return ln


@kernel("(n),()->(n)", ["ff->f", "dd->d"])
def moving_window_left(w_in, length):
    """Left-to-right moving average (reference ``moving_windows.py:17``)."""
    ln = _check_len(length, w_in.shape[-1], "moving_window_left")
    return nanmask(isnan_any(w_in, 1), _mwl(w_in, ln))


@kernel("(n),()->(n)", ["ff->f", "dd->d"])
def moving_window_right(w_in, length):
    """Right-to-left moving average (reference ``moving_windows.py:69``):
    the left window applied to the time-reversed waveform."""
    ln = _check_len(length, w_in.shape[-1], "moving_window_right")
    return nanmask(isnan_any(w_in, 1), _mwr(w_in, ln))


def mw_cascade(w_in, length: float, num: int, mtype: int):
    """``num`` alternating moving averages of ``length`` samples: ``mtype``
    0 alternates starting left, 1 is only left, 2 only right. No NaN
    masking; the body of :func:`moving_window_multi`."""
    out = w_in
    for it in range(num):
        go_right = ((it % 2 == 1) and (mtype == 0)) or (mtype == 2)
        out = _mwr(out, length) if go_right else _mwl(out, length)
    return out


@kernel("(n),(),(),()->(n)", ["fffi->f", "dddi->d"])
def moving_window_multi(w_in, length, num_mw, mw_type):
    """Alternating left/right moving averages (reference
    ``moving_windows.py:125``). ``mw_type``: 0 alternate starting left, 1
    only left, 2 only right."""
    n = w_in.shape[-1]
    ln = static_float(length, "moving_window_multi", "length")
    if np.floor(ln) != ln:
        raise DSPFatal("The length of the moving window must be an integer")
    num = static_float(num_mw, "moving_window_multi", "num_mw")
    if np.floor(num) != num:
        raise DSPFatal("The number of moving windows must be an integer")
    if not (0 <= int(ln) < n):
        raise DSPFatal("The length of the moving window is out of range")
    if int(num) < 0:
        raise DSPFatal("The number of moving windows much be positive")
    mtype = int(static_float(mw_type, "moving_window_multi", "mw_type"))
    out = mw_cascade(w_in, ln, int(num), mtype)
    return nanmask(isnan_any(w_in, 1), out)


@kernel("(n),(),(m)", ["fff", "ddd"], nout=1, uses_dims=True)
def avg_current(w_in, length, dims):
    """Length-averaged derivative ``(w[i+L] - w[i]) / L`` (reference
    ``moving_windows.py:211``), NaN-padded or cut to the output length
    ``m``."""
    n = w_in.shape[-1]
    m = dims["m"]
    ln = static_float(length, "avg_current", "length")
    if not (0 <= ln < n):
        raise DSPFatal(
            "length is out of range, must be between 0 and the length of the waveform"
        )
    li = int(ln)
    diff = true_div(w_in[..., li:] - w_in[..., : n - li], ln)
    if diff.shape[-1] < m:
        diff = F.pad(diff, (0, m - diff.shape[-1]), value=float("nan"))
    else:
        diff = diff[..., :m]
    return nanmask(isnan_any(w_in, 1), diff)


# generic row-tile fusion (the JAX package's flags)
moving_window_left.tile_safe = True
moving_window_right.tile_safe = True
moving_window_multi.tile_safe = True
avg_current.tile_safe = True
