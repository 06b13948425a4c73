"""Fixed-time pick-off with interpolation modes
(reference ``dspeed/processors/fixed_time_pickoff.py:20``)."""

from __future__ import annotations

import numpy as np
import torch

from ..errors import DSPFatal
from ._helpers import isnan_any, nanmask, static_int, take_per_row
from ._kernel import kernel
from ._spline import natural_spline_w2

__all__ = ["fixed_time_pickoff"]

_MODES = tuple(ord(c) for c in "infclhs")


@kernel("(n),(),()->()", ["ffb->f", "ddb->d"], static=[2], badrow_arg=0)
def fixed_time_pickoff(w_in, t_in, mode_in, badrow=None):
    """Pick off the waveform value at (fractional) index ``t_in``.

    Interpolation modes (static char, passed as ``ord(c)``): ``i`` integer,
    ``n`` nearest, ``f`` floor, ``c`` ceil, ``l`` linear, ``h`` Hermite,
    ``s`` natural cubic spline (:func:`._spline.natural_spline_w2`).
    Out-of-range or NaN index gives NaN; mode ``'i'`` with a non-integral
    index gives NaN (as in the JAX package).
    """
    mode = static_int(mode_in, "fixed_time_pickoff", "mode_in")
    if mode not in _MODES:
        raise DSPFatal("Unrecognized interpolation mode")
    ch = chr(mode)
    n = w_in.shape[-1]
    dtype = w_in.dtype
    static_t = isinstance(t_in, (int, float, np.integer, np.floating))
    if static_t:
        t = torch.full(w_in.shape[:-1], float(t_in), dtype=dtype,
                       device=w_in.device)
    else:
        t = t_in.to(dtype).expand(w_in.shape[:-1])

    i0 = torch.floor(t).to(torch.int64)
    frac = t - i0
    exact = frac == 0
    t0 = frac
    t1 = 1.0 - t0

    def pick(w, offs):
        if static_t and np.isfinite(t_in):
            # floor after casting to the dtype the tensor path floors
            j0 = int(np.floor(np.dtype(str(dtype).split(".")[-1]).type(t_in)))
            return tuple(w[..., min(max(j0 + o, 0), n - 1)] for o in offs)
        p = take_per_row(w, torch.stack([i0 + o for o in offs], dim=-1))
        return tuple(p[..., k] for k in range(len(offs)))

    bad_mode = None
    if ch == "h":
        w_im1, w_i, w_i1, w_i2 = pick(w_in, (-1, 0, 1, 2))
    else:
        w_i, w_i1 = pick(w_in, (0, 1))
    if ch == "i":
        val = w_i
        bad_mode = ~exact
    elif ch == "n":
        val = torch.where(t0 < 0.5, w_i, w_i1)
    elif ch == "f":
        val = w_i
    elif ch == "c":
        val = torch.where(exact, w_i, w_i1)
    elif ch == "l":
        val = torch.where(exact, w_i, t1 * w_i + t0 * w_i1)
    elif ch == "s":
        p2a, p2b = pick(natural_spline_w2(w_in), (0, 1))
        s = (
            t1 * w_i
            + t0 * w_i1
            + ((t1**3 - t1) * p2a + (t0**3 - t0) * p2b) / 6.0
        )
        val = torch.where(exact, w_i, s)
    else:  # 'h'
        m0 = torch.where(i0 == 0, w_in[..., 1] - w_in[..., 0], (w_i1 - w_im1) / 2.0)
        m1 = torch.where(
            i0 == n - 2, w_in[..., -1] - w_in[..., -2], (w_i2 - w_i) / 2.0
        )
        herm = (
            (-2.0 * t1**3 + 3.0 * t1**2) * w_i
            + (-2.0 * t0**3 + 3.0 * t0**2) * w_i1
            - (t1**3 - t1**2) * m0
            + (t0**3 - t0**2) * m1
        )
        val = torch.where(exact, w_i, herm)

    in_range = (t >= 0) & (t <= n - 1)
    row = isnan_any(w_in, 1) if badrow is None else badrow
    bad = row | torch.isnan(t) | ~in_range
    if bad_mode is not None:
        bad = bad | bad_mode
    return nanmask(bad, val.to(dtype))


def _ftp_checker(w_in, t_in, mode_in):
    """Checked-mode flag (the JAX package's ``_ftp_checker``, :122): the
    reference raises only in mode ``'i'`` on a non-integral in-range index
    (``fixed_time_pickoff.py:70-85``); a NaN or out-of-range ``t_in`` and a
    row holding a NaN give NaN silently there too."""
    n = w_in.shape[-1]
    mode = static_int(mode_in, "fixed_time_pickoff", "mode_in")
    # a constant (numpy's own type: a python float is float64) is judged on
    # the host: moving it to the card would wait for the card's queue
    t = t_in if isinstance(t_in, torch.Tensor) else torch.from_numpy(np.asarray(t_in))
    lead = torch.broadcast_shapes(t.shape, w_in.shape[:-1])
    zeros = torch.zeros(lead, dtype=torch.int32, device=w_in.device)
    if chr(mode) != "i" or not t.is_floating_point():
        return zeros
    bad_t = ~(torch.isnan(t) | (t < 0) | (t > n - 1)) & (torch.trunc(t) != t)
    if t.device != w_in.device:
        if not bad_t.any():
            return zeros
        bad_t = bad_t.to(w_in.device)
    return (~isnan_any(w_in, 1) & bad_t).to(torch.int32).expand(lead)


fixed_time_pickoff.checker = _ftp_checker
fixed_time_pickoff.check_messages = {
    1: "fixed_time_pickoff requires integer t_in when using mode 'i'",
}


def _ftp_tile_safe(step):
    """Generic row-tile fusion (the JAX package's predicate,
    ``dspeed_tpu/processors/fixed_time_pickoff.py:149``): mode ``s`` runs a
    spline solver and stays out of groups; every other mode is a per-row
    pick."""
    m = step.params[2] if len(step.params) > 2 else None
    if isinstance(m, str):
        return m.strip("'\"") != "s"
    return isinstance(m, (int, np.integer)) and int(m) != ord("s")


fixed_time_pickoff.tile_safe = _ftp_tile_safe
