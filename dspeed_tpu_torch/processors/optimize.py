"""Pole-zero time-constant optimisation (reference
``dspeed/processors/optimize.py:16-241``; JAX package
``dspeed_tpu/processors/optimize.py``).

The reference minimises the post-pole-zero slope objective
``|sum x * sum y - N * sum(x y)|`` over a window with iminuit, event by
event. The JAX package, and this port of it, minimise the same objective
for every event at once with a fixed number of steps: a golden-section
search of 60 steps on ``log tau`` (one pole) and a lock-step Nelder-Mead of
150 iterations on ``(log tau1, log tau2, logit(frac / frac_ub))`` (two
poles). Both run in ``config.accum_dtype`` (float64) whatever the row's
type, and round their results to it.

The two-pole objective's pole, ``y[i] = integ[i] + p y[i-1]`` with ``p = b +
frac (a - b)`` one value a row, runs on the recurrence kernel
(:func:`._cuda.recurrence`) for every (event, simplex vertex) row at once:
one launch for the first simplex, then one an iteration for its three
candidates and one more in an iteration where some event shrinks its
simplex. The one-pole objective is linear in ``1 - exp(-1/tau)``, so its
window sums are taken once and each step evaluates it from them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import accum_dtype
from ..errors import DSPFatal
from ._helpers import any_bad, isnan_any, nanmask, static_int
from ._kernel import kernel
from ._numerics import shift_right

__all__ = ["optimize_1pz", "optimize_2pz"]

_GOLD = (np.sqrt(5.0) - 1.0) / 2.0


def _rows(x, like, dtype):
    """A number or one value per event as a ``like.shape[:-1]`` tensor."""
    v = torch.as_tensor(x).to(like.device, dtype) if isinstance(x, torch.Tensor) \
        else torch.full((), float(x), dtype=dtype, device=like.device)
    return v.expand(like.shape[:-1]) if v.ndim == 0 else v


def _window(n, t_beg_in, t_end_in, name):
    beg = static_int(t_beg_in, name, "t_beg_in")
    end = static_int(t_end_in, name, "t_end_in")
    if not 0 <= beg <= n or not 0 <= end <= n:
        raise DSPFatal("the time range is out of range")
    return beg, end


def nelder_mead(f, x0, iters: int = 150, step: float = 0.15):
    """Batched Nelder-Mead (the JAX package's ``_nelder_mead``): minimise
    ``f`` from ``x0`` (``(B, k)``); ``f`` maps ``(R, v, k)`` points to ``(R,
    v)`` values for any R rows of the batch (``rows``: their indices, or
    None for all). Every event takes the same iterations in lock step
    (reflection, expansion, contraction or shrink chosen by masks); a
    shrink's vertices are evaluated only for the events that shrink, which
    gives the JAX package's values (it evaluates them for all and keeps
    those)."""
    B, k = x0.shape
    eye = torch.eye(k, dtype=x0.dtype, device=x0.device)
    s = torch.cat([x0[:, None, :], x0[:, None, :] + step * eye], dim=1)
    fv = f(s, None)
    for _ in range(iters):
        order = torch.argsort(fv, dim=-1, stable=True)
        s = torch.take_along_dim(s, order[..., None], dim=1)
        fv = torch.take_along_dim(fv, order, dim=1)
        worst = s[:, -1]
        fb, fsw, fw = fv[:, 0], fv[:, -2], fv[:, -1]
        c = s[:, :-1].mean(dim=1)
        cand = torch.stack([c + (c - worst), c + 2.0 * (c - worst),
                            c + 0.5 * (worst - c)], dim=1)
        fr, fe, fc = f(cand, None).unbind(-1)
        xr, xe, xc = cand.unbind(1)
        use_e = (fr < fb) & (fe < fr)
        use_r = ~use_e & (fr < fsw)
        use_c = ~use_e & ~use_r & (fc < fw)
        new_x = torch.where(use_e[:, None], xe, torch.where(
            use_r[:, None], xr, torch.where(use_c[:, None], xc, worst)))
        new_f = torch.where(use_e, fe, torch.where(use_r, fr, torch.where(use_c, fc, fw)))
        s = torch.cat([s[:, :-1], new_x[:, None]], dim=1)
        fv = torch.cat([fv[:, :-1], new_f[:, None]], dim=1)
        shrink = torch.nonzero(~use_e & ~use_r & ~use_c)[:, 0]
        if shrink.numel():
            ss = s[shrink]
            ss = torch.cat([ss[:, :1], ss[:, :1] + 0.5 * (ss[:, 1:] - ss[:, :1])], dim=1)
            s[shrink] = ss
            fv[shrink, 1:] = f(ss[:, 1:], shrink)
    best = torch.argmin(fv, dim=-1)
    return s[torch.arange(B, device=s.device), best]


def _slope_sum(y, beg: int, end: int):
    """``N sum (x - mean x) y`` over ``y[..., beg:end]``, ``x`` the sample
    indices: ``-(sum x * sum y - N * sum(x y))`` without the cancellation of
    its two terms (each ~1e14 on a 4096-sample HPGe row, which leaves their
    difference a noise of ~1 in float64)."""
    xc = torch.arange(beg, end, dtype=y.dtype, device=y.device) - (beg + end - 1) / 2.0
    return (end - beg) * (xc * y[..., beg:end]).sum(-1)


def slope_objective(y, beg: int, end: int):
    """The reference's objective (its ``Model``), ``|sum x * sum y - N *
    sum(x y)|`` over the window, by :func:`_slope_sum`."""
    return torch.abs(_slope_sum(y, beg, end))


def dpz_traced(w, tau1, tau2, frac, end=None):
    """``double_pole_zero`` with one ``(tau1, tau2, frac)`` a row of ``w``
    (``(R, n)``, parameters ``(R,)``), in ``w``'s type, over samples
    ``[0, end)``: the numerator ``w - (a + b) w[i-1] + a b w[i-2]``, its
    prefix sum, then the pole ``y[i] = integ[i] + p y[i-1]``, ``p = b + frac
    (a - b)``, on the recurrence kernel (its plain version on the CPU)."""
    from ._cuda import recurrence

    w = w[..., :end]
    a = torch.exp(-1.0 / tau1)[:, None]
    b = torch.exp(-1.0 / tau2)[:, None]
    u = w - (a + b) * shift_right(w, 1) + a * b * shift_right(w, 2)
    integ = torch.cumsum(u, dim=-1)
    p = b[:, 0] + frac * (a[:, 0] - b[:, 0])
    return recurrence(integ, p)


@kernel("(n),(),(),(),()->()", ["fffff->f", "ddddd->d"])
def optimize_1pz(w_in, a_baseline_in, t_beg_in, t_end_in, p0_in):
    """The single-pole-zero tau minimising the post-pole-zero slope in
    ``[t_beg, t_end)`` (reference ``optimize.py:48``): a golden-section
    search of 60 steps on ``log tau`` in ``[p0 / 30, p0 * 30]``. The pole
    zero of ``y = w - baseline`` is ``y + (1 - exp(-1/tau)) Y[i-1]`` (``Y``
    the prefix sum), so the objective is ``|A + k B|`` in ``k = 1 -
    exp(-1/tau)``, with A and B the window's sums of ``y`` and ``Y[i-1]``
    (:func:`_slope_sum`)."""
    acc = accum_dtype()
    n = w_in.shape[-1]
    beg, end = _window(n, t_beg_in, t_end_in, "optimize_1pz")
    base = _rows(a_baseline_in, w_in, acc)
    p0 = _rows(p0_in, w_in, acc)
    y = w_in.to(acc) - base[..., None]
    prefix = shift_right(torch.cumsum(y, dim=-1), 1)
    A, Bk = _slope_sum(y, beg, end), _slope_sum(prefix, beg, end)

    def obj(ltau):
        return torch.abs(A + -torch.expm1(-1.0 / torch.exp(ltau)) * Bk)

    a, b = torch.log(p0 / 30.0), torch.log(p0 * 30.0)
    for _ in range(60):
        c = b - _GOLD * (b - a)
        d = a + _GOLD * (b - a)
        keep_left = obj(c) < obj(d)
        a, b = torch.where(keep_left, a, c), torch.where(keep_left, d, b)
    tau = torch.exp((a + b) / 2.0)
    bad = any_bad(isnan_any(w_in, 1), isnan_any(base), isnan_any(p0))
    return nanmask(bad, tau.to(w_in.dtype))


@kernel(
    "(n),(),(),(),(),(),(),(),()->(),(),()",
    ["fffffffff->fff", "ddddddddd->ddd"],
)
def optimize_2pz(w_in, a_baseline_in, t_beg_in, t_end_in, tau_upper_bound,
                 frac_upper_bound, p0_in, p1_in, p2_in):
    """The double-pole-zero ``(tau1, tau2, frac)`` minimising the post
    pole-zero slope (reference ``optimize.py:137``, same positional
    arguments, the upper bounds included): Nelder-Mead on ``(log tau1, log
    tau2, logit(frac / frac_ub))``, the taus clamped at ``tau_upper_bound``
    and ``frac`` in ``(0, frac_upper_bound)``."""
    acc = accum_dtype()
    n = w_in.shape[-1]
    beg, end = _window(n, t_beg_in, t_end_in, "optimize_2pz")
    lead = w_in.shape[:-1]
    base = _rows(a_baseline_in, w_in, acc)
    y = (w_in.to(acc) - base[..., None]).reshape(-1, n)
    tau_ub = float(tau_upper_bound)
    frac_ub = float(frac_upper_bound)
    log_tau_ub = float(np.log(tau_ub))
    p0, p1, fr0 = (_rows(v, w_in, acc) for v in (p0_in, p1_in, p2_in))
    r0 = torch.clamp(fr0 / frac_ub, 1e-6, 1.0 - 1e-6)
    params0 = torch.stack([torch.log(p0), torch.log(p1),
                           torch.log(r0 / (1.0 - r0))], dim=-1).reshape(-1, 3)

    def unpack(p):
        return (torch.exp(torch.clamp(p[..., 0], max=log_tau_ub)),
                torch.exp(torch.clamp(p[..., 1], max=log_tau_ub)),
                frac_ub * torch.sigmoid(p[..., 2]))

    def obj(pstack, rows):
        # pstack: (R, v, 3) vertices of the events `rows` -> (R, v)
        R, v, _ = pstack.shape
        yr = y if rows is None else y[rows]
        t1, t2, fr = (q.reshape(-1) for q in unpack(pstack))
        wv = yr[:, None, :].expand(R, v, n).reshape(R * v, n)
        return slope_objective(dpz_traced(wv, t1, t2, fr, end), beg, end).reshape(R, v)

    tau1, tau2, frac = unpack(nelder_mead(obj, params0, iters=150))
    bad = any_bad(isnan_any(w_in, 1), isnan_any(base), isnan_any(p0), isnan_any(p1))
    return tuple(nanmask(bad, v.reshape(lead).to(w_in.dtype)) for v in (tau1, tau2, frac))
