"""The polyphase plan of the A/E current front (kernel K5), a copy of the
JAX package's host code ``_poly_plan`` (``dspeed_tpu/processors/
_pallas.py:705``), whose module imports JAX.

Away from the edges the cascade of ``num`` moving averages of ``L`` samples
is linear and shift-invariant: ``out = h * x_up`` with ``h`` the convolution
of the boxes. Since ``x_up[j] = c[(j + half) // ratio]`` is a replication,
``out[ratio*t + p] = sum_q H_p[q] c[t + q]`` with short per-phase filters
``H_p`` on the current itself. Only two ``W``-sample windows at the true
edges run the staged cascade, whose ramps are not shift-invariant. The
margin analysis below proves which output range each method owns, and
returns None where the margins do not hold: there the up-domain route (K6)
runs the cascade at full width.
"""

from __future__ import annotations

import numpy as np

__all__ = ["W", "T", "poly_plan"]

W = 256  # edge-window width, up-domain samples (the JAX package's _POLY_W)
T = 32  # interior block width, current samples (_POLY_T)


def poly_plan(n_curr, ratio, half, n_up, L, num, mtype):
    """The plan of the polyphase route, or None.

    Returns ``dict(Hm, EL, ERW, nq, q_min, t0_base, nblk, T_last)``:
    ``Hm`` (``ratio x nq``, float64) holds the per-phase filters, so that
    ``y[ratio*t + p] = sum_k Hm[p, k] c[t + q_min + k]`` for ``j = ratio*t
    + p`` in ``[EL, n_up - ERW)``; the left window's cascade owns ``[0,
    EL)`` and the right window's ``[n_up - ERW, n_up)``. ``t0_base = EL //
    ratio``, and the interior is ``nblk`` blocks of ``T`` current samples,
    the last ``T_last`` long. The JAX package's plan holds the same entries,
    with ``Hm`` laid out as its TPU band matrices ``A``/``A_last`` and the
    edge windows as one-hot matrices ``RL``/``RR``; their range checks are
    kept here.
    """
    if n_up < W or L >= W // 2 or half + n_up > n_curr * ratio:
        return None
    stages = [
        ((it % 2 == 1) and (mtype == 0)) or (mtype == 2)
        for it in range(num)
    ]
    # composite interior filter: out[j] = sum_s h[s] x_up[j - s]
    h = np.ones(1)
    s_min = 0
    for right in stages:
        h = np.convolve(h, np.full(L, 1.0 / L))
        if right:
            s_min -= L - 1
    s_max = s_min + len(h) - 1

    # LEFT edge window [0, W): a mwr stage's right ramp is globally wrong
    # here; track the lowest corrupted local index (mwl introduces nothing:
    # its left ramp IS the global edge)
    c_lo = W
    for right in stages:
        if right:
            c_lo = min(c_lo - (L - 1), W - L)
    EL = ratio * -(-max(s_max, 1) // ratio)  # interior start (mult of ratio)
    need_hi = EL  # dependency cone of outputs [0, EL)
    for right in reversed(stages):
        if right:
            need_hi += L - 1
    if not (0 < EL <= c_lo and need_hi <= W):
        return None

    # RIGHT edge window [n_up - W, n_up): mwl's left ramp is globally wrong
    # here; track the exclusive upper bound of corruption from the left
    c_hi = 0
    for right in stages:
        if not right:
            c_hi = max(c_hi + (L - 1) if c_hi else 0, L)
    j_end = ratio * ((n_up + s_min) // ratio)  # interior validity bound
    ERW = n_up - j_end
    need_lo = W - ERW
    for right in reversed(stages):
        if not right:
            need_lo -= L - 1
    if not (W - ERW >= c_hi and need_lo >= 0 and EL < j_end):
        return None

    # per-phase filters H_p[q] (q in [q_min, q_max], current-domain taps)
    s_idx = np.arange(s_min, s_max + 1)
    qs = [(p - s_idx + half) // ratio for p in range(ratio)]
    q_min = int(min(q.min() for q in qs))
    q_max = int(max(q.max() for q in qs))
    nq = q_max - q_min + 1
    Hm = np.zeros((ratio, nq))
    for p in range(ratio):
        np.add.at(Hm[p], (qs[p] - q_min).astype(int), h)

    # interior block geometry (current-domain t units)
    t0_base = EL // ratio
    total_t = (j_end - EL) // ratio
    nblk = -(-total_t // T)
    T_last = total_t - (nblk - 1) * T
    # every block's reads of c must be in range
    if t0_base + q_min < 0:
        return None
    if t0_base + (nblk - 1) * T + T_last - 1 + q_max >= n_curr:
        return None
    # the edge windows' replication sources must be in range
    for j0 in (0, n_up - W):
        src = (j0 + np.arange(W) + half) // ratio
        if src.min() < 0 or src.max() >= n_curr:
            return None
    return dict(
        Hm=Hm, EL=EL, ERW=ERW, nq=nq, q_min=q_min, t0_base=t0_base,
        nblk=nblk, T_last=T_last,
    )
