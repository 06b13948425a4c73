"""Prefix sums at accumulation precision and zero-filled shifts.

The JAX package reformulates the reference's sequential recursions as
differences of prefix sums and, for the TPU, carries those sums in
compensated float32 (``dspeed_tpu/processors/_numerics.py``). Both the CPU
and the H100 run float64 natively, so here a prefix sum is one ``cumsum`` in
the accumulation dtype of :mod:`dspeed_tpu_torch.config`.

The first-order recursion ``y[i] = x[i] + p*y[i-1]``, which the JAX package
evaluates as blocked triangular matmuls (``_numerics.py:250``), runs here
sample by sample in float64 on the recurrence kernel
(:func:`._cuda.recurrence`), one thread per row.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import config

__all__ = ["hp_cumsum", "iir_first_order", "iir_first_order_runs", "k7_prefix",
           "k7_sum", "shift_right", "true_div"]


def hp_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum over the last axis at accumulation precision."""
    return torch.cumsum(x.to(config.accum_dtype()), dim=-1)


def true_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` rounded once, with ``d`` in ``x``'s type. On CUDA PyTorch
    divides by a python scalar as a product with its rounded reciprocal; a
    divisor on the device is a true division, as in the kernels and the JAX
    package."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def shift_right(x: torch.Tensor, k: int, fill: float = 0.0) -> torch.Tensor:
    """``x[..., i - k]`` along the last axis, ``fill`` where ``i < k``."""
    if k == 0:
        return x
    n = x.shape[-1]
    k = min(k, n)
    return F.pad(x[..., : n - k], (k, 0), value=fill)


def iir_first_order(x: torch.Tensor, p: float, y_init=0.0) -> torch.Tensor:
    """``y[i] = x[i] + p*y[i-1]`` along the last axis, with ``y[-1] =
    y_init`` (a number, or one value per row of ``x``). Accumulates in
    :func:`config.accum_dtype` and rounds once to ``x``'s type; CUDA tensors
    run the recurrence kernel, CPU tensors its plain version."""
    from ._cuda import recurrence

    *lead, n = x.shape
    u = x.reshape(-1, n)
    if u.stride(-1) != 1:
        u = u.contiguous()
    y0 = y_init
    if isinstance(y_init, torch.Tensor) and y_init.ndim:
        y0 = y_init.to(config.accum_dtype()).expand(*lead).reshape(-1)
    elif float(y_init) == 0.0:
        y0 = None
    return recurrence(u, float(p), y0).reshape(*lead, n)


def _affine(m1, e1, m2, e2):
    """The affine map ``y -> m1 y + e1`` followed by ``y -> m2 y + e2``,
    each product and sum rounded once: ``(m1 m2, m2 e1 + e2)``."""
    return m1 * m2, m2 * e1 + e2


K7_THREADS = 256  # threads a block of K7 (csrc/generic_rows.cu GEN_THREADS)


def iir_first_order_runs(x: torch.Tensor, p: float) -> torch.Tensor:
    """``y[i] = x[i] + p*y[i-1]`` from ``y[-1] = 0`` along the last axis of a
    ``(B, n)`` tensor, in float64, in the order of K7's ``double_pole_zero``
    op (``csrc/generic_rows.cu``, ``op_dpz``), which equals it bit for bit:

    - the row is cut into ``K7_THREADS`` contiguous runs of ``ceil(n /
      K7_THREADS)`` samples (``row_prefix.cuh``'s ``scan_run``); each run's
      recurrence starts from 0 (``v``), and its map is ``(p^len, v_end)``,
      ``p^len`` a product of ``p`` taken one factor at a time;
    - the maps are scanned exclusively in run order as a block of warps of
      32 scans them: Hillis-Steele over the lanes (offsets 1 .. 16) and a
      shift by one lane; a warp's carry-in is the warps before it composed
      in order, each thread folding them from shared memory;
    - each sample adds ``p^(k+1)`` (a running product) times its run's
      carry, the value before the run.

    Differs from :func:`iir_first_order`'s sequential order by rounding
    only. Returns float64."""
    B, n = x.shape
    dev, f64 = x.device, torch.float64
    threads = K7_THREADS
    per = -(-n // threads)
    runs = torch.zeros((B, threads * per), dtype=f64, device=dev)
    runs[:, :n] = x.to(f64)
    runs = runs.view(B, threads, per)
    cnt = (n - torch.arange(threads, device=dev) * per).clamp(0, per)
    v = torch.zeros((B, threads), dtype=f64, device=dev)
    m = torch.ones(threads, dtype=f64, device=dev)
    vs = torch.empty_like(runs)
    for k in range(per):
        live = k < cnt
        nv = p * v + runs[:, :, k]
        vs[:, :, k] = nv
        v = torch.where(live, nv, v)
        m = torch.where(live, m * p, m)
    warps = threads // 32
    M = m.expand(B, threads).reshape(B, warps, 32)
    E = v.reshape(B, warps, 32)
    lane = torch.arange(32, device=dev)

    def up(t, o, fill):
        return torch.cat([torch.full_like(t[..., :o], fill), t[..., :-o]], dim=-1)

    for o in (1, 2, 4, 8, 16):
        nm, ne = _affine(up(M, o, 1.0), up(E, o, 0.0), M, E)
        M = torch.where(lane >= o, nm, M)
        E = torch.where(lane >= o, ne, E)
    mx, ex = up(M, 1, 1.0), up(E, 1, 0.0)
    # the warps' totals, folded in warp order: warp w's carry-in is warps
    # 0 .. w-1 composed left to right
    tm, te = M[..., 31], E[..., 31]
    before = torch.zeros((B, warps), dtype=f64, device=dev)
    am, ae = tm[:, 0], te[:, 0]
    for w in range(1, warps):
        before[:, w] = ae
        am, ae = _affine(am, ae, tm[:, w], te[:, w])
    carry = torch.where(torch.arange(warps, device=dev)[:, None] > 0,
                        mx * before[..., None] + ex, ex).reshape(B, threads, 1)
    pk = []
    q = p
    for _ in range(per):
        pk.append(q)
        q = q * p
    y = vs + torch.tensor(pk, dtype=f64, device=dev) * carry
    return y.reshape(B, threads * per)[:, :n]


def k7_sum(v: torch.Tensor) -> torch.Tensor:
    """The sum over the last axis of a ``(B, n)`` float64 tensor in the order
    of K7's block reductions (``csrc/generic_rows.cu``), which equal it bit
    for bit: thread ``t`` of ``K7_THREADS`` adds ``v[t], v[t + 256], ...`` in
    turn to 0.0; each warp's 32 sums meet by ``warp_sum``'s shuffle tree
    (offsets 16 .. 1, lane 0's value); the 8 warp sums by ``replay_sum``
    (each plus 0.0 twice, then offsets 4, 2, 1). A sum that starts from +0.0
    is never -0.0, so the zeros that pad the row add nothing."""
    B, n = v.shape
    threads = K7_THREADS
    per = -(-n // threads)
    acc = torch.zeros((B, threads), dtype=torch.float64, device=v.device)
    pad = F.pad(v.to(torch.float64), (0, per * threads - n))
    for q in range(per):
        acc = acc + pad[:, q * threads:(q + 1) * threads]
    a = acc.view(B, threads // 32, 32)
    for o in (16, 8, 4, 2, 1):
        a = a[..., :o] + a[..., o:2 * o]
    w = (a[..., 0] + 0.0) + 0.0
    for o in (4, 2, 1):
        w = w[:, :o] + w[:, o:2 * o]
    return w[:, 0]


def k7_prefix(x: torch.Tensor, exclusive: bool = False) -> torch.Tensor:
    """The inclusive float64 prefix over the last axis of a ``(B, n)``
    tensor in the order of K7's prefixes (``gen_prefix``), which equal it
    bit for bit: ``K7_THREADS`` contiguous runs of ``ceil(n / K7_THREADS)``
    samples (``scan_run``), each run's sum from 0.0; the sums scanned
    exclusively as ``gen_excl_scan`` scans them (Hillis-Steele over a warp's
    lanes, a shift by one lane, the 8 warp totals scanned likewise, warp
    ``w`` taking the inclusive total of warps ``0 .. w-1`` plus its lane's
    exclusive value); then each run's samples added to its start in
    turn. With ``exclusive`` the value before each sample is added (a run's
    first: its start), as K7's float64 ``pole_zero`` takes it. Differs from
    :func:`hp_cumsum` by rounding only."""
    B, n = x.shape
    dev, f64 = x.device, torch.float64
    threads = K7_THREADS
    per = -(-n // threads)
    runs = F.pad(x.to(f64), (0, per * threads - n)).view(B, threads, per)
    run = torch.zeros((B, threads), dtype=f64, device=dev)
    for k in range(per):
        run = run + runs[:, :, k]
    warps = threads // 32
    s = run.view(B, warps, 32)
    lane = torch.arange(32, device=dev)

    def up(t, o):
        return torch.cat([torch.zeros_like(t[..., :o]), t[..., :-o]], dim=-1)

    for o in (1, 2, 4, 8, 16):
        s = torch.where(lane >= o, s + up(s, o), s)
    excl = up(s, 1)
    tot = s[..., 31]
    for o in (1, 2, 4):
        tot = torch.cat([tot[:, :o], tot[:, o:] + tot[:, :-o]], dim=1)
    before = torch.cat([torch.zeros_like(tot[:, :1]), tot[:, :-1]], dim=1)
    start = (before[..., None] + excl).reshape(B, threads)
    ps = torch.empty((B, threads, per), dtype=f64, device=dev)
    for k in range(per):
        if exclusive:
            ps[:, :, k] = start
        start = start + runs[:, :, k]
        if not exclusive:
            ps[:, :, k] = start
    return ps.reshape(B, threads * per)[:, :n]
