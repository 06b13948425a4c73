"""Plain reference of the hpge-icpc configuration's 34 columns.

Straightforward PyTorch over a block of events, in float64, written from the
reference dspeed processors' definitions (legend-exp/dspeed,
``dspeed/processors``) with every parameter of the chain resolved by hand
from the configuration (no database: each ``db.*`` takes its default; 16 ns
a sample). It uses no code of the program, and makes its own filter kernels.
``compute(waveform, baseline)`` takes float32 ``(B, 4096)`` and ``(B,)``
tensors and returns each output column as a float64 numpy array in the
column's unit (sample times in ns).

``precision`` selects the arithmetic: ``"float64"`` is the reference, and
``"tf32"`` (float32 rows, the convolutions on the tensor cores in TF32) is
the control that the comparison must reject.
"""

import numpy as np
import torch
import torch.nn.functional as F

DT = 16.0  # ns a sample
N = 4096
TAU_PZ = 27460.5  # db.pz.tau's default, in samples
TAU_CUSP = 450e3 / DT  # db.pz.tau's default in the CUSP and ZAC filters: 450 us
SIGMA_CUSP = 20e3 / DT  # 20 us
FLAT_CUSP = 188  # round(3 us / 16 ns)
CUSP_LEN = 4096 - 2100 - 300  # len(wf_blsub) - 33.6 us - 4.8 us, in samples
CUSP_IN = 4096 - 2100  # wf_blsub[:len - 33.6 us]
ETRAP = (625, 188)  # 10 us rise, 3.008 us flat
QTRAP = (250, 6)  # 4 us rise, 96 ns flat
ATRAP = (8, 4, 125)  # 128 ns rise, 4 samples flat, 2 us fall
T0_RISE, T0_FALL = 8, 125  # 128 ns, 2 us
EFTP_OFFSET = 625 + 150  # db.etrap.rise + db.etrap.flat * db.etrap.sample (3 us * 0.8)
QFTP_OFFSET = 506  # 8.096 us
CASCADE = (("tp_99", 0.99, "tp_0_est", 1), ("tp_95", 0.95, "tp_99", 0),
           ("tp_90", 0.9, "tp_95", 0), ("tp_80", 0.8, "tp_90", 0),
           ("tp_50", 0.5, "tp_80", 0), ("tp_20", 0.2, "tp_50", 0),
           ("tp_10", 0.1, "tp_20", 0), ("tp_01", 0.01, "tp_10", 0),
           ("tp_100", 1.0, "tp_0_est", 1))
NAN = float("nan")


def _cusp_shape(n, sigma, flat):
    lt = int((n - flat) / 2)
    i = np.arange(n)
    k = np.ones(n)
    k[:lt] = np.sinh(i[:lt] / sigma) / np.sinh(lt / sigma)
    k[lt + flat + 1:] = np.sinh((n - i[lt + flat + 1:]) / sigma) / np.sinh(lt / sigma)
    return k, lt


def cusp_kernel():
    k, _ = _cusp_shape(CUSP_LEN, SIGMA_CUSP, FLAT_CUSP)
    return np.convolve(k, [1.0, -np.exp(-1.0 / TAU_CUSP)], "same")


def zac_kernel():
    n = CUSP_LEN
    k, lt = _cusp_shape(n, SIGMA_CUSP, FLAT_CUSP)
    i = np.arange(n)
    par = np.zeros(n)
    par[:lt] = (i[:lt] - lt / 2) ** 2 - (lt / 2) ** 2
    tail = slice(lt + FLAT_CUSP + 1, None)
    par[tail] = ((n - i[tail]) - lt / 2) ** 2 - (lt / 2) ** 2
    par = -par / par.sum() * k.sum()
    return np.convolve(k + par, [1.0, -np.exp(-1.0 / TAU_CUSP)], "same")


def t0_kernel():
    k = np.empty(T0_RISE + T0_FALL)
    i = np.arange(T0_RISE)
    k[:T0_RISE] = 2 * (T0_RISE - i) / (T0_RISE * (T0_RISE + 1))
    k[T0_RISE:] = -1.0 / T0_FALL
    return k


def _conv_valid(x, k, dtype):
    """numpy's ``convolve(x, k, 'valid')`` of each row, as one ``conv1d``
    (a correlation with the reversed kernel)."""
    kt = torch.as_tensor(np.ascontiguousarray(k[::-1]), dtype=dtype, device=x.device)
    return F.conv1d(x[:, None, :], kt[None, None, :])[:, 0, :]


def _conv_same(x, k, dtype):
    """numpy's ``convolve(x, k, 'same')``: the full convolution's centre."""
    m = len(k)
    full = _conv_valid(F.pad(x, (m - 1, m - 1)), k, dtype)
    lo = (m - 1) // 2
    return full[:, lo:lo + x.shape[1]]


def _prefix(x):
    """Inclusive running sum with S[-1] = 0 before it: (B, n + 1)."""
    return F.pad(torch.cumsum(x, dim=1), (1, 0))


def _window_sum(s, i_end, width):
    """sum x[i_end - width + 1 .. i_end] from the prefix ``s`` (x = 0 before
    the row) for every i_end of the row."""
    n = s.shape[1] - 1
    i = torch.arange(n, device=s.device)
    hi = s[:, i + 1]
    lo_idx = i + 1 - width
    lo = torch.where(lo_idx >= 0, s[:, lo_idx.clamp(min=0)], torch.zeros_like(hi))
    return hi - lo


def trap_norm(x, rise, flat):
    s = _prefix(x)
    i = torch.arange(x.shape[1], device=x.device)
    lead = _window_sum(s, i, rise)
    back_end = i - rise - flat
    trail = torch.where(back_end >= 0, _window_sum(s, i, rise)[:, back_end.clamp(min=0)],
                        torch.zeros_like(lead))
    return (lead - trail) / rise


def asym_trap(x, rise, flat, fall):
    s = _prefix(x)
    i = torch.arange(x.shape[1], device=x.device)
    lead = _window_sum(s, i, rise)
    back_end = i - rise - flat
    trail = torch.where(back_end >= 0, _window_sum(s, i, fall)[:, back_end.clamp(min=0)],
                        torch.zeros_like(lead))
    return lead / rise - trail / fall


def pole_zero(x, tau):
    """y[i] = y[i-1] + x[i] - exp(-1/tau) x[i-1], y[0] = x[0]."""
    c = np.exp(-1.0 / tau)
    excl = F.pad(torch.cumsum(x, dim=1)[:, :-1], (1, 0))
    return x + (1.0 - c) * excl


def slope_fit(x):
    """mean, sample standard deviation, slope and intercept of each row."""
    n = x.shape[1]
    i = torch.arange(n, device=x.device, dtype=x.dtype)
    mean = x.mean(dim=1)
    std = torch.sqrt(((x - mean[:, None]) ** 2).sum(dim=1) / (n - 1))
    im = i.mean()
    slope = ((i - im) * (x - mean[:, None])).sum(dim=1) / ((i - im) ** 2).sum()
    return mean, std, slope, mean - slope * im


def min_max(x):
    """first index of the minimum and of the maximum, the minimum, the maximum."""
    n = x.shape[1]
    i = torch.arange(n, device=x.device)
    lo, hi = x.min(dim=1).values, x.max(dim=1).values
    t_lo = torch.where(x == lo[:, None], i, n).amin(dim=1)
    t_hi = torch.where(x == hi[:, None], i, n).amin(dim=1)
    bad = torch.isnan(x).any(dim=1)
    return tuple(torch.where(bad, torch.full_like(lo, NAN), v.to(x.dtype))
                 for v in (t_lo, t_hi, lo, hi))


def time_point_thresh(x, a, t_start, forward):
    """The reference's threshold walk from ``t_start``: forward, the first i
    >= start where the row crosses ``a`` between i and i+1; backward, the
    last i <= start where it crosses between i-1 and i. NaN where the start
    is NaN, out of the row or not an integer, or nothing is found."""
    n = x.shape[1]
    i = torch.arange(n, device=x.device)
    a = a[:, None]
    w0, w1 = x[:, :-1], x[:, 1:]
    ok = torch.isfinite(t_start) & (t_start >= 0) & (t_start < n) & (t_start == torch.floor(t_start))
    ts = torch.where(ok, t_start, torch.zeros_like(t_start))[:, None]
    if forward:
        cross = ((w0 <= a) & (a < w1)) | ((w0 >= a) & (a > w1))
        cross = F.pad(cross, (0, 1), value=False)
        hit = torch.where(cross & (i >= ts), i, n).amin(dim=1)
        found = hit < n
    else:
        cross = ((w0 < a) & (a <= w1)) | ((w0 > a) & (a >= w1))
        cross = F.pad(cross, (1, 0), value=False)
        hit = torch.where(cross & (i <= ts), i, -1).amax(dim=1)
        found = hit >= 0
    return torch.where(ok & found & ~torch.isnan(a[:, 0]), hit.to(x.dtype),
                       torch.full_like(t_start, NAN))


def pick(x, t):
    """x[t] at an integral index ``t`` (linear interpolation at an integer);
    NaN where ``t`` is NaN or outside the row."""
    n = x.shape[1]
    ok = torch.isfinite(t) & (t >= 0) & (t <= n - 1)
    idx = torch.where(ok, t, torch.zeros_like(t)).long()
    return torch.where(ok, x.gather(1, idx[:, None])[:, 0], torch.full_like(t, NAN))


def window(x, t0, m):
    """x[trunc(t0) + j] for j < m, NaN outside the row or where t0 is NaN."""
    n = x.shape[1]
    ok = torch.isfinite(t0)
    start = torch.where(ok, torch.trunc(t0), torch.zeros_like(t0)).long()
    idx = start[:, None] + torch.arange(m, device=x.device)
    inside = (idx >= 0) & (idx < n) & ok[:, None]
    out = x.gather(1, idx.clamp(0, n - 1))
    return torch.where(inside, out, torch.full_like(out, NAN))


def moving_window_multi(x, length, num):
    """``num`` moving averages of ``length`` samples, alternating left to
    right and right to left (the reference's mw_type 0), each with the
    reference's ramp-in from the edge sample."""
    out = x
    for it in range(num):
        rev = it % 2 == 1
        y = torch.flip(out, dims=[1]) if rev else out
        s = _prefix(y)
        n = y.shape[1]
        i = torch.arange(n, device=y.device)
        ramp = y[:, :1] + (s[:, i + 1] - (i + 1) * y[:, :1]) / length
        steady = _window_sum(s, i, length) / length
        y = torch.where(i < length, ramp, steady)
        out = torch.flip(y, dims=[1]) if rev else y
    return out


def compute(waveform, baseline, precision="float64"):
    if precision == "float64":
        dt = torch.float64
        ctx = None
    elif precision == "tf32":
        dt = torch.float32
        ctx = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
    else:
        raise ValueError(f"unknown precision {precision!r}")
    try:
        return _compute(waveform.to(dt), baseline.to(dt), dt)
    finally:
        if ctx is not None:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = ctx


def _compute(w, b, dt):
    out = {}
    tp_min, tp_max, out["wf_min"], out["wf_max"] = min_max(w)
    out["tp_min"], out["tp_max"] = tp_min * DT, tp_max * DT
    blsub = w - b[:, None]
    out["bl_mean"], bl_std, out["bl_slope"], out["bl_intercept"] = slope_fit(blsub[:, :750])
    out["bl_std"] = bl_std
    pz = pole_zero(blsub, TAU_PZ)
    out["pz_mean"], out["pz_std"], out["pz_slope"], _ = slope_fit(pz[:, 1500:])
    trap = trap_norm(pz, *ETRAP)
    trap_max = trap.max(dim=1).values
    out["trapTmax"] = out["trapEmax"] = trap_max
    t0f = _conv_same(pz, t0_kernel(), dt)
    _, tp_start, _, _ = min_max(t0f)
    tp0 = time_point_thresh(t0f, bl_std, tp_start, False)
    out["tp_0_est"] = tp0 * DT
    out["tp_0_atrap"] = time_point_thresh(asym_trap(pz, *ATRAP), bl_std, tp_start, False) * DT
    tps = {"tp_0_est": tp0}
    for name, frac, start, fwd in CASCADE:
        tps[name] = time_point_thresh(pz, frac * trap_max, tps[start], fwd)
        out[name] = tps[name] * DT
    # A/E: the current over 301 samples from tp_0_est, replicated 16 times
    # (each sample into slots 16 i - 8 .. 16 i + 7), three moving averages
    le = window(pz, tp0, 301)
    curr = le[:, 1:] - le[:, :-1]
    up = torch.repeat_interleave(curr, 16, dim=1)[:, 8:8 + 4784]
    av = moving_window_multi(up, 48, 3)
    _, tp_aoe, _, out["A_max"] = min_max(av)
    out["tp_aoe_max"] = tp_aoe * DT
    out["tp_aoe_samp"] = (tp0 + tp_aoe / 16) * DT
    q = pick(trap_norm(pz, *QTRAP), tp0 + QFTP_OFFSET)
    out["QDrift"] = q * 16
    out["dt_eff"] = out["QDrift"] / trap_max
    out["trapEftp"] = pick(trap, torch.round(tp0 + EFTP_OFFSET))
    head = blsub[:, :CUSP_IN]
    for name, kern in (("cusp", cusp_kernel()), ("zac", zac_kernel())):
        y = _conv_valid(head, kern, dt)
        out[f"{name}Emax"] = y.max(dim=1).values
        out[f"{name}Eftp"] = y[:, 50]
    return {k: v.to(torch.float64).cpu().numpy() for k, v in out.items()}
