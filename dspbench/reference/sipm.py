"""Plain reference of the sipm configuration's two VectorOfVectors columns.

Straightforward PyTorch over a block of events, written from the reference
dspeed processors' definitions (legend-exp/dspeed, ``dspeed/processors``:
``gaussian_filter1d``, ``reflected_convolve_wf``, ``avg_current``,
``histogram``, ``histogram_stats``, ``get_multi_local_extrema``,
``peak_snr_threshold``, ``multi_a_filter``) with the chain's parameters
resolved by hand from the configuration (no database; 16 ns a sample). It
uses no code of the program. The chain declares its Gaussian kernel in
float64, so the rows are smoothed and searched in float64.

``compute(waveform)`` takes a float32 ``(B, 1024)`` tensor and returns
``{"trigger_pos": (B, 20), "energies": (B, 20), "n": (B,)}`` float64 numpy
arrays: each event's found pulses in their order, NaN after its ``n``th,
times in ns. ``precision="float32"`` (rows and arithmetic in float32) is the
control that the comparison must reject.
"""

import numpy as np
import torch
import torch.nn.functional as F

DT = 16.0  # ns a sample
SIGMA, TRUNC = 1.0, 4.0  # db.gauss.width, db.gauss.trunc defaults
CURR_LEN = 5  # avg_current's length
BINS = 100
SLOTS = 20  # vt_max_candidate_out(20)
DELTA_MAX, DELTA_MIN = 5.0, 0.1  # the peak finder's hysteresis
ABS_MIN = 0.0
FWHM_FACTOR = 3.0  # a_abs_max = 3 * fwhm
SNR_RATIO, SNR_WIDTH = 0.8, 10
NAN = float("nan")


def gauss_kernel():
    lw = int(TRUNC * SIGMA + 0.5)
    x = np.arange(-lw, lw + 1)
    phi = np.exp(-0.5 / (SIGMA * SIGMA) * x ** 2)
    return phi / phi.sum()


def smooth(w, dt):
    """scipy's gaussian_filter1d with mode 'reflect': the row padded by
    reflection (the edge sample not repeated) by len(kernel) // 2 + 1, the
    centred convolution, cut back to the row."""
    k = gauss_kernel()
    ext = len(k) // 2 + 1
    wp = F.pad(w[:, None, :], (ext, ext), mode="reflect")[:, 0, :]
    kt = torch.as_tensor(np.ascontiguousarray(k[::-1]), dtype=dt, device=w.device)
    half = len(k) // 2
    same = F.conv1d(F.pad(wp, (half, half))[:, None, :], kt[None, None, :])[:, 0, :]
    return same[:, ext:-ext]


def histogram_fwhm(x):
    """The width of the histogram of each row's values (100 bins spanning
    its minimum to its maximum, the maximum itself not counted), as
    histogram_stats gives it: from the fullest bin (its left edge), the
    first bin at or right of it holding at most half as many (and some),
    widened to the first bin left of it holding at least half (and some)
    where that lies farther."""
    dt = x.dtype
    lo = x.min(dim=1, keepdim=True).values
    hi = x.max(dim=1, keepdim=True).values
    step = torch.ones((), dtype=dt, device=x.device) / BINS
    delta = (hi - lo) * step
    frac = torch.cat([torch.arange(BINS, dtype=dt, device=x.device) * step,
                      torch.ones(1, dtype=dt, device=x.device)])
    edges = lo + (hi - lo) * frac
    ok = delta > 0
    k = torch.floor((x - lo) / torch.where(ok, delta, torch.ones_like(delta))).long()
    valid = (x != hi) & ok & (k >= 0) & (k < BINS)
    counts = torch.zeros((x.shape[0], BINS), dtype=dt, device=x.device)
    counts.scatter_add_(1, torch.where(valid, k, 0), valid.to(dt))
    pos = torch.arange(BINS, device=x.device)
    top = torch.where(counts == counts.max(dim=1, keepdim=True).values, pos, BINS).amin(dim=1)
    top_edge = edges.gather(1, top[:, None])[:, 0]
    half = 0.5 * counts.gather(1, top[:, None])
    right = (pos >= top[:, None]) & (counts <= half) & (counts != 0)
    left = (pos < top[:, None]) & (counts >= half) & (counts != 0)
    r = torch.where(right, pos, BINS).amin(dim=1)
    l_ = torch.where(left, pos, BINS).amin(dim=1)
    w_r = (top_edge - edges.gather(1, r.clamp(max=BINS - 1)[:, None])[:, 0]).abs()
    w_l = (top_edge - edges.gather(1, l_.clamp(max=BINS - 1)[:, None])[:, 0]).abs()
    fwhm = torch.where(r < BINS, w_r, torch.full_like(w_r, NAN))
    return torch.where((l_ < BINS) & (r < BINS) & (w_l > w_r), w_l, fwhm)


def maxima_right_to_left(x, abs_max):
    """Billauer's peak finder walked from the last sample to the first: the
    sample indices of the maxima it declares, in order, NaN after them (at
    most SLOTS). A maximum is declared when the row falls DELTA_MAX below
    the running maximum and that maximum exceeds ``abs_max``; a minimum when
    it rises DELTA_MIN above the running minimum and that minimum is below
    ABS_MIN; each declaration restarts the other tracker at the sample."""
    B, n = x.shape
    dev, dt = x.device, x.dtype
    vx = torch.full((B,), -np.inf, dtype=dt, device=dev)
    vn = torch.full((B,), np.inf, dtype=dt, device=dev)
    ix = torch.zeros(B, dtype=torch.long, device=dev)
    find_max = torch.ones(B, dtype=torch.bool, device=dev)
    n_max = torch.zeros(B, dtype=torch.long, device=dev)
    n_min = torch.zeros(B, dtype=torch.long, device=dev)
    found = torch.full((B, SLOTS), NAN, dtype=dt, device=dev)
    slots = torch.arange(SLOTS, device=dev)[None, :]
    for i in range(n - 1, -1, -1):
        wi = x[:, i]
        up = wi > vx
        vx = torch.where(up, wi, vx)
        ix = torch.where(up, i, ix)
        vn = torch.where(wi < vn, wi, vn)
        is_max = find_max & (wi < vx - DELTA_MAX) & (n_max < SLOTS) & (vx > abs_max)
        is_min = ~find_max & (wi > vn + DELTA_MIN) & (n_min < SLOTS) & (vn < ABS_MIN)
        found = torch.where(is_max[:, None] & (slots == n_max[:, None]),
                            ix[:, None].to(dt), found)
        n_max += is_max.long()
        n_min += is_min.long()
        vn = torch.where(is_max, wi, vn)
        vx = torch.where(is_min, wi, vx)
        ix = torch.where(is_min, i, ix)
        find_max = torch.where(is_max, False, torch.where(is_min, True, find_max))
    return found


def snr_filter(x, idx):
    """Keep, in order, the candidates whose smallest value within
    SNR_WIDTH samples before them (to SNR_WIDTH - 1 after them, cut at the
    row's ends) over their own value is below SNR_RATIO in magnitude."""
    B, n = x.shape
    keep = torch.zeros(idx.shape, dtype=torch.bool, device=x.device)
    for s in range(SLOTS):
        t = idx[:, s]
        valid = ~torch.isnan(t)
        ti = torch.where(valid, t, torch.zeros_like(t)).long()
        a = (ti - SNR_WIDTH).clamp(0, n - 1)
        b = (ti + SNR_WIDTH).clamp(0, n - 1)
        pos = a[:, None] + torch.arange(2 * SNR_WIDTH, device=x.device)
        vals = x.gather(1, pos.clamp(max=n - 1))
        vals = torch.where(pos < b[:, None], vals, torch.full_like(vals, np.inf))
        low = torch.minimum(vals.min(dim=1).values, x.gather(1, a[:, None])[:, 0])
        peak = x.gather(1, ti[:, None])[:, 0]
        keep[:, s] = valid & ((low / peak).abs() < SNR_RATIO)
    n_keep = keep.sum(dim=1)
    order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
    kept = idx.gather(1, order)
    slots = torch.arange(SLOTS, device=x.device)[None, :]
    return torch.where(slots < n_keep[:, None], kept, torch.full_like(kept, NAN)), n_keep


def compute(waveform, precision="float64"):
    if precision not in ("float64", "float32"):
        raise ValueError(f"unknown precision {precision!r}")
    dt = torch.float64 if precision == "float64" else torch.float32
    w = waveform.to(dt)
    g = smooth(w, dt)
    curr = (g[:, CURR_LEN:] - g[:, :-CURR_LEN]) / CURR_LEN
    fwhm = histogram_fwhm(curr)
    cand = maxima_right_to_left(curr, FWHM_FACTOR * fwhm)
    trig, n = snr_filter(curr, cand)
    ok = ~torch.isnan(trig)
    ti = torch.where(ok, trig, torch.zeros_like(trig)).long()
    energies = torch.where(ok, curr.gather(1, ti), torch.full_like(trig, NAN))
    return {"trigger_pos": (trig * DT).to(torch.float64).cpu().numpy(),
            "energies": energies.to(torch.float64).cpu().numpy(),
            "n": n.cpu().numpy()}
