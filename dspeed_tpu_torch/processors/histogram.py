"""Histogramming (reference ``dspeed/processors/histogram.py:22,100``; JAX
package ``dspeed_tpu/processors/histogram.py``).

Self-ranging fixed-bin histograms as one batched ``scatter_add_`` into a
``(B, m)`` tensor, the JAX package's CPU route (``_scatter_hist`` :19). The
counts are integers below 2^24, so they are exact in the float type in any
order of the additions, the card's atomics included.
"""

from __future__ import annotations

import torch

from ..errors import DSPFatal
from ._helpers import isnan_any, nanmask, per_row
from ._kernel import kernel

__all__ = ["histogram", "histogram_around_mode"]


def _scatter_hist(k, m, valid, dtype):
    """Per-row bincount of the bin indices ``k`` (integer, ``(..., n)``)
    where ``valid``: ``(..., m)`` counts in ``dtype``."""
    lead = k.shape[:-1]
    kf = k.reshape(-1, k.shape[-1]).long()
    vf = valid.reshape(-1, valid.shape[-1])
    out = torch.zeros((kf.shape[0], m), dtype=dtype, device=k.device)
    out.scatter_add_(1, torch.where(vf, kf, 0), vf.to(dtype))
    return out.reshape(*lead, m)


def _recip(d: int, dtype, device) -> torch.Tensor:
    """``1 / d`` rounded to ``dtype`` (a true division on the device): XLA
    turns a division by a constant into the product with this reciprocal,
    and the JAX package's bin width and bin borders are computed so."""
    one = torch.ones((), dtype=dtype, device=device)
    return one / torch.full((), d, dtype=dtype, device=device)


def linspace01(p: int, dtype, device) -> torch.Tensor:
    """``jnp.linspace(0.0, 1.0, p, dtype=dtype)`` bit for bit: ``i * (1 /
    (p - 1))`` in ``dtype`` for ``i < p - 1``, then exactly 1.
    ``torch.linspace`` rounds other values (20 of 101 differ in float32)."""
    if p == 1:
        return torch.zeros(1, dtype=dtype, device=device)
    d = p - 1
    step = torch.arange(d, dtype=dtype, device=device) * _recip(d, dtype, device)
    return torch.cat([step, torch.ones(1, dtype=dtype, device=device)])


def _lift(bad, like):
    if isinstance(bad, torch.Tensor):
        while bad.ndim < like.ndim:
            bad = bad[..., None]
    return bad


@kernel("(n),(m),(p)", ["fff", "ddd"], nout=2, uses_dims=True)
def histogram(w_in, dims):
    """Self-ranging histogram: ``m`` weights, ``p = m+1`` bin edges spanning
    [min, max] (reference ``histogram.py:22``). The row maximum itself is
    not counted (``w_in != max``, as the JAX package has it)."""
    m, p = dims["m"], dims["p"]
    if m + 1 != p:
        raise DSPFatal(
            "length borders_out must be exactly 1 + length of weights_out"
        )
    dt = w_in.dtype
    wf_min = w_in.amin(dim=-1, keepdim=True)
    wf_max = w_in.amax(dim=-1, keepdim=True)
    delta = (wf_max - wf_min) * _recip(m, dt, w_in.device)
    borders = wf_min + (wf_max - wf_min) * linspace01(p, dt, w_in.device)
    ok = delta > 0
    one = torch.ones((), dtype=dt, device=w_in.device)
    k = torch.floor((w_in - wf_min) / torch.where(ok, delta, one)).to(torch.int32)
    valid = (w_in != wf_max) & ok & (k >= 0) & (k < m)
    weights = _scatter_hist(k, m, valid, dt)
    bad = isnan_any(w_in, 1)
    return (
        torch.where(_lift(bad, weights), torch.zeros((), dtype=dt, device=w_in.device),
                    weights),
        nanmask(bad, borders),
    )


@kernel("(n),(),(),(m),(p)", ["fffff", "ddddd"], nout=2, uses_dims=True)
def histogram_around_mode(w_in, center, bin_width, dims):
    """Two-pass histogram: the mode from a self-ranging pass (where
    ``center`` is NaN), then fixed-width bins of ``bin_width`` centred on it
    (reference ``histogram.py:100``)."""
    m, p = dims["m"], dims["p"]
    if m + 1 != p:
        raise DSPFatal(
            "length borders_out must be exactly 1 + length of weights_out"
        )
    dt = w_in.dtype
    dev = w_in.device
    bw = per_row(bin_width, w_in)
    c_in = per_row(center, w_in)

    # pass 1: the mode of a self-ranging histogram
    wf_min = w_in.amin(dim=-1, keepdim=True)
    wf_max = w_in.amax(dim=-1, keepdim=True)
    delta = (wf_max - wf_min) * _recip(m, dt, dev)
    ok = delta > 0
    one = torch.ones((), dtype=dt, device=dev)
    k1 = torch.floor((w_in - wf_min) / torch.where(ok, delta, one)).to(torch.int32)
    valid1 = (w_in != wf_max) & ok & (k1 >= 0) & (k1 < m)
    weights1 = _scatter_hist(k1, m, valid1, dt)
    mode_bin = torch.argmax(weights1, dim=-1)
    half = torch.full((), 0.5, dtype=dt, device=dev)
    mode = (wf_min[..., 0] + delta[..., 0] * mode_bin.to(dt)) + half * delta[..., 0]
    mode = torch.round(mode / bw) * bw
    auto_center = torch.where(ok[..., 0], mode, wf_min[..., 0])
    c = torch.where(torch.isnan(c_in), auto_center, c_in)

    # pass 2: fixed-width, centre-aligned bins
    hist_min = c - bw * (m // 2) - half * bw
    k2 = torch.floor((w_in - hist_min[..., None]) / bw[..., None]).to(torch.int32)
    valid2 = (k2 >= 0) & (k2 < m)
    weights = _scatter_hist(k2, m, valid2, dt)
    borders = hist_min[..., None] + bw[..., None] * torch.arange(p, dtype=dt, device=dev)
    bad = isnan_any(w_in, 1)
    return (
        torch.where(_lift(bad, weights), torch.zeros((), dtype=dt, device=dev),
                    weights),
        nanmask(bad, borders),
    )


def _ham_checker(w_in, center, bin_width):
    """Checked-mode flag: the reference raises on any NaN input sample
    (``histogram.py:158-159``; plain ``histogram`` zero-fills instead)."""
    bad = isnan_any(w_in, 1)
    return bad.to(torch.int32).expand(w_in.shape[:-1])


histogram_around_mode.checker = _ham_checker
histogram_around_mode.check_messages = {1: "input data contains nan"}
