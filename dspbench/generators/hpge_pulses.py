"""Synthetic ICPC HPGe records, made on the device from a seed.

A flat baseline, a linear rise of ``rise`` samples from ``t0``, then an
exponential decay of ``tau`` samples, plus white noise: the repository's
HPGe pulse generator (``make_hpge_waveforms`` in ``tests/test_build_dsp.py``)
drawn with ``torch.Generator`` instead of numpy. Returns the ``waveform``
(float32, ``(n, samples)``) and ``baseline`` (float32, ``(n,)``) columns.
"""

import torch


def make(n: int, samples: int, params: dict, gen: torch.Generator,
         device) -> dict:
    f64 = torch.float64
    a_lo, a_hi = params["amplitude"]
    b_lo, b_hi = params["baseline"]
    amp = torch.rand(n, generator=gen, device=device, dtype=f64) * (a_hi - a_lo) + a_lo
    t0 = torch.randint(*params["t0"], (n,), generator=gen, device=device).to(f64)
    rt = torch.randint(*params["rise"], (n,), generator=gen, device=device).to(f64)
    bl = torch.rand(n, generator=gen, device=device, dtype=f64) * (b_hi - b_lo) + b_lo
    t = torch.arange(samples, device=device, dtype=f64)[None, :]
    t0, rt = t0[:, None], rt[:, None]
    rise = ((t - t0) / rt).clamp(0.0, 1.0)
    after = (t - t0 - rt).clamp(min=0.0)
    wf = bl[:, None] + amp[:, None] * rise * torch.exp(-after / params["tau"])
    wf += params["noise_sigma"] * torch.randn(n, samples, generator=gen, device=device,
                                              dtype=f64)
    return {"waveform": wf.to(torch.float32), "baseline": bl.to(torch.float32)}
