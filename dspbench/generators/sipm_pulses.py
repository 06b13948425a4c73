"""Synthetic SiPM records, made on the device from a seed.

Unit white noise plus Poisson(``pulses_mean``) fast pulses an event, each
of amplitude U(``amplitude``) at a time U(``t0_margin``, samples -
``t0_margin``), rising with ``rise_tau`` and falling with ``fall_tau``
samples: the repository's SiPM generator (``bench.py``'s
``_build_sipm_inputs``) drawn with ``torch.Generator``. Returns the
``waveform`` column (float32, ``(n, samples)``).
"""

import torch


def make(n: int, samples: int, params: dict, gen: torch.Generator,
         device) -> dict:
    f64 = torch.float64
    t = torch.arange(samples, device=device, dtype=f64)[None, :]
    wf = params["noise_sigma"] * torch.randn(n, samples, generator=gen, device=device,
                                             dtype=f64)
    rate = torch.full((n,), params["pulses_mean"], device=device, dtype=f64)
    n_pulse = torch.poisson(rate, generator=gen)
    lo, hi = params["t0_margin"], samples - params["t0_margin"]
    a_lo, a_hi = params["amplitude"]
    # a fixed number of draws whatever the counts, so that every seed draws
    # the same amount from the generator
    for k in range(int(4 * params["pulses_mean"] + 8)):
        t0 = torch.rand(n, generator=gen, device=device, dtype=f64) * (hi - lo) + lo
        a = torch.rand(n, generator=gen, device=device, dtype=f64) * (a_hi - a_lo) + a_lo
        a = torch.where(n_pulse > k, a, torch.zeros_like(a))[:, None]
        d = t - t0[:, None]
        tau = torch.where(d > 0, params["fall_tau"], params["rise_tau"])
        wf += a * torch.exp(-d.abs() / tau)
    return {"waveform": wf.to(torch.float32)}
