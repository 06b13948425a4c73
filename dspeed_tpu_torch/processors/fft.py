"""Fourier-domain processors (reference ``dspeed/processors/fft.py``; JAX
package ``dspeed_tpu/processors/fft.py``).

Size contracts match the reference: ``fft`` gives ``n//2+1`` complex bins,
``ifft`` ``(m-1)*2`` real samples, ``psd`` the bins' power over ``n``. One
batched ``torch.fft`` call each, as the JAX package leaves its FFTs to XLA
(its ``_mmfft.py`` is a TPU matmul route, not a Pallas kernel).
"""

from __future__ import annotations

import torch

from ..errors import DSPFatal
from ._helpers import isnan_any, nanmask
from ._kernel import kernel

__all__ = ["fft", "ifft", "psd", "abs2norm"]


@kernel("(n),(m)", ["fF", "dD"], nout=1, uses_dims=True)
def fft(w_in, dims):
    """Real FFT; ``m`` must equal ``n//2+1`` (reference ``fft.py:17``)."""
    n = w_in.shape[-1]
    if dims["m"] != n // 2 + 1:
        raise DSPFatal(f"Size of fft must be len(w_in)//2+1 = {n // 2 + 1}")
    return nanmask(isnan_any(w_in, 1), torch.fft.rfft(w_in, dim=-1))


@kernel("(n),(m)", ["Ff", "Dd"], nout=1, uses_dims=True)
def ifft(dft_in, dims):
    """Inverse real FFT; ``m`` must equal ``(n-1)*2`` (reference
    ``fft.py:54``)."""
    n = dft_in.shape[-1]
    m = dims["m"]
    if m != (n - 1) * 2:
        raise DSPFatal(f"Size of wf must be (len(dft_in)-1)*2 = {(n - 1) * 2}")
    bad = (torch.isnan(dft_in.real) | torch.isnan(dft_in.imag)).any(-1)
    return nanmask(bad, torch.fft.irfft(dft_in, n=m, dim=-1))


@kernel("(n),(m)", ["ff", "dd"], nout=1, uses_dims=True)
def psd(w_in, dims):
    """Power spectral density ``|rfft|^2 / n``; ``m == n//2+1`` (reference
    ``fft.py:97`` via ``abs2norm`` ``fft.py:87``)."""
    n = w_in.shape[-1]
    if dims["m"] != n // 2 + 1:
        raise DSPFatal(f"Size of psd must be len(w_in)//2+1 = {n // 2 + 1}")
    spec = torch.fft.rfft(w_in, dim=-1)
    out = (spec.real**2 + spec.imag**2) / n
    return nanmask(isnan_any(w_in, 1), out.to(w_in.dtype))


@kernel("(),()->()", ["FI->d", "DI->d"])
def abs2norm(x, norm):
    """``|x|^2 / norm`` of a complex value (reference ``fft.py:87``)."""
    x = torch.as_tensor(x)
    return (x.real**2 + x.imag**2) / norm
