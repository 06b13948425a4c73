"""Wiener filter factory (reference ``dspeed/processors/wiener_filter.py:13``;
JAX package ``dspeed_tpu/processors/wiener_filter.py``).

Reads a superpulse and a noise waveform from an LH5 file (through the port's
own ``lh5``) when the chain is built, designs the filter in the frequency
domain on the host, and returns a processor that multiplies a Fourier-domain
waveform by it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..errors import DSPFatal
from ._kernel import Kernel

__all__ = ["wiener_filter"]


def wiener_filter(file_name_array) -> Kernel:
    from ..lh5 import read

    try:
        file_name = file_name_array[0] if isinstance(
            file_name_array, (list, tuple, np.ndarray)) else file_name_array
    except Exception:
        raise DSPFatal("init_args must be an array with the filename") from None
    try:
        superpulse = np.asarray(read("spms/processed/superpulse", file_name).nda)
        noise_wf = np.asarray(read("spms/processed/noise_wf", file_name).nda)
    except (OSError, KeyError) as e:
        raise DSPFatal(
            "File must be a valid lh5 file with spms/processed/superpulse "
            "and spms/processed/noise_wf"
        ) from e
    if len(superpulse) <= 0:
        raise DSPFatal("The length of the filter must be positive")
    if len(superpulse) != len(noise_wf):
        raise DSPFatal(
            "The length of the superpulse must be equal to the length of "
            "the noise waveform"
        )
    if np.argmax(superpulse) <= 0 or np.argmax(superpulse) > len(superpulse):
        raise DSPFatal(
            "The index of the maximum of the superpulse must occur within "
            "the waveform"
        )
    fft_sp = np.fft.fft(superpulse)
    fft_noise = np.fft.fft(noise_wf)
    # the point-spread function: the superpulse deconvolved with a delta at
    # its maximum
    delta = np.zeros_like(superpulse)
    delta[np.argmax(superpulse)] = np.amax(superpulse)
    fft_psf = fft_sp / np.fft.fft(delta)
    psd_noise = fft_noise * np.conj(fft_noise)
    psd_sp = fft_sp * np.conj(fft_sp)
    taps = np.conj(fft_psf) / (fft_psf * np.conj(fft_psf) + psd_noise / psd_sp)

    def fn(fft_w_in):
        if fft_w_in.shape[-1] != len(taps):
            raise DSPFatal("The filter is not the same length of the input waveform")
        t = torch.as_tensor(taps).to(fft_w_in.device, fft_w_in.dtype)
        bad = (torch.isnan(fft_w_in.real) | torch.isnan(fft_w_in.imag)).any(
            -1, keepdim=True)
        out = fft_w_in * t
        return torch.where(bad, torch.full((), complex("nan"), dtype=out.dtype,
                                           device=out.device), out)

    return Kernel(fn, "(n)->(n)", ["F->F", "D->D"], name="wiener_filter")
