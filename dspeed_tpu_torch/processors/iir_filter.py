"""IIR filter design factories (reference ``dspeed/processors/iir_filter.py``;
JAX package ``dspeed_tpu/processors/iir_filter.py``).

Filter design runs on the host with :mod:`scipy.signal` once per
configuration (``init_args`` factories); the processor they return is the
recursive filter (:func:`.recursive_filter.recursive_filter_impl`).
"""

from __future__ import annotations

from typing import Collection

import numpy as np
import torch

from ..errors import DSPFatal
from ..units import Quantity
from ._kernel import Kernel

__all__ = ["iir_filter", "notch_filter", "peak_filter"]


def _f_samp_of(f_samp):
    # a chain variable carries its grid; 1/period is the sampling frequency
    if hasattr(f_samp, "grid") and hasattr(f_samp, "proc_chain"):
        return 1 / f_samp.grid.period
    return f_samp


def _ratio(f, f_samp):
    if f_samp is None:
        return float(f)
    v = 2 * f / f_samp
    return float(v) if isinstance(v, Quantity) else float(v)


def _make_filter_kernel(name: str, a: np.ndarray, b: np.ndarray,
                        init_out: str = "gain") -> Kernel:
    from .recursive_filter import recursive_filter_impl

    # initial output memory as the reference factories set it: the
    # DC-gain-scaled first sample (iir_filter.py:103), the first sample
    # (:161, notch) or zero (:219, peak)
    gain = float(np.sum(a) / np.sum(b))

    def fn(w_in):
        if init_out == "gain":
            iv = gain * w_in[..., 0]
        elif init_out == "first":
            iv = w_in[..., 0]
        else:
            iv = torch.zeros_like(w_in[..., 0])
        return recursive_filter_impl(w_in, a, b, w_in[..., 0], iv)

    return Kernel(fn, "(n)->(n)", ["f->f", "d->d"], name=name)


def iir_filter(freq, order: int, rp: float = None, rs: float = None,
               f_samp=None, ftype: str = "butter",
               btype: str = "lowpass") -> Kernel:
    """Design an IIR filter with :func:`scipy.signal.iirfilter` and return a
    processor applying it (reference ``iir_filter.py:18``)."""
    import scipy.signal as sg

    f_samp = _f_samp_of(f_samp)
    if btype in ("lowpass", "highpass"):
        if isinstance(freq, (list, tuple)):
            raise DSPFatal(f"{btype} filter requires one freq value")
        f_c = _ratio(freq, f_samp) if f_samp is not None else float(freq)
        if not 0 <= f_c <= 1:
            raise DSPFatal(
                "Critical frequency must be positive and < nyquist frequency"
            )
    elif btype in ("bandpass", "bandstop"):
        if not (isinstance(freq, Collection) and len(freq) == 2):
            raise DSPFatal(f"{btype} filter requires two freq values")
        f_c = [_ratio(f, f_samp) if f_samp is not None else float(f) for f in freq]
        if not all(0 <= f <= 1 for f in f_c):
            raise DSPFatal(
                "Critical frequency must be positive and < nyquist frequency"
            )
    else:
        raise DSPFatal("Invalid type of filter")
    a, b = sg.iirfilter(order, f_c, rp=rp, rs=rs, btype=btype, ftype=ftype)
    return _make_filter_kernel("iir_filter", a, b)


def _quality_filter(name, design, freq, bandwidth, f_samp, init_out) -> Kernel:
    f_samp = _f_samp_of(f_samp)
    f_c = _ratio(freq, f_samp) if f_samp is not None else float(freq)
    q = float(freq / bandwidth)
    if not 0 <= f_c <= 1:
        raise DSPFatal(
            "Critical frequency must be positive and < nyquist frequency"
        )
    a, b = design(f_c, q)
    return _make_filter_kernel(name, a, b, init_out=init_out)


def notch_filter(freq, bandwidth, f_samp=None) -> Kernel:
    """Design a notch filter with :func:`scipy.signal.iirnotch`; quality
    factor is ``freq/bandwidth`` (reference ``iir_filter.py:115``)."""
    import scipy.signal as sg

    return _quality_filter("notch_filter", sg.iirnotch, freq, bandwidth, f_samp,
                           "first")


def peak_filter(freq, bandwidth, f_samp=None) -> Kernel:
    """Design a peaking filter with :func:`scipy.signal.iirpeak`; quality
    factor is ``freq/bandwidth`` (reference ``iir_filter.py:173``)."""
    import scipy.signal as sg

    return _quality_filter("peak_filter", sg.iirpeak, freq, bandwidth, f_samp,
                           "zero")
