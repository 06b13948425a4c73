"""Waveform convolutions (reference ``dspeed/processors/convolutions.py``).

The reference loops ``np.convolve`` per event (:24 ``convolve_wf``) or calls
scipy ``fftconvolve`` over the batch (:81 ``fft_convolve_wf``). Here both
are batched and routed like the JAX package routes them
(``dspeed_tpu/processors/convolutions.py:280-312``):

- ``m <= 32`` taps: direct shifted adds in plain PyTorch;
- a constant NaN-free kernel with ``p*m <= 16e6`` (outputs x taps per
  event): the banded route, ``full_conv(w, k)[lo:lo+p]`` computed only over
  the mode window. For float32 data this is the hand-written CUDA kernel
  ``banded_conv_multi`` on the card (its plain version on the CPU); float64
  data takes the plain banded matrix product in float64;
- otherwise a batched real FFT (``torch.fft``).

All produce the shapes and modes of ``numpy.convolve``.

:func:`reflected_convolve_wf` (reference :132, JAX package :483) pads each
row with numpy's ``'reflect'`` rule and keeps the ``'same'`` window: the
direct shifted adds for ``m <= 32`` taps, else the FFT, as in the JAX
package. In a generic fusion group it is K7's ``reflected_conv`` op.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..errors import DSPFatal
from ._helpers import any_bad, as_tensor, isnan_any, nanmask, static_int
from ._kernel import kernel

__all__ = ["convolve_wf", "fft_convolve_wf", "reflected_convolve_wf"]

# largest p*m (outputs x taps, per event) routed to the banded route; above
# this the FFT has fewer operations
_MATMUL_MAC_LIMIT = 16_000_000


def _mode_char(mode_in, name):
    mode = static_int(mode_in, name, "mode_in")
    ch = chr(mode)
    if ch not in ("f", "v", "s"):
        raise DSPFatal("Invalid mode")
    return ch


def _mode_window(ch, n, m):
    """(lo, p): the slice of the full convolution a numpy mode keeps."""
    if ch == "f":
        return 0, n + m - 1
    if ch == "v":
        return min(n, m) - 1, abs(n - m) + 1
    return (min(n, m) - 1) // 2, max(n, m)


def _conv_full_direct(w, kern):
    """Full convolution of batched ``w`` with a shared 1-D kernel as ``m``
    shifted multiply-adds (short kernels)."""
    n = w.shape[-1]
    m = kern.shape[-1]
    nf = n + m - 1
    wp = F.pad(w, (m - 1, m - 1))
    kc = as_tensor(kern, w, w.dtype)
    out = kc[m - 1] * wp[..., :nf]
    for k in range(m - 2, -1, -1):
        s = m - 1 - k
        out = out + kc[k] * wp[..., s : s + nf]
    return out


def _conv_full_fft(w, kern):
    """Full convolution via batched real FFT (scipy.fftconvolve semantics)."""
    n = w.shape[-1]
    m = kern.shape[-1]
    size = n + m - 1
    fsize = 1 << (size - 1).bit_length()
    kc = as_tensor(kern, w, w.dtype)
    wf = torch.fft.rfft(w, fsize, dim=-1)
    kf = torch.fft.rfft(kc, fsize, dim=-1)
    return torch.fft.irfft(wf * kf, fsize, dim=-1)[..., :size].to(w.dtype)


def _slice_mode(full, n, m, ch):
    lo, p = _mode_window(ch, n, m)
    return full[..., lo : lo + p]


def _band_matrix(kerns, blk):
    """The shared per-block band matrix ``A[s, j*blk+i] = k_j[i + m-1 - s]``
    for same-length kernels ``k_j``: ``(span, nk*blk)`` float64, where
    ``span = blk + m - 1`` is the input span of one output block."""
    m = int(kerns[0].shape[-1])
    span = blk + m - 1
    s_idx = np.arange(span)[:, None]
    i_idx = np.arange(blk)[None, :]
    j = i_idx + (m - 1) - s_idx
    valid = (j >= 0) & (j < m)
    jc = np.clip(j, 0, m - 1)
    return np.concatenate(
        [
            np.where(valid, np.asarray(k, dtype=np.float64)[jc], 0.0)
            for k in kerns
        ],
        axis=1,
    )


def _conv_banded_matmul(w, kern, lo, p, blk=512):
    """``full_conv(w, kern)[..., lo:lo+p]`` as banded matrix products.

    The mode window of a valid/same convolution is a band of the Toeplitz
    operator: output block ``k`` (``blk`` samples) reads the input span
    ``[lo - (m-1) + k*blk, lo + (k+1)*blk)`` and multiplies it by one shared
    ``(blk + m - 1, blk)`` matrix — the JAX package's XLA route
    (``dspeed_tpu/processors/convolutions.py:158``).
    """
    m = int(kern.shape[-1])
    n = w.shape[-1]
    blk = min(blk, p)
    nblk = -(-p // blk)
    p_pad = nblk * blk
    span = blk + m - 1
    A = torch.from_numpy(_band_matrix([kern], blk)).to(w.device, w.dtype)
    pad_l = max(0, m - 1 - lo)
    pad_r = max(0, lo + p_pad - n)
    wp = F.pad(w, (pad_l, pad_r))
    base = lo - (m - 1) + pad_l
    wins = wp[..., base : base + (nblk - 1) * blk + span].unfold(-1, span, blk)
    out = torch.matmul(wins, A)  # (..., nblk, blk)
    return out.reshape(*out.shape[:-2], p_pad)[..., :p]


def _convolve_mode(w, kern, ch, n, m):
    """Route a mode-sliced convolution (see the module docstring).

    Returns ``(out, poisoned)``: ``poisoned`` is True when the route already
    NaN-poisoned bad rows."""
    lo, p = _mode_window(ch, n, m)
    if m <= 32 and kern.ndim == 1:
        return _slice_mode(_conv_full_direct(w, kern), n, m, ch), False
    if (
        isinstance(kern, np.ndarray)
        and kern.ndim == 1
        and p * m <= _MATMUL_MAC_LIMIT
        and not np.isnan(kern).any()
    ):
        if w.dtype == torch.float32:
            from ._cuda import banded_conv_multi

            return banded_conv_multi(w, [kern], lo, p)[0], True
        return _conv_banded_matmul(w, kern, lo, p), False
    return _slice_mode(_conv_full_fft(w, kern), n, m, ch), False


def _kernel_array(kernel_in):
    """Config-constant kernels stay numpy (the banded route builds its band
    from them on the host); per-chain kernel variables arrive as tensors."""
    if isinstance(kernel_in, (np.ndarray, torch.Tensor)):
        return kernel_in
    return np.asarray(kernel_in)


def _conv(w_in, kernel_in, mode_in, name, badrow):
    kern = _kernel_array(kernel_in)
    if kern.ndim > 1:
        raise DSPFatal(f"{name} expects a shared 1-D kernel")
    n = w_in.shape[-1]
    m = kern.shape[-1]
    if m > n:
        raise DSPFatal("The filter is longer than the input waveform")
    ch = _mode_char(mode_in, name)
    out, poisoned = _convolve_mode(w_in, kern, ch, n, m)
    out = out.to(w_in.dtype)
    if poisoned:
        return out
    knan = (
        bool(np.isnan(kern).any())
        if isinstance(kern, np.ndarray)
        else torch.isnan(kern).any()
    )
    row = isnan_any(w_in, 1) if badrow is None else badrow
    return nanmask(any_bad(row, knan), out)


@kernel(
    "(n),(m),(),(p)", ["ffbf", "ddbd"], nout=1, static=[2], uses_dims=True,
    badrow_arg=0, mask_preserving=True,
)
def convolve_wf(w_in, kernel_in, mode_in, dims, badrow=None):
    """Direct convolution with modes f/v/s (reference ``convolutions.py:24``)."""
    n = w_in.shape[-1]
    m = _kernel_array(kernel_in).shape[-1]
    ch = _mode_char(mode_in, "convolve_wf")
    expect = {"f": n + m - 1, "v": abs(n - m) + 1, "s": max(n, m)}[ch]
    if dims["p"] != expect:
        raise DSPFatal(f"Output waveform has length {dims['p']}; expect {expect}")
    return _conv(w_in, kernel_in, mode_in, "convolve_wf", badrow)


@kernel(
    "(n),(m),(),(p)", ["ffbf", "ddbd"], nout=1, static=[2], uses_dims=True,
    badrow_arg=0, mask_preserving=True,
)
def fft_convolve_wf(w_in, kernel_in, mode_in, dims, badrow=None):
    """FFT convolution with modes f/v/s (reference ``convolutions.py:81``).

    NaN events poison their output rows.
    """
    return _conv(w_in, kernel_in, mode_in, "fft_convolve_wf", badrow)


@kernel(
    "(n),(m),(p)", ["fff", "ddd"], nout=1, uses_dims=True,
    badrow_arg=0, mask_preserving=True,
)
def reflected_convolve_wf(w_in, kernel_in, dims, badrow=None):
    """Reflect-pad by ``m // 2 + 1`` samples, convolve and keep the
    ``'same'`` window of the row (reference ``convolutions.py:132``)."""
    kern = _kernel_array(kernel_in)
    if kern.ndim > 1:
        raise DSPFatal("reflected_convolve_wf expects a shared 1-D kernel")
    n = w_in.shape[-1]
    m = kern.shape[-1]
    if m > n:
        raise DSPFatal("The filter is longer than the input waveform")
    ext = int(m / 2) + 1
    # numpy's 'reflect' pad as a gather (the edge sample is not repeated)
    idx = np.pad(np.arange(n), ext, mode="reflect")
    wpad = w_in[..., torch.from_numpy(idx).to(w_in.device)]
    if m <= 32:
        full = _conv_full_direct(wpad, kern)
    else:
        full = _conv_full_fft(wpad, kern)
    same = _slice_mode(full, n + 2 * ext, m, "s")
    out = same[..., ext:-ext].to(w_in.dtype)
    return nanmask(isnan_any(w_in, 1) if badrow is None else badrow, out)


# band-matrix budget of the JAX package's in-tile route
# (``dspeed_tpu/processors/convolutions.py:158``): it decides which
# convolutions join a generic row-tile group
_TILE_BAND_BYTES = 1_200_000


def _tile_blk(m: int, p: int) -> int | None:
    """The JAX package's in-tile output-block width
    (``dspeed_tpu/processors/convolutions.py:161``): the largest whose band
    matrix fits ``_TILE_BAND_BYTES``; ``None`` when even 64 columns don't."""
    for blk in (512, 384, 256, 192, 128, 96, 64):
        if blk <= p or blk == 64:
            if (min(blk, p) + m - 1) * min(blk, p) * 4 <= _TILE_BAND_BYTES:
                return min(blk, p)
    return None


def _conv_step_taps(step, ik: int):
    """The concrete taps array of a conv step's kernel operand, or None."""
    p = step.params[ik] if len(step.params) > ik else None
    if isinstance(p, np.ndarray):
        return p
    v = getattr(p, "const_value", None)
    if v is not None and getattr(p, "is_const", False):
        return np.asarray(v)
    return None


def _conv_tile_safe(step):
    """Generic row-tile fusion: the JAX package's predicate
    (``dspeed_tpu/processors/convolutions.py:431-472``), a TPU heuristic
    kept as it is so that both packages form the same groups. Constant
    NaN-free 1-D taps of the direct (``m <= 32``) or banded route join a
    group; FFT routes, per-event kernels and long taps whose in-tile band
    block would shrink below 256 columns (the CUSP/ZAC filters) stay out."""
    kern = _conv_step_taps(step, 1)
    if kern is None or kern.ndim != 1 or np.isnan(kern).any():
        return False
    m = kern.shape[-1]
    if m <= 32:
        return True
    wvar = step.params[0]
    shape = getattr(wvar, "shape", None)
    if not shape or not isinstance(shape[-1], (int, np.integer)):
        return False
    n = int(shape[-1])
    mode = step.params[2] if len(step.params) > 2 else ord("s")
    if isinstance(mode, str):
        ch = mode.strip("'\"")
    else:
        try:
            ch = chr(int(mode))
        except (TypeError, ValueError):
            return False
    if ch not in ("f", "v", "s"):
        return False
    _, p = _mode_window(ch, n, m)
    if p * m > _MATMUL_MAC_LIMIT:
        return False
    blk = _tile_blk(m, p)
    return blk is not None and blk >= min(256, p)


convolve_wf.tile_safe = _conv_tile_safe
fft_convolve_wf.tile_safe = _conv_tile_safe


def _reflected_tile_safe(step):
    """The JAX package's predicate (``convolutions.py:514``): constant
    NaN-free 1-D taps of the direct route (``m <= 32``)."""
    kern = _conv_step_taps(step, 1)
    return (
        kern is not None
        and kern.ndim == 1
        and kern.shape[-1] <= 32
        and not np.isnan(kern).any()
    )


reflected_convolve_wf.tile_safe = _reflected_tile_safe
