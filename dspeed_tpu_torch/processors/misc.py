"""Small utility processors (JAX package ``dspeed_tpu/processors/misc.py``).

Reference semantics: ``time_over_threshold.py:16``, ``saturation.py:20``,
``presum.py:20``, ``pad.py:20``, ``log_check.py:16``, ``sort.py:14``.
"""

from __future__ import annotations

import torch

from ..errors import DSPFatal
from ._helpers import any_bad, as_tensor, cdim, isnan_any, nanmask, static_int
from ._kernel import kernel

__all__ = [
    "time_over_threshold",
    "saturation",
    "presum",
    "pad",
    "log_check",
    "sort",
]


@kernel("(n),()->()", ["ff->f", "dd->d"])
def time_over_threshold(w_in, a_threshold):
    """Count of samples strictly above the threshold."""
    thr = cdim(as_tensor(a_threshold, w_in, w_in.dtype))
    n = (w_in > thr).sum(dim=-1).to(w_in.dtype)
    return nanmask(any_bad(isnan_any(w_in, 1), isnan_any(a_threshold)), n)


@kernel("(n),()->(),()", ["ff->ff", "dd->dd"])
def saturation(w_in, bit_depth_in):
    """Counts of samples at the ADC rails: the low rail is 0, the high rail
    ``2**bit_depth - bit_depth`` (reference ``saturation.py:82``)."""
    bd = static_int(bit_depth_in, "saturation", "bit_depth_in")
    if bd != float(bit_depth_in):
        raise DSPFatal("The bit depth is not an integer")
    if bd <= 0:
        raise DSPFatal("The bit depth is not positive")
    hi_rail = 2**bd - bd
    n_lo = (w_in == 0).sum(dim=-1).to(w_in.dtype)
    n_hi = (w_in == hi_rail).sum(dim=-1).to(w_in.dtype)
    bad = isnan_any(w_in, 1)
    return nanmask(bad, n_lo), nanmask(bad, n_hi)


@kernel("(n),(),(),(m)", ["ffff", "dddd"], nout=2, uses_dims=True)
def presum(w_in, do_norm, dims):
    """Downsample by block sums; outputs ``(ps_fact, w_out)``.

    The reference's argument order is ``(w_in, do_norm, ps_fact_out,
    w_out)``, ``ps_fact`` an output reporting ``len(w_in)//len(w_out)``.
    """
    dn = static_int(do_norm, "presum", "do_norm")
    if dn not in (0, 1):
        raise DSPFatal("do_norm type not found.")
    return _presum(w_in, dn, dims["m"], lambda wt: wt.sum(dim=-1))


def presum_k7(w_in, do_norm, dims, f64=False):
    """:func:`presum` as K7's op computes it (the tape's plain walk): each
    output's samples added in turn to 0.0 in the row's type, float32 or
    (``f64``, a float64 program's row) float64."""

    def total(wt):
        out = torch.zeros(wt.shape[:-1], dtype=wt.dtype, device=wt.device)
        for j in range(wt.shape[-1]):
            out = out + wt[..., j]
        return out

    return _presum(w_in, static_int(do_norm, "presum", "do_norm"), dims["m"], total)


def _presum(w_in, dn, m, total):
    """``presum``'s outputs, ``total`` summing each block of samples."""
    n = w_in.shape[-1]
    fact = n // m
    wt = w_in[..., : m * fact].reshape(*w_in.shape[:-1], m, fact)
    if dn == 1:
        # the reference divides each addend by the factor before summing
        wt = wt / torch.full((), fact, dtype=w_in.dtype, device=w_in.device)
    out = total(wt)
    bad = isnan_any(w_in, 1)
    ps_fact = torch.full(w_in.shape[:-1], float(fact), dtype=w_in.dtype,
                         device=w_in.device)
    return nanmask(bad, ps_fact), nanmask(bad, out.to(w_in.dtype))


@kernel("(n),(),(),(),(),(m)", ["flffff", "dldddd"], nout=1, uses_dims=True)
def pad(w_in, len_in, offset, start_val, end_val, dims):
    """Pad a variable-length vector into a fixed-length buffer
    (reference ``pad.py:20``)."""
    n = w_in.shape[-1]
    m = dims["m"]
    dev, dtype = w_in.device, w_in.dtype
    lead = w_in.shape[:-1]
    pos = torch.arange(m, device=dev)
    li = torch.as_tensor(len_in, device=dev).to(torch.int32).expand(lead)
    off = torch.as_tensor(offset, device=dev)
    off = (off if off.is_floating_point() else off.to(torch.float64)).expand(lead)
    i_beg = torch.trunc(off).to(torch.int32)
    src = pos - i_beg[..., None]
    in_body = (src >= 0) & (src < li[..., None]) & (src < n)
    gathered = torch.gather(w_in, -1, src.clamp(0, n - 1).long())
    sv = cdim(as_tensor(start_val, w_in, dtype))
    ev = cdim(as_tensor(end_val, w_in, dtype))
    out = torch.where(pos < i_beg[..., None], sv, ev).expand(*lead, m)
    out = torch.where(in_body, gathered, out).to(dtype)

    # NaN checks apply only to the occupied part of the input
    occupied = torch.arange(n, device=dev) < li[..., None]
    bad_in = (torch.isnan(w_in) & occupied).any(dim=-1)
    non_int = torch.trunc(off) != off
    too_long = li > n
    bad = bad_in | torch.isnan(off) | non_int | too_long
    return nanmask(bad, out)


@kernel("(n)->(n)", ["f->f", "d->d"])
def log_check(w_in):
    """log(w) if strictly positive everywhere, else all-NaN. The log is
    taken in float64 and rounded once to the row's type, as the engine's
    widened ufuncs take it (``processing_chain._WIDENED_UFUNCS``), so the
    card, the CPU and K7's ``log_check`` op give the same bits."""
    any_nonpos = (w_in <= 0).any(dim=-1)
    safe = torch.where(w_in <= 0, torch.ones((), dtype=w_in.dtype,
                                              device=w_in.device), w_in)
    out = torch.log(safe.to(torch.float64)).to(w_in.dtype)
    return nanmask(isnan_any(w_in, 1) | any_nonpos, out)


@kernel("(n)->(n)", ["f->f", "d->d"])
def sort(w_in):
    """Per-event ascending sort."""
    return nanmask(isnan_any(w_in, 1), torch.sort(w_in, dim=-1).values)


# generic row-tile fusion (the JAX package's flags; sort and pad gather per
# row and are left out)
time_over_threshold.tile_safe = True
saturation.tile_safe = True
presum.tile_safe = True
# the tape's plain walk runs K7's order (_cuda.generic_rows_plain)
presum.k7_plain = presum_k7
log_check.tile_safe = True
