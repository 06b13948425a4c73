"""Waveform windowing (reference ``dspeed/processors/windower.py:17``; JAX
package ``dspeed_tpu/processors/windower.py:43``).

The window is a per-row gather. The JAX package replaces it on the TPU by a
log-shift of static slices (``_window_rows``), because the TPU runs gathers
row by row; both the CPU and the card gather directly.
"""

from __future__ import annotations

import torch

from ..errors import DSPFatal
from ._helpers import as_tensor, isnan_any, nanmask
from ._kernel import kernel

__all__ = ["windower"]


@kernel("(n),(),(m)", ["fff", "ddd"], nout=1, uses_dims=True, badrow_arg=0)
def windower(w_in, t0_in, dims, badrow=None):
    """Window of length ``m`` starting at ``trunc(t0_in)``; slots outside the
    row are NaN, and a row with a NaN sample or a NaN start is all NaN. The
    output length comes from the declared output variable's shape."""
    n = w_in.shape[-1]
    m = dims["m"]
    if m >= n:
        raise DSPFatal(
            "The windowed waveform must be smaller than the input waveform"
        )
    t0 = as_tensor(t0_in, w_in).expand(w_in.shape[:-1])
    # trunc, then the JAX package's min(., n); clamping below at -(m + 1)
    # keeps the integer conversion defined and leaves every slot outside
    t = torch.nan_to_num(torch.trunc(t0), nan=0.0).clamp(-(m + 1), n)
    idx = t.to(torch.int64)[..., None] + torch.arange(m, device=w_in.device)
    valid = (idx >= 0) & (idx < n)
    out = torch.gather(
        w_in.expand(*idx.shape[:-1], n), -1, idx.clamp(0, n - 1)
    )
    out = torch.where(valid, out, torch.full((), float("nan"), dtype=w_in.dtype,
                                             device=w_in.device))
    # not mask_preserving: the edge NaN padding puts NaNs in rows the input
    # mask calls clean
    row = isnan_any(w_in, 1) if badrow is None else badrow
    return nanmask(row | isnan_any(t0), out)


# generic row-tile fusion (the JAX package's flags)
windower.tile_safe = True
