"""Waveform extremum statistics (reference ``dspeed/processors/min_max.py``)."""

from __future__ import annotations

import torch

from ._helpers import as_tensor, cdim, isnan_any, nanmask
from ._kernel import kernel

__all__ = ["min_max", "min_max_norm"]


@kernel(
    "(n)->(),(),(),()", ["f->ffff", "d->dddd"],
    badrow_arg=0, mask_preserving=True,
)
def min_max(w_in, badrow=None):
    """First-occurrence argmin/argmax and min/max values
    (reference ``min_max.py:19``). Outputs ``(t_min, t_max, a_min, a_max)``."""
    a_min, t_min = torch.min(w_in, dim=-1)
    a_max, t_max = torch.max(w_in, dim=-1)
    # torch.min/max with dim do not promise the first of tied extrema;
    # re-derive the indices as the first sample equal to the extremum
    n = w_in.shape[-1]
    idx = torch.arange(n, device=w_in.device)
    t_min = torch.where(w_in == a_min[..., None], idx, n).amin(dim=-1)
    t_max = torch.where(w_in == a_max[..., None], idx, n).amin(dim=-1)
    dtype = w_in.dtype
    bad = isnan_any(w_in, 1) if badrow is None else badrow
    return (
        nanmask(bad, t_min.to(dtype)),
        nanmask(bad, t_max.to(dtype)),
        nanmask(bad, a_min.to(dtype)),
        nanmask(bad, a_max.to(dtype)),
    )


@kernel("(n),(),()->(n)", ["fff->f", "ddd->d"])
def min_max_norm(w_in, a_min, a_max):
    """Normalize by ``max(|a_min|, |a_max|)`` unless either is zero
    (reference ``min_max.py:93``)."""
    amin = torch.abs(as_tensor(a_min, w_in))
    amax = torch.abs(as_tensor(a_max, w_in))
    denom = torch.where(amax >= amin, amax, amin)
    either_zero = (amax == 0) | (amin == 0)
    denom = torch.where(denom == 0, torch.ones_like(denom), denom).to(w_in.dtype)
    out = torch.where(cdim(either_zero), w_in, w_in / cdim(denom))
    return nanmask(isnan_any(w_in, 1), out)


# generic row-tile fusion (the JAX package's flags)
min_max.tile_safe = True
min_max_norm.tile_safe = True
