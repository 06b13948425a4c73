"""Waveform extremum statistics (reference ``dspeed/processors/min_max.py``)."""

from __future__ import annotations

import torch

from ._helpers import isnan_any, nanmask
from ._kernel import kernel

__all__ = ["min_max"]


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


# generic row-tile fusion (the JAX package's flags)
min_max.tile_safe = True
