"""Kernel metadata wrapper for dspeed_tpu_torch processors.

The reference exposes its processors as numba ``guvectorize`` objects whose
``signature``/``types`` metadata drives the ProcessingChain's shape/dtype
resolution (``dspeed/processing_chain.py:1527-1543``). Here every processor is
a PyTorch function over *batched* tensors, wrapped in :class:`Kernel` which
carries the same metadata so the chain compiler can perform identical
broadcasting, type resolution and unit/grid deduction.

Kernel function convention
--------------------------
``fn(*params) -> output or tuple(outputs)`` where

- array params arrive as tensors with arbitrary leading batch dims,
  reshaped by the chain so that numpy broadcasting aligns core dims,
- scalar params that are chain constants arrive as python/numpy scalars
  (allowing build-time specialization, e.g. static slice bounds),
- kernels that need resolved output lengths (signatures without ``->``,
  like ``windower``'s ``(n),(),(m)``) declare ``uses_dims=True`` and receive
  a ``dims`` keyword mapping dim names to ints.

Kernels must implement the reference's NaN-poisoning convention: any NaN in
the per-event core input produces all-NaN outputs for that event.
"""

from __future__ import annotations

import re
from typing import Callable, Collection

import numpy as np

from ..errors import ProcessingChainError

__all__ = ["Kernel", "kernel", "parse_signature"]


def parse_signature(signature: str) -> tuple[list[list[str]], int, int]:
    """Parse a gufunc signature into per-param core-dim name lists.

    Returns ``(dims_list, nin, nout)``. Signatures without ``->`` (in-place
    output convention used by some reference processors, e.g. ``windower``
    ``(n),(),(m)``) report ``nout == 0`` here; the caller overrides ``nout``.
    """
    sig = signature.replace(" ", "")
    if "->" in sig:
        in_part, out_part = sig.split("->")
    else:
        in_part, out_part = sig, ""
    groups_in = re.findall(r"\((.*?)\)", in_part)
    groups_out = re.findall(r"\((.*?)\)", out_part)
    dims_list = [
        [d for d in g.split(",") if d] for g in groups_in + groups_out
    ]
    return dims_list, len(groups_in), len(groups_out)


class Kernel:
    """A batched PyTorch processor with gufunc-style metadata."""

    def __init__(
        self,
        fn: Callable,
        signature: str,
        types: str | Collection[str],
        name: str | None = None,
        nout: int | None = None,
        static: Collection[int] = (),
        uses_dims: bool = False,
        out_indices: Collection[int] | None = None,
        doc: str | None = None,
        badrow_arg: int | None = None,
        mask_preserving: bool = False,
    ) -> None:
        self.fn = fn
        self.signature = signature
        self.__name__ = name if name else getattr(fn, "__name__", "kernel")
        self.types = [types] if isinstance(types, str) else list(types)
        dims_list, nin, sig_nout = parse_signature(signature)
        if out_indices is not None:
            # explicit output positions (some reference gufuncs interleave
            # outputs mid-signature, e.g. histogram_stats)
            nout = len(out_indices)
            nin = len(dims_list) - nout
        else:
            if nout is None:
                nout = sig_nout
            if sig_nout == 0:
                # in-place convention: trailing params are outputs
                nin = len(dims_list) - nout
            out_indices = tuple(range(nin, nin + nout))
        if nout == 0:
            raise ProcessingChainError(
                f"kernel {self.__name__} must declare at least one output"
            )
        self.dims_list = dims_list
        self.nin = nin
        self.nout = nout
        self.nargs = nin + nout
        self.out_indices = tuple(out_indices)
        self.static = frozenset(static)
        self.uses_dims = uses_dims
        # NaN-mask threading metadata (ProcessingChain._thread_nan_masks):
        # `badrow_arg` names the input whose whole-row isnan reduction the
        # kernel can skip when the engine hands it a precomputed per-event
        # ``badrow`` mask (fn must accept a ``badrow=None`` keyword);
        # `mask_preserving` asserts the outputs' NaN rows are exactly the
        # poisoned input rows (plus NaN-free consts), so the mask flows on.
        self.badrow_arg = badrow_arg
        self.mask_preserving = mask_preserving
        self.__doc__ = doc if doc is not None else getattr(fn, "__doc__", None)

    def __call__(self, *inputs, dims: dict | None = None):
        """Invoke on batched inputs; returns a tuple of ``nout`` outputs."""
        if self.uses_dims:
            out = self.fn(*inputs, dims=dims)
        else:
            out = self.fn(*inputs)
        if not isinstance(out, tuple):
            out = (out,)
        if len(out) != self.nout:
            raise ProcessingChainError(
                f"kernel {self.__name__} returned {len(out)} outputs, "
                f"expected {self.nout}"
            )
        return out

    def __repr__(self) -> str:
        return f"Kernel({self.__name__}, {self.signature!r})"


def kernel(
    signature: str,
    types: str | Collection[str],
    nout: int | None = None,
    static: Collection[int] = (),
    uses_dims: bool = False,
    out_indices: Collection[int] | None = None,
    name: str | None = None,
    badrow_arg: int | None = None,
    mask_preserving: bool = False,
):
    """Decorator form of :class:`Kernel`."""

    def wrap(fn):
        return Kernel(
            fn,
            signature,
            types,
            name=name,
            nout=nout,
            static=static,
            uses_dims=uses_dims,
            out_indices=out_indices,
            badrow_arg=badrow_arg,
            mask_preserving=mask_preserving,
        )

    return wrap


def require_static(value, kernel_name: str, what: str):
    """Raise if a parameter the kernel needs at build time is per-event."""
    import torch

    if isinstance(value, torch.Tensor) and value.ndim > 0:
        raise ProcessingChainError(
            f"{kernel_name}: {what} must be a constant (static) value; got a "
            f"per-event value"
        )
    return value
