"""User-facing utilities, mirroring the reference's ``dspeed/utils.py`` (JAX
package ``dspeed_tpu/utils.py``).

- :class:`GUFuncWrapper` / :func:`dspeed_guvectorize` wrap a callable over
  batched tensors as a chain processor with gufunc-style metadata
  (reference ``utils.py:12-171``): thin aliases over
  :class:`~dspeed_tpu_torch.processors.Kernel`.
- :class:`TpuDefaults` reads the JAX package's global flags from the same
  environment variables, the analog of the reference's ``NumbaDefaults``
  (``utils.py:187-248``); see its docstring for what each one maps to here.
- :class:`ProcChainVarBase` is the base class processors can use to
  type-check chain variables without importing the engine (reference
  ``utils.py:251``).
"""

from __future__ import annotations

import os
from typing import Callable, Collection

from .processors import Kernel

__all__ = [
    "GUFuncWrapper",
    "dspeed_guvectorize",
    "TpuDefaults",
    "tpu_defaults",
    "ProcChainVarBase",
]


class GUFuncWrapper(Kernel):
    """Make a callable over batched tensors look like a chain processor.

    Takes the reference's keywords; ``vectorized`` and ``copy_out`` mean
    nothing here (every processor takes whole batches and returns new
    tensors) and are accepted for compatibility.
    """

    def __init__(
        self,
        func: Callable,
        signature: str,
        types: str | Collection[str],
        name: str | None = None,
        vectorized: bool = True,  # noqa: ARG002 - API parity
        copy_out: bool = True,  # noqa: ARG002 - API parity
        doc_string: str | None = None,
        **kwargs,
    ) -> None:
        super().__init__(func, signature, types, name=name, doc=doc_string, **kwargs)


def dspeed_guvectorize(signature: str, types, **kwargs):
    """Decorator form of :class:`GUFuncWrapper` (reference
    ``utils.py:166-171``)."""

    def wrap(func):
        return GUFuncWrapper(func, signature, types, **kwargs)

    return wrap


_ACCUMULATIONS = ("auto", "f64")


class TpuDefaults:
    """Global flags from the environment (the ``NumbaDefaults`` analog),
    read from the JAX package's variables:

    - ``DSPEED_TPU_ACCUM``: the accumulation policy. The port accumulates its
      prefix sums and fit moments in float64 on the CPU and the card alike
      (:func:`dspeed_tpu_torch.config.accum_dtype`), which is the JAX
      package's ``"f64"`` and its ``"auto"`` under x64; :meth:`apply`
      accepts those two and raises ``ValueError`` for the TPU's compensated
      float32 policies (``"ds"``, ``"blocked"``) and ``"f32"``, which have no
      counterpart here.
    - ``DSPEED_TPU_X64``: enables ``jax_enable_x64`` in the JAX package. The
      port has no counterpart: PyTorch computes float64 wherever a
      processor's types ask for it. Read and kept; :meth:`apply` does
      nothing with it.
    - ``DSPEED_TPU_DEBUG_NANS``: ``jax_debug_nans`` in the JAX package. No
      counterpart yet (the port has no checked mode): read and kept;
      :meth:`apply` does nothing with it.
    """

    def __init__(self) -> None:
        self.accumulation = os.getenv("DSPEED_TPU_ACCUM", "auto")
        self.enable_x64 = os.getenv("DSPEED_TPU_X64", "0") not in ("0", "", "false")
        self.debug_nans = os.getenv("DSPEED_TPU_DEBUG_NANS", "0") not in (
            "0", "", "false",
        )

    def apply(self) -> None:
        """Check the accumulation policy against the port's (the other two
        flags have nothing to set here)."""
        if self.accumulation not in _ACCUMULATIONS:
            raise ValueError(
                f"DSPEED_TPU_ACCUM={self.accumulation!r}: the port accumulates in "
                f"float64 only (one of {_ACCUMULATIONS})"
            )


tpu_defaults = TpuDefaults()


class ProcChainVarBase:
    """Base class so that processors can type-check chain variables without
    importing the engine; :class:`~dspeed_tpu_torch.processing_chain.ProcChainVar`
    is the (duck-typed) implementation."""

    __slots__ = ()
