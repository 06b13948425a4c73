"""Exception types for dspeed_tpu_torch.

Mirrors the error taxonomy of the reference implementation
(``dspeed/errors.py:10-47``): a base :class:`DSPError`, a fatal
processor-level :class:`DSPFatal` that carries the processor string and the
entry range it was processing, and a chain-construction
:class:`ProcessingChainError`.
"""

from __future__ import annotations


class DSPError(Exception):
    """Base class for all dspeed_tpu_torch errors."""


class DSPFatal(DSPError):
    """Fatal error thrown by DSP processors that halts production.

    ``wf_range`` and ``processor`` are filled in after the exception is
    caught by the chain executor / bulk driver and appended to the message.
    """

    def __init__(self, *args) -> None:
        super().__init__(*args)
        self.wf_range: tuple[int, int] | None = None
        self.processor: str | None = None

    def __str__(self) -> str:
        msg = super().__str__()
        if self.wf_range is not None:
            msg += f"\nThrown while processing entries {self.wf_range}"
        if self.processor is not None:
            msg += f"\nThrown by {self.processor}"
        return msg


class ProcessingChainError(DSPError):
    """Error thrown when there is a problem setting up a processing chain."""


class LH5Error(DSPError):
    """Error thrown by the LH5 I/O layer."""
