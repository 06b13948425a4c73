"""Logging helpers for dspeed_tpu_torch.

Mirrors the reference's single named-logger setup (``dspeed/logging.py:16-45``)
without the colorlog dependency: a console handler with a compact colored
formatter implemented with raw ANSI codes.
"""

from __future__ import annotations

import logging

DEFAULT = logging.INFO

_COLORS = {
    logging.DEBUG: "\x1b[36m",
    logging.INFO: "\x1b[32m",
    logging.WARNING: "\x1b[33m",
    logging.ERROR: "\x1b[31m",
    logging.CRITICAL: "\x1b[41m",
}
_RESET = "\x1b[0m"


class _ColorFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        color = _COLORS.get(record.levelno, "")
        prefix = f"{color}{record.levelname}{_RESET}" if color else record.levelname
        return f"{prefix}:{record.name}:{record.getMessage()}"


def setup(level: int = DEFAULT, logger: logging.Logger | None = None) -> None:
    """Set up a colored console handler on the ``dspeed_tpu_torch`` logger tree."""
    if logger is None:
        logger = logging.getLogger("dspeed_tpu_torch")
    handler = logging.StreamHandler()
    handler.setFormatter(_ColorFormatter())
    logger.addHandler(handler)
    logger.setLevel(level)
