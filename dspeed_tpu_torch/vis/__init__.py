"""Waveform visualization for dspeed_tpu_torch (the JAX package's
``dspeed_tpu.vis``). Importing it does not import matplotlib: only drawing
does."""

from .waveform_browser import WaveformBrowser

__all__ = ["WaveformBrowser"]
