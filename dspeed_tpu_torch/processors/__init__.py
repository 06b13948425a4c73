"""DSP processor library of the PyTorch port.

Every processor is a :class:`~._kernel.Kernel`: a batched PyTorch function
plus gufunc-style ``signature``/``types`` metadata that drives the chain
compiler's shape/dtype/unit resolution — the contract of the JAX package's
registry (``dspeed_tpu/processors/__init__.py``), whose names are kept. Only
the processors ported so far are registered; the rest are queued in ROADMAP.

Processors are imported lazily on attribute access.
"""

from __future__ import annotations

import importlib
import sys as _sys
from types import ModuleType as _ModuleType
from typing import Any

from ._kernel import Kernel, kernel, parse_signature

_modules = {
    # kernel name -> module
    "bl_subtract": "bl_subtract",
    "pole_zero": "pole_zero",
    "fused_energy_filter": "fused",
    "fused_energy_front": "fused",
    "fused_conv_bank": "fused",
    "fused_t0_front": "fused",
    "fused_current_front": "fused",
    "windower": "windower",
    "moving_window_left": "moving_windows",
    "moving_window_right": "moving_windows",
    "moving_window_multi": "moving_windows",
    "avg_current": "moving_windows",
    "upsampler": "upsampler",
    "t0_filter": "kernels",
    "moving_slope": "kernels",
    "step": "kernels",
    "time_point_thresh": "time_point_thresh",
    "tp_from_cross_mask": "time_point_thresh",
    "chained_time_point_thresh": "tp_chain",
    "trap_filter": "trap_filters",
    "trap_norm": "trap_filters",
    "asym_trap_filter": "trap_filters",
    "min_max": "min_max",
    "linear_slope_fit": "linear_slope_fit",
    "fixed_time_pickoff": "fixed_time_pickoff",
    "where": "where",
    "round_to_nearest": "round_to_nearest",
    "floor_to_nearest": "round_to_nearest",
    "ceil_to_nearest": "round_to_nearest",
    "trunc_to_nearest": "round_to_nearest",
    "convert": "unit_conversion",
    "convert_int": "unit_conversion",
    "convert_round": "unit_conversion",
    "convert_floor": "unit_conversion",
    "convert_ceil": "unit_conversion",
    "convert_trunc": "unit_conversion",
    "cusp_filter": "energy_kernels",
    "zac_filter": "energy_kernels",
    "convolve_wf": "convolutions",
    "fft_convolve_wf": "convolutions",
    "reflected_convolve_wf": "convolutions",
    "gaussian_filter1d": "gaussian_filter1d",
    "histogram": "histogram",
    "histogram_around_mode": "histogram",
    "histogram_stats": "histogram_stats",
    "histogram_peakstats": "histogram_stats",
    "get_multi_local_extrema": "peak_finding",
    "peak_snr_threshold": "peak_finding",
    "remove_duplicates": "peak_finding",
    "multi_t_filter": "peak_finding",
    "multi_a_filter": "peak_finding",
}

__all__ = ["Kernel", "kernel", "parse_signature", *sorted(set(_modules))]


def __getattr__(name: str) -> Any:
    try:
        module = _modules[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}") from None
    mod = importlib.import_module(f".{module}", __name__)
    val = getattr(mod, name)
    globals()[name] = val  # cache
    return val


def __dir__():
    return __all__


class _ProcessorsModule(_sys.modules[__name__].__class__):
    """Keeps registry names resolving to kernels even when a same-named
    submodule import rebinds the package attribute (``pole_zero``,
    ``min_max`` and others share their module's name)."""

    def __getattribute__(self, name: str) -> Any:
        if name in _modules:
            val = object.__getattribute__(self, "__dict__").get(name)
            if val is None or isinstance(val, _ModuleType):
                mod = importlib.import_module(f".{_modules[name]}", __name__)
                val = getattr(mod, name)
            return val
        return super().__getattribute__(name)


_sys.modules[__name__].__class__ = _ProcessorsModule
