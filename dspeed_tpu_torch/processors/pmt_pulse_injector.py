"""PMT pulse injection re-exports (reference
``dspeed/processors/pmt_pulse_injector.py``; JAX package
``dspeed_tpu/processors/pmt_pulse_injector.py``). The implementations live
with the other injectors in :mod:`.pulse_injector`."""

from .pulse_injector import inject_general_logistic, inject_gumbel

__all__ = ["inject_gumbel", "inject_general_logistic"]
