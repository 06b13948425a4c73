"""Fused multi-stage processors (the port of ``dspeed_tpu/processors/fused.py``).

The fusion pass substitutes these for their step patterns. On a CUDA tensor
each runs a hand-written kernel (:mod:`._cuda`); on a CPU tensor it runs the
kernel's plain version, which composes the unfused processor bodies exactly
as the JAX package's fallbacks do, so a fused chain on the CPU gives the
unfused chain's numbers.
"""

from __future__ import annotations

import numpy as np

from ..errors import DSPFatal
from ._cuda import _trap_tuple, banded_conv_multi, fused_energy
from ._helpers import nanmask, static_float, static_int
from ._kernel import Kernel, kernel

__all__ = ["fused_energy_filter", "fused_energy_front", "fused_conv_bank"]


def fused_conv_bank(kernels, lo: int, p: int, n_in: int | None = None) -> Kernel:
    """Factory: several constant-kernel convolutions of ONE input sharing a
    single window read (the CUSP + ZAC energy pair of the flagship chain;
    JAX package ``fused.py:30``). ``lo``/``p`` are the mode window into the
    full convolution; with ``n_in`` the convolutions read only
    ``w[..., :n_in]`` of a wider input, so the engine's ``var[0:n_in]`` view
    is never materialized. Returns a kernel ``(w,) -> (out_1, ..., out_k)``.

    CUDA: kernel K4 (``banded_conv_multi``) for the whole bank. CPU: one
    banded matrix product per kernel (``fused.py:83-86``).
    """
    kerns = [np.asarray(k) for k in kernels]
    if len(kerns) < 2:
        raise DSPFatal("fused_conv_bank needs at least two kernels")
    m = kerns[0].shape[-1]
    if any(k.ndim != 1 or k.shape[-1] != m for k in kerns):
        raise DSPFatal("fused_conv_bank kernels must be 1-D and same-length")
    kern_nan = [bool(np.isnan(k).any()) for k in kerns]
    lo = int(lo)
    p = int(p)
    nk = len(kerns)

    def fn(w_in, badrow=None):
        # rows are poisoned from the read window itself, which is exactly
        # the threaded bad-row mask wherever the engine hands one over
        outs = banded_conv_multi(w_in, kerns, lo, p, n_in=n_in)
        return tuple(
            nanmask(knan, o.to(w_in.dtype)) for o, knan in zip(outs, kern_nan)
        )

    sig = "(n)->" + ",".join(["(p)"] * nk)
    return Kernel(
        fn,
        sig,
        ["f->" + "f" * nk, "d->" + "d" * nk],
        name="fused_conv_bank",
        badrow_arg=0,
        mask_preserving=True,
    )


def fused_energy_front(
    tau, trap_specs, emax_for=(0,), emit_blsub=False, emit_minmax=False,
    slope_specs=(), mask_specs=(),
) -> Kernel:
    """Factory: one pass producing the pole-zero waveform, every trapezoid
    read off it, and the requested trapezoid maxima (JAX package
    ``fused.py:280``).

    ``trap_specs`` is a list of ``("norm", rise, flat)`` /
    ``("asym", rise, flat, fall)`` tuples; ``emax_for`` indexes the traps
    whose maxima are emitted. ``emit_blsub`` appends the
    baseline-subtracted waveform; ``emit_minmax`` absorbs the RAW waveform's
    ``min_max`` quadruple (masked by waveform NaN only); ``slope_specs`` —
    tuples ``(src, start, stop)`` with src 0 = blsub, 1 = pz — absorb
    ``linear_slope_fit`` steps over static slices; ``mask_specs`` —
    ``(trap spec, slope index, quadruple index, need_fwd, need_bwd)`` —
    emit uint8 threshold-crossing bitmasks of a trap against a slope output.
    Returns a kernel ``(w_in, a_baseline) -> (pz, trap_0, ...,
    trap_{k-1}, emax..., [mean, stdev, slope, intercept]*, [t_min, t_max,
    a_min, a_max], [blsub], [mask]*)``.

    CUDA: kernel K1 (``fused_energy``); CPU: its plain version.
    """
    tau = float(tau)
    specs = tuple(_trap_tuple(s) for s in trap_specs)
    k = len(specs)
    if k == 0:
        raise DSPFatal("fused_energy_front needs at least one trap spec")
    emax_for = tuple(int(i) for i in emax_for)
    if not emax_for or any(not (0 <= i < k) for i in emax_for):
        raise DSPFatal("emax_for must index trap_specs")
    slope_specs = tuple(
        (int(src), int(a0), int(b0)) for src, a0, b0 in slope_specs
    )
    if any(src not in (0, 1) or b0 <= a0 for src, a0, b0 in slope_specs):
        raise DSPFatal("slope_specs entries must be (0|1, start, stop)")
    norm_masks = []
    for sp, si, oi, ff, bb in mask_specs:
        if not (0 <= int(si) < len(slope_specs)) or not (0 <= int(oi) < 4):
            raise DSPFatal("mask_specs must index a slope output")
        norm_masks.append((_trap_tuple(sp), int(si), int(oi), bool(ff), bool(bb)))
    mask_specs = tuple(norm_masks)

    def fn(w_in, a_baseline):
        n = w_in.shape[-1]
        for s in specs:
            width = 2 * s[1] + s[2] if s[0] == "norm" else s[1] + s[2] + s[3]
            if width > n:
                raise DSPFatal("The trapezoid width is wider than the waveform")
        pz, traps, emaxes, *extras = fused_energy(
            w_in, a_baseline, tau, trap_specs=specs, emax_for=emax_for,
            emit_blsub=emit_blsub, emit_minmax=emit_minmax,
            slope_specs=slope_specs, mask_specs=mask_specs,
        )
        return (pz, *traps, *emaxes, *extras)

    sig = (
        "(n),()->(n),"
        + ",".join(["(n)"] * k)
        + "," + ",".join(["()"] * len(emax_for))
        + ",(),(),(),()" * len(slope_specs)
        + (",(),(),(),()" if emit_minmax else "")
        + (",(n)" if emit_blsub else "")
        + ",(n)" * len(mask_specs)
    )
    nouts = (
        k + 1 + len(emax_for) + 4 * len(slope_specs)
        + 4 * bool(emit_minmax) + bool(emit_blsub)
    )
    nm = len(mask_specs)
    types = [
        "ff->" + "f" * nouts + "B" * nm,
        "dd->" + "d" * nouts + "B" * nm,
    ]
    kern = Kernel(fn, sig, types, name="fused_energy_front")
    # the fusion matcher chains a second energy front off this one's
    # emitted wf_blsub; the NaN threading pass must not treat the absorbed
    # min_max outputs as poisoned-on-bad-rows (waveform-only mask), and the
    # trailing crossing-bitmask outputs are uint8 (never NaN)
    kern.emits_blsub = bool(emit_blsub)
    kern.emits_minmax = bool(emit_minmax)
    kern.n_mask_outputs = nm
    return kern


@kernel(
    "(n),(),(),(),()->(n),(n),()",
    ["fffff->fff", "ddddd->ddd"],
    static=[2, 3, 4],
)
def fused_energy_filter(w_in, a_baseline, t_tau, rise, flat):
    """bl_subtract + pole_zero(tau) + trap_norm(rise, flat) + amax in one
    pass: returns ``(wf_pz, wf_trap, trapEmax)`` (JAX package
    ``fused.py:487``)."""
    n = w_in.shape[-1]
    tau = static_float(t_tau, "fused_energy_filter", "t_tau")
    r = static_int(rise, "fused_energy_filter", "rise")
    f = static_int(flat, "fused_energy_filter", "flat")
    if 2 * r + f > n:
        raise DSPFatal("The trapezoid width is wider than the waveform")
    pz, traps, emaxes = fused_energy(
        w_in, a_baseline, tau, trap_specs=(("norm", r, f),), emax_for=(0,)
    )
    return pz, traps[0], emaxes[0]
