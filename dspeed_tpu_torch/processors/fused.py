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
from ._cuda import (
    _trap_tuple,
    banded_conv_multi,
    fused_current,
    fused_energy,
    fused_t0,
)
from ._helpers import nanmask, static_float, static_int
from ._kernel import Kernel, kernel

__all__ = [
    "fused_energy_filter",
    "fused_energy_front",
    "fused_conv_bank",
    "fused_current_front",
    "fused_t0_front",
]


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


def fused_current_front(
    n_up: int, ratio: int, length: int, num_mw: int, mw_type: int,
    need: tuple = (True,) * 4,
) -> Kernel:
    """Factory: the A/E current branch — ``upsampler(ratio)`` ->
    ``moving_window_multi(length, num_mw, mw_type)`` -> ``min_max`` — as one
    pass (JAX package ``fused.py:104``). Returns a kernel ``(curr,) ->
    (t_min, t_max, a_min, a_max)``; the upsampled rows are never written
    out. ``need`` flags the outputs anything reads (the fusion pass clears
    those without readers): an extremum neither of whose outputs is needed
    is not reduced on the card, and an output nothing needs holds 0 there.

    Requires an integer ``ratio`` whose replication map writes every output
    slot (``ratio // 2 + n_up <= n * ratio``) and ``length <= 128``.

    CUDA: kernel K5, or K6 where the polyphase plan does not hold
    (:func:`._cuda.fused_current`); CPU: the plain composition, which gives
    the unfused steps' numbers.
    """
    n_up = int(n_up)
    ratio = int(ratio)
    length = int(length)
    num_mw = int(num_mw)
    mw_type = int(mw_type)
    half = ratio // 2
    if length > 128:
        raise DSPFatal("fused_current_front requires length <= 128")
    if mw_type not in (0, 1, 2):
        raise DSPFatal("Invalid mw_type")
    need = tuple(bool(x) for x in need)
    if len(need) != 4:
        raise DSPFatal("need must have four entries")

    def fn(c_in):
        n = c_in.shape[-1]
        if not (0 <= length < n_up):
            raise DSPFatal("The length of the moving window is out of range")
        if half + n_up > n * ratio:
            raise DSPFatal(
                "fused_current_front requires an all-valid upsample map"
            )
        # the kernels and the plain composition poison NaN rows themselves
        outs = fused_current(
            c_in, ratio, half, n_up, length, num_mw, mw_type, need=need
        )
        return tuple(o.to(c_in.dtype) for o in outs)

    return Kernel(
        fn,
        "(n)->(),(),(),()",
        ["f->ffff", "d->dddd"],
        name="fused_current_front",
    )


def fused_t0_front(
    kernel_arr, curr_spec=None, atrap_spec=None, need: tuple = (True,) * 4
) -> Kernel:
    """Factory: the t0/pileup branch — ``convolve_wf(w, kern, 's')`` ->
    ``min_max`` -> ``time_point_thresh(conv, a_std, tp_start, 0)`` — as one
    pass (JAX package ``fused.py:178``). Returns a kernel ``(w, a_std) ->
    (t_min, t_max, a_min, a_max, tp_0)``; the filtered waveform is never
    written out. With ``curr_spec = (win_m, avg_len, n_curr)`` the A/E
    current ``avg_current(windower(w, tp_0, win_m), avg_len)`` is absorbed
    as a sixth output of ``n_curr`` samples, so ``w`` is not read again for
    the window and the window itself never exists. With ``atrap_spec`` (a
    ``("norm", rise, flat)`` / ``("asym", rise, flat, fall)`` trap tuple)
    the trapezoid of ``w`` and its backward search
    ``time_point_thresh(trap(w), a_std, tp_start, 0)`` are absorbed as a
    final scalar output. ``need`` flags the min_max outputs anything reads
    (the kernel skips the minimum when neither ``t_min`` nor ``a_min`` is).

    CUDA: kernel K3 (``fused_t0``); CPU: its plain version, which composes
    the unfused kernel bodies.
    """
    kern_arr = np.asarray(kernel_arr)
    if kern_arr.ndim != 1 or np.isnan(kern_arr).any():
        raise DSPFatal("fused_t0_front needs a 1-D NaN-free kernel")
    if curr_spec is not None:
        curr_spec = tuple(int(x) for x in curr_spec)
        if len(curr_spec) != 3 or curr_spec[1] <= 0:
            raise DSPFatal("curr_spec must be (win_m, avg_len, n_curr)")
    if atrap_spec is not None:
        atrap_spec = _trap_tuple(atrap_spec)
    need = tuple(bool(x) for x in need)
    if len(need) != 4:
        raise DSPFatal("need must have four entries")

    def fn(w_in, a_std, badrow=None):
        # the kernel and its plain version poison rows from the waveform
        # itself, which is exactly the threaded bad-row mask
        if kern_arr.shape[-1] > w_in.shape[-1]:
            raise DSPFatal("The filter is longer than the input waveform")
        outs = fused_t0(
            w_in, kern_arr, a_std, curr_spec=curr_spec, atrap_spec=atrap_spec,
            need=need,
        )
        return tuple(o.to(w_in.dtype) for o in outs)

    nout = 5 + (curr_spec is not None) + (atrap_spec is not None)
    sig = (
        "(n),()->(),(),(),(),()"
        + (",(p)" if curr_spec else "")
        + (",()" if atrap_spec else "")
    )
    return Kernel(
        fn,
        sig,
        ["ff->" + "f" * nout, "dd->" + "d" * nout],
        name="fused_t0_front",
        badrow_arg=0,
    )
