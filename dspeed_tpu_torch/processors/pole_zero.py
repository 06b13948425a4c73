"""Pole-zero cancellation filters (reference ``dspeed/processors/pole_zero.py``).

``pole_zero`` (reference :29) runs the first-order recursion
``y[i] = y[i-1] + x[i] - c*x[i-1]`` in a float64 buffer. It telescopes to

    ``y[i] = x[i] + (1-c) * sum_{j<i} x[j]``

i.e. one prefix sum scaled by ``(1-c) = -expm1(-1/tau)``, as in the JAX
package (``dspeed_tpu/processors/pole_zero.py:48``).

``double_pole_zero`` (reference :90) inverts a two-exponential decay. Its
denominator factors as ``(1 - z^-1)(1 - p z^-1)`` with
``p = b + frac*(a - b)``, so, as in the JAX package (:63), it is the FIR
numerator and the integrator (one float64 prefix sum), one first-order
recursion (:func:`._numerics.iir_first_order`, the recurrence kernel; in a
K7 group, K7's own op in the order of :func:`double_pole_zero_runs`) and a
homogeneous correction that restores the reference's initial conditions.
``convolve_exp``, ``convolve_damped_oscillator`` and
``inject_damped_oscillation`` are recursive filters
(:func:`.recursive_filter.recursive_filter_impl`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..errors import DSPFatal
from ._helpers import any_bad, as_tensor, cdim, isnan_any, nanmask, static_float
from ._kernel import kernel
from ._numerics import (
    K7_THREADS, hp_cumsum, iir_first_order, iir_first_order_runs, k7_prefix,
    shift_right, true_div,
)

__all__ = ["pole_zero", "double_pole_zero", "rc_exp", "convolve_exp",
           "convolve_damped_oscillator", "inject_damped_oscillation"]


def _rc(tau, like: torch.Tensor | None = None) -> torch.Tensor:
    """``exp(-1/tau)``, 0 where ``tau`` is 0; a number is taken in float64."""
    if not isinstance(tau, torch.Tensor):
        dev = like.device if like is not None else None
        tau = torch.as_tensor(np.float64(tau), device=dev)
    safe = torch.where(tau != 0, tau, torch.ones_like(tau))
    return torch.where(tau != 0, torch.exp(-1.0 / safe), torch.zeros_like(tau))


@kernel("()->()", ["f->d", "d->d"])
def rc_exp(tau):
    """RC decay exponential with zero handling (reference ``pole_zero.py:17``)."""
    return _rc(tau)


@kernel("(n),()->(n)", ["ff->f", "dd->d"])
def pole_zero(w_in, t_tau):
    """Apply a single pole-zero cancellation with time constant ``t_tau``."""
    return _pole_zero(w_in, t_tau, lambda w: shift_right(hp_cumsum(w), 1))


def pole_zero_k7(w_in, t_tau, f64=False):
    """:func:`pole_zero` as K7's op computes it (the tape's plain walk): the
    member's own body, which K7's float op equals; with ``f64`` (a float64
    program's row) the exclusive prefix in K7's order
    (:func:`._numerics.k7_prefix`), as K7's float64 op takes it."""
    if not f64:
        return pole_zero(w_in, t_tau)
    return _pole_zero(w_in, t_tau, lambda w: k7_prefix(w, exclusive=True))


def _pole_zero(w_in, t_tau, excl_prefix):
    """``pole_zero``'s body with the exclusive prefix ``excl_prefix``."""
    dtype = w_in.dtype
    if isinstance(t_tau, torch.Tensor) and t_tau.ndim > 0:
        one_minus_c = -torch.expm1(-1.0 / t_tau)
        bad_tau = isnan_any(t_tau)
    else:
        tau = float(t_tau)
        one_minus_c = -np.expm1(-1.0 / tau) if tau != 0 else 1.0
        bad_tau = np.isnan(tau)
    prefix = excl_prefix(w_in)
    out = (w_in + (cdim(one_minus_c) * prefix).to(dtype)).to(dtype)
    return nanmask(any_bad(isnan_any(w_in, 1), bad_tau), out)


def dpz_constants(tau1: float, tau2: float, frac: float) -> dict:
    """The float64 constants of ``double_pole_zero``, computed as the JAX
    package computes them: the zeros ``a``, ``b``, the pole ``p``, the FIR
    taps ``a + b`` and ``a * b`` (used in float64), and the correction's
    ``1 - a + frac*(a - b)`` and ``1 - p`` (rounded to the row's type).
    K7's op reads the same values."""
    a = np.exp(-1.0 / tau1)
    b = np.exp(-1.0 / tau2)
    p = b + frac * (a - b)
    return dict(a=a, b=b, p=p, k1=a + b, k2=a * b, ke=1.0 - a + frac * (a - b),
                kd=1.0 - p)


def dpz_powers(p: float, n: int) -> np.ndarray:
    """``p**i`` for ``i < n`` in float64 (``np.power``, as the JAX package)."""
    return np.power(p, np.arange(n))


def _prefixes(w_in):
    """The row's inclusive float64 prefix ``S`` at ``j``, ``j - 1`` and
    ``j - 2`` (0 before the row)."""
    ps = hp_cumsum(w_in)
    return ps, shift_right(ps, 1), shift_right(ps, 2)


def _runs_prefixes(w_in):
    """``S`` at ``j``, ``j - 1`` and ``j - 2`` as K7's ``double_pole_zero``
    op takes them: in K7's prefix order (:func:`._numerics.k7_prefix`, its
    exclusive form at ``j - 1``), and at the first sample ``j0`` of a
    thread's run ``S[j0 - 2]`` as ``S[j0 - 1] - x[j0 - 1]``."""
    x = w_in.to(torch.float64)
    excl = k7_prefix(x, exclusive=True)
    per = -(-x.shape[-1] // K7_THREADS)
    first = torch.arange(x.shape[-1], device=x.device) % per == 0
    return excl + x, excl, torch.where(first, excl - shift_right(x, 1),
                                       shift_right(excl, 1))


def _double_pole_zero(w_in, t_tau1, t_tau2, frac, pole, prefixes=_prefixes):
    """``double_pole_zero``'s body with its pole recursion ``pole(z, p)``
    and the prefixes ``prefixes(w_in)`` of its numerator."""
    n = w_in.shape[-1]
    if n <= 3:
        raise DSPFatal(
            "The length of the waveform must be larger than 3 for the filter "
            "to work safely"
        )
    tau1 = static_float(t_tau1, "double_pole_zero", "t_tau1")
    tau2 = static_float(t_tau2, "double_pole_zero", "t_tau2")
    fr = static_float(frac, "double_pole_zero", "frac")
    k = dpz_constants(tau1, tau2, fr)
    dtype, dev = w_in.dtype, w_in.device

    def const(v):
        return torch.full((), v, dtype=dtype, device=dev)

    # the numerator's prefix, taken from the row's float64 prefix S by
    # linearity: sum_{j<=i} (x[j] - k1 x[j-1] + k2 x[j-2]) = S[i] - k1 S[i-1]
    # + k2 S[i-2]; the numerator in the row's type cancels to a few ulps of
    # the pulse, and its prefix integrates them
    s0, s1, s2 = prefixes(w_in)
    z = (s0 - k["k1"] * s1 + k["k2"] * s2).to(dtype)
    y = pole(z, k["p"]).to(dtype)
    alpha = true_div(w_in[..., :1] * const(k["ke"]), k["kd"])
    pi = torch.from_numpy(dpz_powers(k["p"], n)).to(dev, dtype)
    y = y - alpha * (1.0 - pi)
    bad = any_bad(isnan_any(w_in, 1), np.isnan(tau1), np.isnan(tau2), np.isnan(fr))
    return nanmask(bad, y.to(dtype))


@kernel("(n),(),(),()->(n)", ["ffff->f", "dddd->d"])
def double_pole_zero(w_in, t_tau1, t_tau2, frac):
    """Apply a double pole-zero cancellation (reference ``pole_zero.py:90``).

    FIR numerator ``x[i] - (a+b)x[i-1] + ab x[i-2]`` followed by the factored
    denominator: integrator (float64 prefix sum, rounded to the row's type)
    then the single pole ``p = b+frac*(a-b)`` (float64 on the recurrence
    kernel, rounded once). The reference forces ``y[0] = x[0]``, ``y[1] =
    x[1]``; the zero-state cascade differs from it by ``alpha*(1 - p^i)``
    with ``alpha = x[0]*(1 - a + frac*(a-b))/(1 - p)``, which is subtracted.

    The numerator and the integrator are taken together in float64, from
    the row's prefix (the JAX package rounds the numerator to the row's
    type first, which on a float32 row moves ``trapEmax`` by up to ~2e-3
    against its own float64 chain; here the float32 chain stays within
    1e-5 of it).
    """
    return _double_pole_zero(w_in, t_tau1, t_tau2, frac, iir_first_order)


def double_pole_zero_runs(w_in, t_tau1, t_tau2, frac, f64=False):
    """:func:`double_pole_zero` in the order of K7's op, which equals it bit
    for bit: its numerator's prefixes as the op takes them
    (:func:`_runs_prefixes`), its pole by runs
    (:func:`._numerics.iir_first_order_runs`: runs of ``ceil(n/256)``
    samples and an affine scan of their maps). The plain walk of a K7 group
    takes it; K7's float and float64 ops take the same order, so ``f64`` (a
    float64 program's row) changes nothing. Rows are ``(B, n)``."""
    def pole(z, p):
        return iir_first_order_runs(z.reshape(-1, z.shape[-1]), p).reshape(z.shape)

    return _double_pole_zero(w_in, t_tau1, t_tau2, frac, pole, _runs_prefixes)


@kernel("(n),()->(n)", ["fd->f", "dd->d"])
def convolve_exp(w_in, tau):
    """Convolve with a peak-normalized decaying exponential via the recursive
    filter (reference ``pole_zero.py:207``)."""
    from .recursive_filter import recursive_filter_impl

    rc = _rc(tau, w_in)
    a = torch.ones(1, dtype=torch.float64, device=w_in.device)
    b = torch.stack(torch.broadcast_tensors(torch.ones_like(rc), -rc), dim=-1)
    return recursive_filter_impl(w_in, a, b, w_in[..., 0], w_in[..., 0])


def _f64(x, like):
    return as_tensor(np.float64(x) if not isinstance(x, torch.Tensor) else x,
                     like, torch.float64)


@kernel("(n),(),(),()->(n)", ["fddd->f", "dddd->d"])
def convolve_damped_oscillator(w_in, tau, omega, phase):
    """Convolve with a peak-normalized damped oscillator
    (reference ``pole_zero.py:242``)."""
    from .recursive_filter import recursive_filter_impl

    rc = _rc(tau, w_in)
    omega, phase = _f64(omega, w_in), _f64(phase, w_in)
    one = torch.ones((), dtype=torch.float64, device=w_in.device)
    a = torch.stack(torch.broadcast_tensors(
        torch.cos(phase), -rc * torch.cos(omega - phase)), dim=-1)
    b = torch.stack(torch.broadcast_tensors(
        one, -2.0 * rc * torch.cos(omega), rc * rc), dim=-1)
    return recursive_filter_impl(w_in, a, b, w_in[..., 0], w_in[..., 0])


@kernel("(n),(),(),(),()->(n)", ["fdddd->f", "ddddd->d"])
def inject_damped_oscillation(w_in, tau, omega, phase, frac):
    """Add a damped oscillation scaled by ``frac`` onto the waveform
    (reference ``pole_zero.py:292``)."""
    from .recursive_filter import recursive_filter_impl

    rc = _rc(tau, w_in)
    omega, phase, frac = (_f64(v, w_in) for v in (omega, phase, frac))
    cp, cw, cwp = torch.cos(phase), torch.cos(omega), torch.cos(omega - phase)
    one = torch.ones((), dtype=torch.float64, device=w_in.device)
    a = torch.stack(torch.broadcast_tensors(
        one + frac * cp,
        -(2.0 * rc * cw + frac * cp + frac * rc * cwp),
        rc * (rc + frac * cwp),
    ), dim=-1)
    b = torch.stack(torch.broadcast_tensors(one, -2.0 * rc * cw, rc * rc), dim=-1)
    return recursive_filter_impl(w_in, a, b, w_in[..., 0], 0.0)


def _pz_checker(w_in, t_tau, out=None):
    """Checked-mode flag for the reference's output-NaN fatal
    (``pole_zero.py:76-77``; the JAX package's ``_pz_checker``, :174): NaN
    inputs give NaN outputs first (:57-58), so the flag is set only where
    finite inputs overflow the recursion into NaN (a tiny negative tau). In
    a chain ``out`` is the step's own output, read under the same rule; the
    filter runs here only when called alone."""
    skip = any_bad(isnan_any(w_in, 1), isnan_any(t_tau))
    if out is None:
        out = pole_zero.fn(w_in, t_tau)
    code = isnan_any(out, 1)
    code = code & ~skip if isinstance(skip, torch.Tensor) else code & (not skip)
    return code.to(torch.int32).expand(
        torch.broadcast_shapes(code.shape, w_in.shape[:-1]))


pole_zero.checker = _pz_checker
pole_zero.checker_reads_outputs = True
pole_zero.check_messages = {1: "Pole-zero filter produced nans in output."}

# generic row-tile fusion (the JAX package's flags)
pole_zero.tile_safe = True
double_pole_zero.tile_safe = True
# the tape's plain walk runs K7's order (_cuda.generic_rows_plain)
pole_zero.k7_plain = pole_zero_k7
double_pole_zero.k7_plain = double_pole_zero_runs
