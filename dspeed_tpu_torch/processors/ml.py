"""Small neural-network layers built from DSP configs (reference
``dspeed/processors/ml.py:48-358``; JAX package ``dspeed_tpu/processors/ml.py``).

A product with a weight matrix (or vector), a bias, an activation.
Activation flags (static chars): ``s`` sigmoid, ``r`` ReLU, ``l`` leaky
ReLU, ``m`` softplus, ``t`` tanh; another raises ``DSPFatal``.

Called alone, a layer's product is ``torch.matmul`` in the row's type
(TF32 off, as PyTorch sets it by default; the JAX package asks XLA for
``HIGHEST`` precision). Inside a generic group the layers run as K7's
``dense`` op, whose sums take a fixed order that :func:`layer_rows`
repeats in PyTorch (the plain walk of the tape), so that the card and the
plain walk give the same bits.
"""

from __future__ import annotations

import torch

from ..errors import DSPFatal
from ._helpers import as_tensor, isnan_any, nanmask, static_int
from ._kernel import kernel
from ._numerics import K7_THREADS

__all__ = [
    "dense_layer_no_bias",
    "dense_layer_with_bias",
    "classification_layer_no_bias",
    "classification_layer_with_bias",
    "normalisation_layer",
]

ACTIVATIONS = "srlmt"


def activation_flag(flag, name: str) -> int:
    """The static activation flag, checked: ``DSPFatal`` for an unknown one."""
    flag = static_int(flag, name, "activation_func")
    if chr(flag) not in ACTIVATIONS:
        raise DSPFatal(f"unrecognized activation flag {chr(flag)!r} in {name}")
    return flag


def _activate(temp, flag: int, name: str):
    """The JAX package's activations, operation by operation. Its ReLU is
    ``t * (t > 0)`` and its leaky ReLU ``t * (t > 0) + 0.01 * t * (t <
    0)``, and JAX multiplies by a comparison as a select: a NaN or a -inf
    gives 0 (the leaky ReLU's -inf stays -inf), which ``torch.where``
    repeats. Softplus is ``log1p(exp(t))``."""
    ch = chr(flag)
    zero = torch.zeros((), dtype=temp.dtype, device=temp.device)
    if ch == "s":
        return 1.0 / (1.0 + torch.exp(-temp))
    if ch == "r":
        return torch.where(temp > 0, temp, zero)
    if ch == "l":
        return torch.where(temp > 0, temp, zero) + torch.where(temp < 0, 0.01 * temp, zero)
    if ch == "m":
        return torch.log1p(torch.exp(temp))
    if ch == "t":
        return torch.tanh(temp)
    raise DSPFatal(f"unrecognized activation flag {ch!r} in {name}")


def _matmul(x, kern):
    kern = as_tensor(kern, x, x.dtype)
    if kern.ndim == 2:
        return torch.matmul(x, kern)
    return torch.matmul(x[..., None, :], kern)[..., 0, :]


def _dot(x, kern):
    kern = as_tensor(kern, x, x.dtype)
    return (torch.matmul(x[..., None, :], kern[..., :, None])[..., 0, 0]
            if kern.ndim > 1 else torch.matmul(x, kern))


@kernel("(n),(n,m),()->(m)", ["ffb->f", "ddb->d"], static=[2])
def dense_layer_no_bias(x_in, kernel_in, activation_func):
    flag = activation_flag(activation_func, "dense_layer_no_bias")
    out = _activate(_matmul(x_in, kernel_in), flag, "dense_layer_no_bias")
    return nanmask(isnan_any(x_in, 1), out.to(x_in.dtype))


@kernel("(n),(n,m),(m),()->(m)", ["fffb->f", "dddb->d"], static=[3])
def dense_layer_with_bias(x_in, kernel_in, bias, activation_func):
    flag = activation_flag(activation_func, "dense_layer_with_bias")
    temp = _matmul(x_in, kernel_in) + as_tensor(bias, x_in, x_in.dtype)
    out = _activate(temp, flag, "dense_layer_with_bias")
    return nanmask(isnan_any(x_in, 1), out.to(x_in.dtype))


@kernel("(n),(n),()->()", ["ffb->f", "ddb->d"], static=[2])
def classification_layer_no_bias(x_in, kernel_in, activation_func):
    flag = activation_flag(activation_func, "classification_layer_no_bias")
    out = _activate(_dot(x_in, kernel_in), flag, "classification_layer_no_bias")
    return nanmask(isnan_any(x_in, 1), out.to(x_in.dtype))


@kernel("(n),(n),(),()->()", ["fffb->f", "dddb->d"], static=[3])
def classification_layer_with_bias(x_in, kernel_in, bias, activation_func):
    flag = activation_flag(activation_func, "classification_layer_with_bias")
    temp = _dot(x_in, kernel_in) + as_tensor(bias, x_in, x_in.dtype)
    out = _activate(temp, flag, "classification_layer_with_bias")
    return nanmask(isnan_any(x_in, 1), out.to(x_in.dtype))


@kernel("(n),(n),(n)->(n)", ["fff->f", "ddd->d"])
def normalisation_layer(x_in, means, variances):
    out = (x_in - as_tensor(means, x_in, x_in.dtype)) / torch.sqrt(
        as_tensor(variances, x_in, x_in.dtype))
    return nanmask(isnan_any(x_in, 1), out.to(x_in.dtype))


# K7 splits a product's inputs among this many warps (csrc/generic_rows.cu's
# GEN_WARPS)
K7_WARPS = K7_THREADS // 32


def layer_rows(x, kern, bias, flag: int, name: str, f64: bool = False):
    """A dense (``kern`` ``(n, m)``) or classification (``kern`` ``(n,)``)
    layer over the rows of ``x`` (``(B, n)``) with K7's ``dense`` op's sums:
    warp ``w`` of ``K7_WARPS`` sums the products of the inputs ``[w c, (w +
    1) c)`` (``c = ceil(n / K7_WARPS)``) in order in float64 (each product of
    two ``x``-typed values is exact there), the warps' sums are added in
    order, and the total is rounded to ``x``'s type; then the bias (``(m,)``,
    or a number or one value per row for a classification) and the
    activation, in ``x``'s type (``f64``, a float64 program's row: every
    product, sum and activation in float64, as K7's float64 op takes them,
    nothing rounded to float32). NaN rows give NaN."""
    B, n = x.shape
    w = as_tensor(kern, x, x.dtype)
    vec = w.ndim == 1
    w = (w[:, None] if vec else w).double()
    m = w.shape[1]
    c = -(-n // K7_WARPS)
    xd = x.double()
    part = torch.zeros((B, K7_WARPS, m), dtype=torch.float64, device=x.device)
    for k in range(c):
        # the k-th input of each warp's run, for the warps whose run has one
        idx = [q * c + k for q in range(K7_WARPS) if q * c + k < n]
        live = len(idx)
        part[:, :live] = part[:, :live] + xd[:, idx, None] * w[idx]
    tot = torch.zeros((B, m), dtype=torch.float64, device=x.device)
    for q in range(K7_WARPS):
        tot = tot + part[:, q]
    temp = tot.to(x.dtype)
    if vec:
        temp = temp[:, 0]
    if bias is not None:
        b = as_tensor(bias, x, x.dtype)
        temp = temp + b
    out = _activate(temp, flag, name)
    return nanmask(isnan_any(x, 1), out.to(x.dtype))


# generic row-tile fusion (the JAX package's flags, so that both packages
# form the same groups)
dense_layer_no_bias.tile_safe = True
dense_layer_with_bias.tile_safe = True
classification_layer_no_bias.tile_safe = True
classification_layer_with_bias.tile_safe = True
normalisation_layer.tile_safe = True
