"""Non-negative least squares (reference ``dspeed/processors/nnls.py:21``;
JAX package ``dspeed_tpu/processors/nnls.py``).

The reference runs the Bro-De Jong active-set algorithm in a numba kernel.
The JAX package, and this port of it, take a fixed number of projected
fast-gradient (FISTA) steps for every event at once, then solve the least
squares on the support found, and keep that solution where its residual is
no larger. The products and the batched solve are plain tensor ops (XLA's
in the JAX package), in ``config.accum_dtype`` (float64).
"""

from __future__ import annotations

import torch

from ..config import accum_dtype
from ._helpers import as_tensor, isnan_any, nanmask, static_int
from ._kernel import kernel

__all__ = ["optimize_nnls"]


def _fista_nnls(A, b, iters: int):
    """``min ||A x - b||^2`` subject to ``x >= 0``, batched over the leading
    dims of ``b``."""
    AtA = A.T @ A
    Atb = b @ A
    # the gradient's Lipschitz constant: the largest eigenvalue of AtA
    step = 1.0 / torch.linalg.matrix_norm(AtA, ord=2)
    x = torch.zeros_like(Atb)
    z = x
    t = torch.ones((), dtype=b.dtype, device=b.device)
    for _ in range(iters):
        g = z @ AtA.T - Atb
        x_new = torch.clamp(z - step * g, min=0.0)
        t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
        z = x_new + ((t - 1.0) / t_new) * (x_new - x)
        x, t = x_new, t_new

    # debias: the exact least squares on the support found (the active-set
    # solution), kept where it does not increase the residual
    supp = x > 1e-7 * x.max(dim=-1, keepdim=True).values
    sf = supp.to(A.dtype)
    eye = torch.eye(AtA.shape[0], dtype=A.dtype, device=A.device)
    M = AtA * sf[..., :, None] * sf[..., None, :] + eye * (1.0 - sf)[..., None, :]
    x_db = torch.linalg.solve(M, (Atb * sf)[..., None])[..., 0]
    x_db = torch.clamp(x_db * sf, min=0.0)

    def resid(v):
        return ((v @ AtA.T - 2 * Atb) * v).sum(-1)

    return torch.where((resid(x_db) <= resid(x))[..., None], x_db, x)


@kernel(
    "(m,n),(m),(),(),(),(),(n)",
    ["ffffbf" + "f", "ddddbd" + "d"],
    nout=1,
    static=[2, 3, 4, 5],
    uses_dims=True,
)
def optimize_nnls(mat, vec, maxiter, tol, allow_singularity, min_value, dims):
    """``argmin_x ||mat @ x - vec||`` subject to ``x >= 0`` (reference
    ``nnls.py:21``, the same positional arguments: a, b, maxiter, tol,
    allow_singularity, min_value). ``max(32, 3 n)`` FISTA steps, capped by a
    positive ``maxiter`` (but at least 32); ``tol`` and
    ``allow_singularity`` are accepted and unused, as in the JAX package.
    Entries at or below a positive ``min_value`` are zeroed. A matrix given
    per event takes the first event's, as the JAX package does."""
    b = vec if isinstance(vec, torch.Tensor) else torch.as_tensor(vec)
    A = as_tensor(mat, b)
    if A.ndim != 2:
        A = A.reshape(-1, *A.shape[-2:])[0]
    n = dims["n"]
    iters = max(32, 3 * n)
    maxit = static_int(maxiter, "optimize_nnls", "maxiter")
    if maxit > 0:
        iters = min(iters, max(maxit, 32))
    # in float64 whatever the types (the JAX package solves in the matrix's):
    # the shifted templates of a fit are nearly collinear, and a float32
    # solve would leave the card and the CPU apart by its conditioning
    acc = accum_dtype()
    x = _fista_nnls(A.to(acc), b.to(acc), iters)
    mv = float(min_value)
    if mv > 0.0:
        x = torch.where(x > mv, x, torch.zeros((), dtype=x.dtype, device=x.device))
    return nanmask(isnan_any(b, 1), x.to(b.dtype))
