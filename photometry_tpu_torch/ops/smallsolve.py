"""
Batched solvers for *small* SPD systems (K <= ~32), unrolled over K.

Port of ``photometry_tpu/ops/smallsolve.py``: the same right-looking
Cholesky with the ``max(d, 1e-30)`` pivot clamp, forward and back
substitution, and ``diag(A^-1)`` from the column norms of ``L^-1``, as a
Python loop over the K static steps of batched tensor ops.
``torch.linalg.cholesky`` is not a substitute: it raises (or returns NaN)
on the near-singular normal equations of dummy-star rows, where the clamp
here keeps the factor finite, exactly as the JAX package does.
"""

from __future__ import annotations

import torch

__all__ = ["chol_small", "cho_solve_small", "solve_spd_small",
           "spd_inverse_diag_small"]


def chol_small(A: torch.Tensor, jitter: float = 0.0) -> torch.Tensor:
    """Cholesky factor L (lower) of a batch of small SPD matrices (..., K, K)."""
    K = A.shape[-1]
    M = A
    if jitter:
        M = M + jitter * torch.eye(K, dtype=A.dtype, device=A.device)
    rows = torch.arange(K, device=A.device)
    cols = []
    for k in range(K):
        d = torch.sqrt(torch.clamp(M[..., k, k], min=1e-30))
        col = M[..., :, k] / d[..., None]
        col = torch.where(rows >= k, col, torch.zeros((), dtype=A.dtype, device=A.device))
        M = M - col[..., :, None] * col[..., None, :]
        cols.append(col)
    return torch.stack(cols, dim=-1)


def _solve_lower(L, b):
    """L y = b by forward substitution; b is (..., K) or (..., K, M)."""
    K = L.shape[-1]
    vec = b.ndim == L.ndim - 1
    r = b[..., None] if vec else b
    ys = []
    for k in range(K):
        yk = r[..., k, :] / L[..., k, k, None]
        ys.append(yk)
        r = r - yk[..., None, :] * L[..., :, k, None]
    y = torch.stack(ys, dim=-2)
    return y[..., 0] if vec else y


def _solve_upper_t(L, b):
    """L^T x = b by back substitution; b is (..., K) or (..., K, M)."""
    K = L.shape[-1]
    vec = b.ndim == L.ndim - 1
    r = b[..., None] if vec else b
    xs = [None] * K
    for k in reversed(range(K)):
        xk = r[..., k, :] / L[..., k, k, None]
        xs[k] = xk
        r = r - xk[..., None, :] * L[..., k, :, None]
    x = torch.stack(xs, dim=-2)
    return x[..., 0] if vec else x


def cho_solve_small(L, b):
    """Solve (L L^T) x = b given the factor from :func:`chol_small`."""
    return _solve_upper_t(L, _solve_lower(L, b))


def solve_spd_small(A, b, jitter: float = 0.0):
    """Solve the batched SPD system A x = b (A: (..., K, K), b: (..., K))."""
    return cho_solve_small(chol_small(A, jitter), b)


def spd_inverse_diag_small(A, jitter: float = 0.0):
    """diag(A^-1) for batched small SPD A: diag_j = ||(L^-1)[:, j]||^2."""
    K = A.shape[-1]
    L = chol_small(A, jitter)
    eye = torch.eye(K, dtype=A.dtype, device=A.device).expand(A.shape)
    Y = _solve_lower(L, eye)
    return torch.sum(Y * Y, dim=-2)
