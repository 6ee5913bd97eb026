"""
Cubic splines on torch tensors: natural 1-D splines and Catmull-Rom
bicubic interpolation of a regular grid.

Port of ``photometry_tpu/ops/spline.py``:

- :func:`natural_cubic_coeffs` / :func:`eval_natural_spline`: the natural
  cubic spline of the background's radial profile (reference
  backgrounds.py:190-193), built for every frame at once on knots the
  frames share: the Thomas sweeps run over the knots with the frames as a
  batch; evaluation is a ``searchsorted`` gather and the cubic.
- :func:`bicubic_eval`: the replacement for scipy's RectBivariateSpline
  evaluation (reference psf.py:119,137-147), a 16-point gather followed by
  the basis contraction.  The table PRF's ``pixel_fraction`` uses it when
  its oversample is not an integer.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["CRM", "bicubic_coeffs", "bicubic_eval", "natural_cubic_coeffs", "make_natural_spline",
           "eval_natural_spline"]

#: Catmull-Rom basis matrix: weights = [1, t, t^2, t^3] @ CRM.
CRM = np.array([[0, 2, 0, 0],
                [-1, 0, 1, 0],
                [2, -5, 4, -1],
                [-1, 3, -3, 1]], dtype=np.float32) * 0.5


def bicubic_coeffs(grid) -> torch.Tensor:
    """Identity packing for Catmull-Rom interpolation: the grid as float32
    (``spline.bicubic_coeffs``; :func:`bicubic_eval` reads the grid itself)."""
    return torch.as_tensor(grid, dtype=torch.float32)


def _basis(t: torch.Tensor) -> torch.Tensor:
    tt = torch.stack([torch.ones_like(t), t, t * t, t * t * t], dim=-1)
    return tt @ torch.as_tensor(CRM, device=t.device)                # (..., 4)


def bicubic_eval(grid: torch.Tensor, yq, xq) -> torch.Tensor:
    """Catmull-Rom interpolation of an (H, W) grid at index coordinates.

    Out-of-range queries clamp to the border.
    """
    grid = torch.as_tensor(grid, dtype=torch.float32)
    H, W = grid.shape
    yq = torch.clamp(torch.as_tensor(yq, dtype=torch.float32, device=grid.device),
                     0.0, H - 1.000001)
    xq = torch.clamp(torch.as_tensor(xq, dtype=torch.float32, device=grid.device),
                     0.0, W - 1.000001)
    y0 = torch.floor(yq).long()
    x0 = torch.floor(xq).long()
    ty = yq - y0
    tx = xq - x0
    offs = torch.arange(-1, 3, device=grid.device)
    yy = torch.clamp(y0[..., None] + offs, 0, H - 1)                   # (..., 4)
    xx = torch.clamp(x0[..., None] + offs, 0, W - 1)
    patch = grid[yy[..., :, None], xx[..., None, :]]                   # (..., 4, 4)
    return torch.einsum("...i,...ij,...j->...", _basis(ty), patch, _basis(tx))


def natural_cubic_coeffs(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Second derivatives M (..., n) of the natural cubic splines through
    (x, y[..., :]) on shared knots ``x`` (n,); M_0 = M_{n-1} = 0.

    The tridiagonal system of the interior knots is solved by the Thomas
    algorithm, one sweep step per knot over all leading entries at once.
    """
    n = x.shape[0]
    h = x[1:] - x[:-1]                                                   # (n-1,)
    dd = (y[..., 2:] - y[..., 1:-1]) / h[1:] - (y[..., 1:-1] - y[..., :-2]) / h[:-1]
    a, b, c, d = h[:-1], 2 * (h[:-1] + h[1:]), h[1:], 6 * dd
    cp_prev = torch.zeros((), dtype=y.dtype, device=y.device)
    dp_prev = torch.zeros(y.shape[:-1], dtype=y.dtype, device=y.device)
    cps, dps = [], []
    for i in range(n - 2):
        denom = b[i] - a[i] * cp_prev
        cp_prev = c[i] / denom
        dp_prev = (d[..., i] - a[i] * dp_prev) / denom
        cps.append(cp_prev)
        dps.append(dp_prev)
    m_next = torch.zeros_like(dp_prev)
    interior = [None] * (n - 2)
    for i in range(n - 3, -1, -1):
        m_next = dps[i] - cps[i] * m_next
        interior[i] = m_next
    zero = torch.zeros(y.shape[:-1] + (1,), dtype=y.dtype, device=y.device)
    return torch.cat([zero] + [m[..., None] for m in interior] + [zero], dim=-1)


def make_natural_spline(x: torch.Tensor, y: torch.Tensor):
    """Pack natural cubic splines as (x, y, M) for :func:`eval_natural_spline`."""
    return x, y, natural_cubic_coeffs(x, y)


def eval_natural_spline(spline, xq: torch.Tensor, clamp: bool = True) -> torch.Tensor:
    """Evaluate packed splines (x (n,), y (F, n), M (F, n)) at query points
    ``xq`` shared by the F splines; returns (F,) + xq.shape.

    ``clamp=True`` clamps queries to the knot range (constant
    extrapolation, the reference's ``ext=3`` at backgrounds.py:191).
    """
    x, y, M = spline
    if clamp:
        xq = torch.clamp(xq, x[0], x[-1])
    i = torch.clamp(torch.searchsorted(x, xq, right=True) - 1, 0, x.shape[0] - 2)
    x0, x1 = x[i], x[i + 1]
    h = x1 - x0
    A = (x1 - xq) / h
    B = (xq - x0) / h
    cA, cB, hh = A ** 3 - A, B ** 3 - B, h ** 2
    return (A * y[:, i] + B * y[:, i + 1]
            + (cA * M[:, i] + cB * M[:, i + 1]) * hh / 6.0)
