"""
Catmull-Rom bicubic interpolation of a regular grid.

Port of the PRF part of ``photometry_tpu/ops/spline.py`` (``_CRM`` and
``bicubic_eval``): the device-side replacement for scipy's
RectBivariateSpline evaluation (reference psf.py:119,137-147), a 16-point
gather followed by the basis contraction.  The table PRF's
``pixel_fraction`` uses it when its oversample is not an integer.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["CRM", "bicubic_eval"]

#: Catmull-Rom basis matrix: weights = [1, t, t^2, t^3] @ CRM.
CRM = np.array([[0, 2, 0, 0],
                [-1, 0, 1, 0],
                [2, -5, 4, -1],
                [-1, 3, -3, 1]], dtype=np.float32) * 0.5


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
