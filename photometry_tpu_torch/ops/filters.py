"""
Gaussian blur for the watershed preprocessing, on torch tensors.

Port of ``photometry_tpu/ops/filters.py:gaussian_blur2d``: the separable
reflect-padded blur as two static band-matrix matmuls ``G_r @ img @ G_c^T``
(exact; the band matrices are built once per size in numpy float64 and cast
to float32, as in the reference).  TF32 is off (``device.py``), so both
matmuls run in full float32 like the reference's ``Precision.HIGHEST``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import device  # noqa: F401  (float32 precision policy)

__all__ = ["gaussian_blur2d"]


@functools.lru_cache(maxsize=64)
def _blur_matrix(n: int, sigma: float, truncate: float = 4.0) -> np.ndarray:
    """(n, n) band matrix applying a reflect-padded 1-D Gaussian blur."""
    radius = max(int(truncate * sigma + 0.5), 1)
    t = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (t / sigma) ** 2)
    k /= k.sum()
    idx = np.arange(n)[:, None] + np.arange(-radius, radius + 1)[None, :]
    # numpy 'reflect' (mirror, edge not repeated); fold repeatedly for radii
    # larger than the image:
    for _ in range(max(1, radius // max(n - 1, 1) + 1)):
        idx = np.abs(idx)
        idx = np.where(idx >= n, 2 * n - 2 - idx, idx)
    G = np.zeros((n, n), np.float64)
    np.add.at(G, (np.repeat(np.arange(n), len(k)), idx.ravel()), np.tile(k, n))
    G = G.astype(np.float32)
    G.flags.writeable = False
    return G


def gaussian_blur2d(img: torch.Tensor, sigma: float = 1.0) -> torch.Tensor:
    """Separable Gaussian blur with reflect padding of (..., h, w) images."""
    img = img.to(torch.float32)
    h, w = img.shape[-2:]
    Gr = torch.from_numpy(_blur_matrix(h, float(sigma)).copy()).to(img.device)
    Gc = torch.from_numpy(_blur_matrix(w, float(sigma)).copy()).to(img.device)
    return torch.matmul(torch.matmul(Gr, img), Gc.T)
