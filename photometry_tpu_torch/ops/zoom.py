"""
Cubic B-spline zoom of the background tile mesh, on torch tensors.

Port of ``photometry_tpu/ops/zoom.py:spline_zoom``: the interpolation of
``scipy.ndimage.zoom(order=3, mode='reflect', grid_mode=True)``, which
photutils' ``BkgZoomInterpolator`` applies to the low-resolution mesh
(reference backgrounds.py:199).

The spline prefilter (the single-pole IIR with pole sqrt(3) - 2, run
forward and backward over a reflect-padded axis) is linear and depends only
on the axis length, and so is the B-spline evaluation.  Both are folded
into one (n_out, n_in) matrix per axis, built on the host in float64 by
running the JAX package's recursion on the identity, so the zoom is
``L @ mesh @ R^T``: two float32 matmuls with TF32 off (``device.py``)
instead of ~90 sequential recursion steps per axis.  Against scipy it
agrees to float32 rounding of the two products (tests/test_torch_prepare.py
states the tolerance).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import device  # noqa: F401  (no TF32 in the matmuls)

__all__ = ["spline_zoom"]

_POLE3 = np.sqrt(3.0) - 2.0          #: cubic B-spline prefilter pole
_PAD = 30                            #: |pole|^30 ~ 1e-17: exact to float64 eps


def _reflect_indices(idx, n):
    """scipy 'reflect' (symmetric, edge-repeated) index extension."""
    idx = np.asarray(idx)
    if n == 1:
        return np.zeros_like(idx)
    period = 2 * n
    idx = np.remainder(idx, period)
    return np.where(idx >= n, period - 1 - idx, idx)


def _prefilter_matrix(n: int) -> np.ndarray:
    """(n, n) float64 matrix of the cubic-B-spline prefilter (mode='reflect')."""
    pad = min(_PAD, 10 * n)
    ext = _reflect_indices(np.arange(-pad, n + pad), n)
    xe = np.eye(n)[ext]                                   # (n + 2 pad, n)
    z = _POLE3
    gain = (1.0 - z) * (1.0 - 1.0 / z)
    cp = np.empty_like(xe)
    carry = np.zeros(n)
    for k in range(xe.shape[0]):
        carry = xe[k] * gain + z * carry
        cp[k] = carry
    cm = np.empty_like(xe)
    carry = np.zeros(n)
    for k in range(xe.shape[0] - 1, -1, -1):
        carry = z * (carry - cp[k])
        cm[k] = carry
    return cm[pad:pad + n]


def _weight_matrix(n_in: int, n_out: int, grid_mode: bool) -> np.ndarray:
    """(n_out, n_in) float64 cubic-B-spline evaluation weights, 'reflect'."""
    zoom = n_out / n_in
    i = np.arange(n_out, dtype=np.float64)
    if grid_mode:
        xq = (i + 0.5) / zoom - 0.5
    else:
        zoom_nd = (n_out - 1) / (n_in - 1) if n_in > 1 else 1.0
        xq = i / zoom_nd
    base = np.floor(xq).astype(np.int64)
    t = xq - base
    w = np.stack([((1 - t) ** 3) / 6.0,
                  (3 * t ** 3 - 6 * t ** 2 + 4.0) / 6.0,
                  (-3 * t ** 3 + 3 * t ** 2 + 3 * t + 1.0) / 6.0,
                  (t ** 3) / 6.0], axis=1)                   # (n_out, 4)
    W = np.zeros((n_out, n_in), np.float64)
    for j in range(4):
        np.add.at(W, (np.arange(n_out), _reflect_indices(base + j - 1, n_in)), w[:, j])
    return W


@functools.lru_cache(maxsize=32)
def _axis_matrix(n_in: int, n_out: int, grid_mode: bool) -> np.ndarray:
    """(n_out, n_in) float32: evaluation weights @ prefilter, built in float64."""
    M = (_weight_matrix(n_in, n_out, grid_mode) @ _prefilter_matrix(n_in)).astype(np.float32)
    M.flags.writeable = False
    return M


def spline_zoom(mesh: torch.Tensor, out_shape, grid_mode: bool = True) -> torch.Tensor:
    """Zoom (..., h, w) meshes to (..., H, W) with cubic B-splines, as
    ``scipy.ndimage.zoom(mesh, order=3, mode='reflect', grid_mode=grid_mode)``."""
    mesh = mesh.to(torch.float32)
    h, w = mesh.shape[-2:]
    H, W = out_shape
    L = torch.from_numpy(_axis_matrix(h, H, grid_mode).copy()).to(mesh.device)
    R = torch.from_numpy(_axis_matrix(w, W, grid_mode).copy()).to(mesh.device)
    return torch.matmul(torch.matmul(L, mesh), R.T)
