"""
Image filters on torch tensors: Gaussian blur, median filters, time smoothing.

Port of ``photometry_tpu/ops/filters.py``:

- :func:`gaussian_blur2d`: the separable reflect-padded blur of the
  watershed preprocessing as two static band-matrix matmuls
  ``G_r @ img @ G_c^T`` (exact; the band matrices are built once per size
  in numpy float64 and cast to float32, as in the reference).  TF32 is off
  (``device.py``), so both matmuls run in full float32 like the
  reference's ``Precision.HIGHEST``.
- :func:`median_filter2d_chunked`: the exact k x k median of the
  Background-Shenanigans detector (``ops/median15.py``: the CUDA kernel on
  a card, the row-chunked shifted-stack bisection on the CPU).
- :func:`median_filter2d`: the NaN-ignoring shifted-stack median of small
  images.
- :func:`time_moving_nanmean` (and its blocked form): the prepare stage's
  background time smoothing by running sums.
- :func:`scharr`: the Scharr gradient magnitude of the registration's
  preprocessing (``ops/registration.py``).
- :func:`binary_dilation`, :func:`binary_erosion` and :func:`fill_holes`:
  binary morphology of bool masks by shifted ORs and ANDs over the cross
  (connectivity 1) or the 3 x 3 box (2), pixels outside the image False,
  as the JAX package's "SAME" convolutions with zero padding.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import device  # noqa: F401  (float32 precision policy)
from ..utils.mathutils import nanmedian
from .median15 import _symmetric_pad, median_filter

__all__ = ["gaussian_blur2d", "median_filter2d", "median_filter2d_chunked",
           "time_moving_nanmean", "time_moving_nanmean_blocked", "scharr",
           "binary_dilation", "binary_erosion", "fill_holes"]


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


def time_moving_nanmean(x: torch.Tensor, window: int = 3) -> torch.Tensor:
    """Centred moving nanmean along dim 0 with shrinking edge windows.

    The reference's background time smoothing (prepare.py:309-338) by
    running sums: one float32 cumsum over T instead of a ``window``-deep
    stack.
    """
    T = x.shape[0]
    half = window // 2
    fin = torch.isfinite(x)
    zero = torch.zeros((1,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    cs = torch.cat([zero, torch.cumsum(torch.where(fin, x, 0.0), dim=0)], dim=0)
    cc = torch.cat([zero.to(torch.int32), torch.cumsum(fin.to(torch.int32), dim=0,
                                                        dtype=torch.int32)], dim=0)
    t = torch.arange(T, device=x.device)
    lo = torch.clamp(t - half, 0, T)
    hi = torch.clamp(t + half + 1, 0, T)
    s = cs[hi] - cs[lo]
    n = cc[hi] - cc[lo]
    return torch.where(n > 0, s / torch.clamp(n, min=1), torch.nan)


def time_moving_nanmean_blocked(x: torch.Tensor, window: int = 3, block: int = 256) -> torch.Tensor:
    """:func:`time_moving_nanmean` over halo'd T-blocks of ``block`` frames
    (the running sums stay short; the windows are the same)."""
    T = x.shape[0]
    half = window // 2
    if T <= block:
        return time_moving_nanmean(x, window)
    out = torch.empty_like(x, dtype=torch.float32)
    for t0 in range(0, T, block):
        t1 = min(t0 + block, T)
        lo, hi = max(0, t0 - half), min(T, t1 + half)
        out[t0:t1] = time_moving_nanmean(x[lo:hi], window)[t0 - lo:t0 - lo + (t1 - t0)]
    return out


def median_filter2d(img: torch.Tensor, size: int = 15, mode: str = "reflect") -> torch.Tensor:
    """k x k NaN-ignoring median filter of (..., H, W) images.

    ``mode='reflect'`` is scipy.ndimage's default border (numpy
    ``symmetric``); ``mode='nan'`` pads with NaN so border medians use
    fewer samples.  Materialises the k^2-deep stack: small images only.
    """
    half = size // 2
    lead = img.shape[:-2]
    x = img.reshape((-1,) + tuple(img.shape[-2:])).to(torch.float32)
    if mode == "reflect":
        padded = _symmetric_pad(x, half)
    elif mode == "nan":
        padded = torch.nn.functional.pad(x, (half,) * 4, value=float("nan"))
    else:
        raise ValueError(f"Unknown mode {mode}")
    H, W = x.shape[-2:]
    stack = torch.stack([padded[:, dy:dy + H, dx:dx + W]
                         for dy in range(size) for dx in range(size)], dim=-1)
    return nanmedian(stack, dim=-1).reshape(lead + (H, W))


def median_filter2d_chunked(img: torch.Tensor, size: int = 15, chunk_rows: int = 0,
                            budget_bytes: float = 3e8, plain: bool = False) -> torch.Tensor:
    """Exact k x k median filter of (H, W) or (F, H, W) images, NaNs zeroed first.

    The reference's scipy.ndimage.median_filter is not NaN-aware either
    (pixel_flags.py:61-79).  k = 15 runs the median kernel on a card; the
    plain version (any odd k) runs on the CPU, in row blocks under
    ``budget_bytes`` (or ``chunk_rows``), and anywhere with ``plain``.
    """
    arr = torch.nan_to_num(img.to(torch.float32))
    squeeze = arr.ndim == 2
    if squeeze:
        arr = arr[None]
    out = median_filter(arr, size, chunk_rows=chunk_rows, budget_bytes=budget_bytes, plain=plain)
    return out[0] if squeeze else out


_SCHARR_X = np.array([[-3, 0, 3], [-10, 0, 10], [-3, 0, 3]], np.float32) / 32.0
_SCHARR_Y = _SCHARR_X.T


def scharr(img: torch.Tensor) -> torch.Tensor:
    """Scharr gradient magnitude of (..., H, W) images (skimage.filters.scharr
    up to its norm), with numpy ``reflect`` padding (edge not repeated).

    The 3x3 cross-correlations are written out tap by tap, the zero taps
    included: a NaN pixel then spoils its whole 3x3 neighbourhood, as in
    the JAX package's direct convolution, whatever algorithm a convolution
    library would pick (a transform-based one spreads NaN further).
    """
    img = img.to(torch.float32)
    lead, (H, W) = img.shape[:-2], img.shape[-2:]
    p = torch.nn.functional.pad(img.reshape((-1, 1, H, W)), (1, 1, 1, 1), mode="reflect")[:, 0]
    taps = [[p[:, dy:dy + H, dx:dx + W] for dx in range(3)] for dy in range(3)]
    gx = gy = None
    for dy in range(3):
        for dx in range(3):
            tx = float(_SCHARR_X[dy, dx]) * taps[dy][dx]
            ty = float(_SCHARR_Y[dy, dx]) * taps[dy][dx]
            gx = tx if gx is None else gx + tx
            gy = ty if gy is None else gy + ty
    return torch.sqrt(gx ** 2 + gy ** 2).reshape(lead + (H, W))


_CROSS = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1))
_BOX = tuple((dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1))


def _neighbours(mask: torch.Tensor, connectivity: int):
    """The (..., H, W) mask shifted by each offset of the structuring
    element, False where the shift reaches outside the image."""
    H, W = mask.shape[-2:]
    p = torch.zeros(mask.shape[:-2] + (H + 2, W + 2), dtype=torch.bool, device=mask.device)
    p[..., 1:-1, 1:-1] = mask
    for dy, dx in (_CROSS if connectivity == 1 else _BOX):
        yield p[..., 1 + dy:1 + dy + H, 1 + dx:1 + dx + W]


def _morphology(mask, connectivity: int, iterations: int, combine) -> torch.Tensor:
    out = torch.as_tensor(mask).to(torch.bool)
    for _ in range(iterations):
        out = functools.reduce(combine, _neighbours(out, connectivity))
    return out


def binary_dilation(mask, connectivity: int = 1, iterations: int = 1) -> torch.Tensor:
    """Binary dilation of (..., H, W) masks with the cross (connectivity=1)
    or the box (=2)."""
    return _morphology(mask, connectivity, iterations, torch.logical_or)


def binary_erosion(mask, connectivity: int = 1, iterations: int = 1) -> torch.Tensor:
    """Binary erosion of (..., H, W) masks: a pixel stays where the whole
    structuring element lies in the mask (outside the image counts as out)."""
    return _morphology(mask, connectivity, iterations, torch.logical_and)


def fill_holes(mask, max_iters: int = 256) -> torch.Tensor:
    """Fill the holes of (..., H, W) masks: the pixels not reached by a
    4-connected flood from the border through the pixels outside the mask,
    grown at most ``max_iters`` steps (``filters.fill_holes``)."""
    mask = torch.as_tensor(mask).to(torch.bool)
    border = torch.zeros_like(mask)
    border[..., 0, :] = border[..., -1, :] = True
    border[..., :, 0] = border[..., :, -1] = True
    outside = border & ~mask
    for _ in range(max_iters):
        grown = binary_dilation(outside, connectivity=1) & ~mask
        if torch.equal(grown, outside):
            break
        outside = grown
    return mask | ~outside
