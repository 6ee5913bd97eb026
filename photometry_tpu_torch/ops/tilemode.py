"""
Sigma-clipped SExtractor mode of every tile of a stack of frames.

    grid[f, i, j] = sextractor_mode(tile (i, j) of frame f, its mask,
                                    min_fraction=min_fraction)

The per-tile statistic of the background's tiled component
(``ops/background._tiled_mode``; ``photometry_tpu/ops/background.py``
reshapes the frame into tiles and ``vmap``s ``stats.sextractor_mode``).
Frames that do not divide into tiles are padded with excluded pixels, like
photutils' Background2D.

- On a CUDA tensor the grid comes from the hand-written Hopper kernel
  ``ops/csrc/tile_mode.cu`` (:func:`tile_mode_cuda`): one launch for all
  frames, one block a tile, the whole sigma clip in shared memory.  Its
  medians are exact; its mean and standard deviation are summed in
  float64, so a clip decision can differ from the plain version's only for
  a pixel within the plain version's float32 summation error of the cut
  (the bound is in the kernel's header).
- On a CPU tensor, or with ``plain``, it is the plain torch version
  (:func:`tile_mode_plain`), which the kernel is held to on the card
  (:func:`compare_to_plain`).

A failed build or launch raises :class:`._kernels.KernelError`, and a tile
larger than one block's shared memory holds raises ``ValueError``; nothing
falls back.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import stats
from ._kernels import TILE_MODE, KernelError

__all__ = ["tile_mode", "tile_mode_plain", "tile_mode_cuda", "compare_to_plain", "Agreement"]

SIGMA = 3.0
MAXITERS = 5
#: The SExtractor-mode tolerance of the parity tests: float32 means summed
#: in another order.
RTOL = 2e-6


def tile_mode_plain(img: torch.Tensor, mask: torch.Tensor, tile: int,
                    min_fraction: float) -> torch.Tensor:
    """(F, th, tw) modes of (F, H, W) frames: the tiles padded, reshaped to
    (F, th, tw, tile^2) and handed to :func:`.stats.sextractor_mode`."""
    nf, H, W = img.shape
    th, tw = -(-H // tile), -(-W // tile)
    Hp, Wp = th * tile, tw * tile
    if (Hp, Wp) != (H, W):
        img = torch.nn.functional.pad(img, (0, Wp - W, 0, Hp - H), value=float("nan"))
        mask = torch.nn.functional.pad(mask, (0, Wp - W, 0, Hp - H), value=True)
    tiles = img.reshape(nf, th, tile, tw, tile).transpose(2, 3).reshape(nf, th, tw, tile * tile)
    mtiles = mask.reshape(nf, th, tile, tw, tile).transpose(2, 3).reshape(nf, th, tw, tile * tile)
    return stats.sextractor_mode(tiles, mask=mtiles, sigma=SIGMA, maxiters=MAXITERS,
                                 min_fraction=min_fraction)


def tile_mode_cuda(img: torch.Tensor, mask: torch.Tensor, tile: int,
                   min_fraction: float) -> torch.Tensor:
    """(F, th, tw) modes of contiguous float32 (F, H, W) frames and their bool
    exclusion mask, from one launch of the CUDA kernel."""
    dev = img.device
    if dev.type != "cuda":
        raise ValueError(f"tile_mode_cuda needs CUDA tensors, got {dev}")
    lib = TILE_MODE.lib()
    cap = lib.tile_mode_max_pixels()
    if not 1 <= tile * tile <= cap:
        raise ValueError(f"tile {tile}: the kernel takes tiles of 1 to {cap} pixels, "
                         f"what one block's shared memory holds")
    if img.dtype != torch.float32 or img.ndim != 3 or not img.is_contiguous():
        raise ValueError(f"img: need a contiguous float32 (F, H, W) tensor, got {img.dtype} "
                         f"{tuple(img.shape)}")
    if (mask.device != dev or mask.dtype != torch.bool or mask.shape != img.shape
            or not mask.is_contiguous()):
        raise ValueError(f"mask: need a contiguous bool {tuple(img.shape)} tensor on {dev}")
    nf, H, W = img.shape
    out = torch.empty(nf, -(-H // tile), -(-W // tile), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        rc = lib.tile_mode(img.data_ptr(), mask.data_ptr(), out.data_ptr(), nf, H, W, tile,
                           MAXITERS, SIGMA, min_fraction,
                           torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise KernelError(f"tile_mode launch failed: CUDA error {rc}")
    TILE_MODE.launches += 1
    return out


def tile_mode(img: torch.Tensor, mask: torch.Tensor, tile: int, min_fraction: float,
              plain: bool = False) -> torch.Tensor:
    """(F, th, tw) sigma-clipped SExtractor modes of the ``tile`` x ``tile``
    tiles of (F, H, W) frames; ``mask`` True = excluded; NaN where fewer
    than ``min_fraction`` of a tile's pixels are good, or none survives.
    The kernel for CUDA tensors, the plain version on the CPU or with
    ``plain`` (comparisons on the card)."""
    if plain or img.device.type != "cuda":
        return tile_mode_plain(img, mask, tile, min_fraction)
    return tile_mode_cuda(img.to(torch.float32).contiguous(), mask.to(torch.bool).contiguous(),
                          tile, min_fraction)


class Agreement(NamedTuple):
    """How the kernel's grid keeps to the plain version's on the same
    frames: whether the NaN patterns are equal, the finite tiles of the
    plain grid, how many of them lie outside RTOL, and (f, i, j, got, want,
    margin, bound) of each such tile that no pixel near a clip cut explains."""
    same_nan: bool
    compared: int
    outside: int
    unexplained: list


def _cut_margin(x: torch.Tensor, good: torch.Tensor) -> float:
    """Smallest relative distance, over the plain version's clip passes on
    one (1, n) tile, of a good pixel's |x - median| from sigma * std, and of
    the final skew ratio from 0.3."""
    margin = np.inf
    for _ in range(MAXITERS):
        med = stats.masked_median(x, good)
        _, _, std = stats._moments(x, good)
        thr = SIGMA * std[0]
        d = torch.abs(torch.abs(x - med) - thr)[good]
        if d.numel() and float(thr) > 0:
            margin = min(margin, float(d.min() / thr))
        good = good & (torch.abs(x - med) <= thr)
    _, mean, std = stats._moments(x, good)
    med = stats.masked_median(x, good)
    if float(std[0]) > 0:
        margin = min(margin, abs(float((mean[0] - med) / std[0]) - 0.3) / 0.3)
    return margin


def compare_to_plain(got: torch.Tensor, want: torch.Tensor, img: torch.Tensor,
                     mask: torch.Tensor, tile: int) -> Agreement:
    """Hold the kernel's (F, th, tw) grid ``got`` to the plain version's
    ``want`` of the same frames ``img`` and ``mask``, on the host.

    A tile agrees to RTOL of the larger of its mode and its good pixels'
    mean |value| (both versions round the mean alike relative to the
    values, so a mode near 0 is held to the values' scale).  A tile outside
    it is explained where the plain version's clip passes hold a pixel, or
    its skew ratio, within the kernel's rounding bound of a cut
    ((n + 2) * 2^-24 for n good pixels, ``csrc/tile_mode.cu``'s header);
    the caller bounds how many such tiles it allows."""
    g, w = got.cpu().numpy(), want.cpu().numpy()
    nf, H, W = img.shape
    pad_img = torch.nn.functional.pad(img.cpu(), (0, -W % tile, 0, -H % tile), value=np.nan)
    pad_mask = torch.nn.functional.pad(mask.cpu(), (0, -W % tile, 0, -H % tile), value=True)
    th, tw = w.shape[1:]
    tiles = pad_img.reshape(nf, th, tile, tw, tile).transpose(2, 3).reshape(nf, th, tw, -1)
    good = torch.isfinite(tiles) & ~pad_mask.reshape(nf, th, tile, tw, tile).transpose(
        2, 3).reshape(nf, th, tw, -1)
    scale = (torch.where(good, tiles.abs(), 0.0).sum(-1) / good.sum(-1).clamp(min=1)).numpy()
    del tiles, good
    with np.errstate(invalid="ignore"):
        off = np.isfinite(w) & ~(np.abs(g - w) <= RTOL * np.maximum(np.abs(w), scale))
    unexplained = []
    for f, i, j in zip(*np.nonzero(off)):
        x = pad_img[f, i * tile:(i + 1) * tile, j * tile:(j + 1) * tile].reshape(1, -1)
        good = (torch.isfinite(x) & ~pad_mask[f, i * tile:(i + 1) * tile,
                                              j * tile:(j + 1) * tile].reshape(1, -1))
        bound = (int(good.sum()) + 2) * 2.0 ** -24
        margin = _cut_margin(x, good)
        if not margin <= bound:
            unexplained.append((int(f), int(i), int(j), float(g[f, i, j]), float(w[f, i, j]),
                                margin, bound))
    return Agreement(bool(np.array_equal(np.isnan(g), np.isnan(w))), int(np.isfinite(w).sum()),
                     int(off.sum()), unexplained)
