"""
Exact k x k median filter of NaN-free float32 frames, scipy ``reflect`` borders.

The Background-Shenanigans detector of the prepare stage median-filters
every frame's residual with a 15 x 15 window
(``photometry_tpu/ops/filters.py:median_filter2d_chunked`` through
``_median_block``; the TPU's Pallas ``ops/median_pallas.py:_kernel``
computes the same, bit for bit).  Both select the order statistic by
bisection of int32 order keys, so a 3.4e38 sample (``nan_to_num`` of +inf)
cannot stall them.

- On a CUDA tensor the filter is the hand-written Hopper kernel
  ``ops/csrc/median15.cu`` (:func:`median15_cuda`), one launch for all
  frames; it takes k = 15 only.
- On a CPU tensor it is the plain torch version (:func:`median_filter_plain`):
  ``_median_block``'s shifted-stack bisection, in blocks of frames or rows
  that keep the k^2-deep stack under a byte budget.  It is also what
  ``chip_smoke.py`` holds the kernel against on the card.

Borders are numpy ``symmetric`` (the edge sample repeats), periodic with
period 2n, so frames narrower than the halo fold again as ``np.pad`` does;
``torch.nn.functional.pad(mode="reflect")`` is numpy ``reflect`` and would
shift every border window.  A CUDA tensor always goes to the kernel or
raises; nothing falls back.
"""

from __future__ import annotations

import torch

from ._kernels import MEDIAN15, KernelError
from .stats import _avg, _count, _f32_to_ordkey, _ordkey_to_f32

__all__ = ["median_filter", "median_filter_plain", "median15_cuda", "reflect_indices"]

SIZE = 15


def reflect_indices(idx: torch.Tensor, n: int) -> torch.Tensor:
    """numpy ``symmetric`` (scipy ``reflect``) extension of indices into [0, n)."""
    period = 2 * n
    idx = torch.remainder(idx, period)
    return torch.where(idx >= n, period - 1 - idx, idx)


def _symmetric_pad(x: torch.Tensor, half: int) -> torch.Tensor:
    """(F, H, W) -> (F, H + 2 half, W + 2 half), numpy ``symmetric`` padding."""
    _, H, W = x.shape
    ri = reflect_indices(torch.arange(-half, H + half, device=x.device), H)
    ci = reflect_indices(torch.arange(-half, W + half, device=x.device), W)
    return x[:, ri][:, :, ci]


def _median_block(padded: torch.Tensor, size: int, rows: int, W: int) -> torch.Tensor:
    """Exact size x size median of padded (..., rows + size - 1, W + size - 1)
    NaN-free blocks, by 8-ary bisection of the order keys (12 passes resolve
    the int32 range; stops early once every interval holds one key)."""
    stack = torch.stack([padded[..., dy:dy + rows, dx:dx + W]
                         for dy in range(size) for dx in range(size)], dim=0)
    stack = _f32_to_ordkey(stack)                      # (K, ..., rows, W) int32
    target = stack.shape[0] // 2 + 1
    lo = stack.amin(dim=0) - 1                         # count(<= lo) = 0 < target
    hi = stack.amax(dim=0)
    for _ in range(12):
        if not bool(((hi.long() - lo.long()) > 1).any()):
            break
        m4 = _avg(lo, hi)
        m2, m6 = _avg(lo, m4), _avg(m4, hi)
        mids = [_avg(lo, m2), m2, _avg(m2, m4), m4, _avg(m4, m6), m6, _avg(m6, hi)]
        new_lo, new_hi = lo, hi
        for m in mids:
            ge = _count(stack <= m[None], 0, torch.int16) >= target
            new_hi = torch.where(ge & (m < new_hi), m, new_hi)
            new_lo = torch.where(~ge & (m > new_lo), m, new_lo)
        lo, hi = new_lo, new_hi
    return _ordkey_to_f32(hi)


def median_filter_plain(x: torch.Tensor, size: int = SIZE, chunk_rows: int = 0,
                        budget_bytes: float = 3e8) -> torch.Tensor:
    """Exact size x size median of NaN-free (F, H, W) float32 frames.

    Whole frames go together while their stack fits ``budget_bytes``; larger
    frames go in row blocks (``chunk_rows``, else the JAX package's rule).
    """
    x = x.to(torch.float32)
    nf, H, W = x.shape
    half = size // 2
    out = torch.empty_like(x)
    per_row = size * size * 4 * (W + 2 * half)
    frames = max(1, int(budget_bytes // (per_row * (H + 2 * half))))
    if not chunk_rows:
        chunk_rows = max(8, int(budget_bytes / per_row))
    chunk_rows = min(chunk_rows, H) if frames == 1 else H
    for f0 in range(0, nf, frames):
        padded = _symmetric_pad(x[f0:f0 + frames], half)
        for r0 in range(0, H, chunk_rows):
            rows = min(chunk_rows, H - r0)
            out[f0:f0 + frames, r0:r0 + rows] = _median_block(
                padded[:, r0:r0 + rows + 2 * half], size, rows, W)
    return out


def median15_cuda(x: torch.Tensor) -> torch.Tensor:
    """Exact 15 x 15 median of NaN-free (F, H, W) float32 frames from the CUDA kernel."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"median15_cuda needs a CUDA tensor, got {dev}")
    if x.dtype != torch.float32 or x.ndim != 3 or not x.is_contiguous():
        raise ValueError(f"need a contiguous float32 (F, H, W) tensor, got {x.dtype} "
                         f"{tuple(x.shape)}")
    nf, H, W = x.shape
    if nf > 65535 or H < 1 or W < 1:
        raise ValueError(f"unsupported shape {tuple(x.shape)}")
    out = torch.empty_like(x)
    if nf == 0:
        return out
    lib = MEDIAN15.lib()
    with torch.cuda.device(dev):
        rc = lib.median15(x.data_ptr(), out.data_ptr(), nf, H, W,
                          torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise KernelError(f"median15 launch failed: CUDA error {rc}")
    MEDIAN15.launches += 1
    return out


def median_filter(x: torch.Tensor, size: int = SIZE, chunk_rows: int = 0,
                  budget_bytes: float = 3e8, plain: bool = False) -> torch.Tensor:
    """Exact size x size median of NaN-free (F, H, W) frames: the kernel for
    CUDA tensors (size 15 only), the plain version for CPU ones (or
    anywhere with ``plain``, for comparisons on the card)."""
    if plain or x.device.type == "cpu":
        return median_filter_plain(x, size, chunk_rows=chunk_rows, budget_bytes=budget_bytes)
    if x.device.type != "cuda":
        raise ValueError(f"no median path for device {x.device}")
    if size != SIZE:
        raise ValueError(f"the median kernel takes size {SIZE} only, got {size}")
    return median15_cuda(x.to(torch.float32).contiguous())
