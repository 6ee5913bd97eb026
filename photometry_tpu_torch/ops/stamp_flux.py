"""
Flux-only stamp extraction: per target and cadence, the sum of the finite
cube values under the target's stamp mask.

Port of ``tools/pallas_extract_demo.py:134`` (``pallas_extract_flux``, the
JAX package's worked example of per-stamp extraction, whose Pallas kernel
``_pallas_extract_padded`` at :51 streams tile-aligned stamp windows by
DMA).  For images (T, H, W), masks (N, h, w) and corners r0s, c0s (N,)::

    out[n, t] = sum of images[t, r0+i, c0+j] over mask[n, i, j] with
                r0+i < H, c0+j < W and the value finite;  NaN where none is

(±inf counts as missing).  Mask pixels beyond the image's bottom or right
edge are dropped, which is what the TPU kernel's clamped, tile-snapped
windows do.

- On a CUDA tensor the sums come from the hand-written Hopper kernel
  ``ops/csrc/stamp_flux.cu`` (:func:`stamp_flux_cuda`), which takes the
  targets in frame order (:func:`in_frame_order`) and gives them back in
  the caller's.
- On a CPU tensor they come from torch gathers in target chunks of bounded
  size (:func:`stamp_flux_plain`), also what ``chip_smoke.py`` holds the
  kernel against on the card.

:func:`stamp_extract_flux` keeps the JAX function's domain (T a multiple
of 8; the TPU's padded window no larger than the image) and refuses
corners below zero, which no caller draws.  A CUDA tensor always goes to
the kernel or raises; nothing falls back.
"""

from __future__ import annotations

import torch

from ._kernels import STAMP_FLUX, KernelError
from .bandext import _frame_order

__all__ = ["stamp_extract_flux", "stamp_flux_plain", "stamp_flux_cuda", "in_frame_order"]

T_CHUNK = 8                 #: the JAX function's cadence granularity (T % 8 == 0)

#: Elements per gathered (T, n, h, w) block of the plain version.
_PLAIN_BLOCK = 1 << 24


def stamp_flux_plain(images, masks, r0s, c0s) -> torch.Tensor:
    """(N, T) float32 masked finite sums by torch gathers."""
    T, H, W = images.shape
    N, h, w = masks.shape
    dev = images.device
    masks = masks.to(torch.bool)
    ii = torch.arange(h, device=dev)
    jj = torch.arange(w, device=dev)
    out = torch.empty(N, T, dtype=torch.float32, device=dev)
    step = max(1, _PLAIN_BLOCK // max(T * h * w, 1))
    for a in range(0, N, step):
        b = min(a + step, N)
        rows = r0s[a:b].long()[:, None] + ii                        # (n, h)
        cols = c0s[a:b].long()[:, None] + jj                        # (n, w)
        inside = masks[a:b] & (rows < H)[:, :, None] & (cols < W)[:, None, :]
        st = images[:, rows.clamp(max=H - 1)[:, :, None],
                    cols.clamp(max=W - 1)[:, None, :]].to(torch.float32)   # (T, n, h, w)
        fin = inside[None] & torch.isfinite(st)
        total = torch.where(fin, st, 0.0).sum(dim=(2, 3))
        n_fin = fin.sum(dim=(2, 3))
        out[a:b] = torch.where(n_fin > 0, total, torch.nan).T
    return out


def in_frame_order(fn, images, masks, r0s, c0s) -> torch.Tensor:
    """``fn(images, masks, r0s, c0s)`` -> (N, T) run on the targets in frame
    order (row-major corners, ``bandext._frame_order``), its rows put back
    in the caller's order.  The kernel's blocks that run together then read
    nearby rows of a plane, and a window two targets share is read while
    it is still in L2; a target's sum does not depend on its place."""
    order = _frame_order(r0s, c0s, images.shape[2])
    out = fn(images, masks[order].contiguous(), r0s[order].contiguous(),
             c0s[order].contiguous())
    return torch.empty_like(out).index_copy_(0, order, out)


def _launch(images, masks, r0s, c0s) -> torch.Tensor:
    """One launch of the kernel on checked inputs, the targets in the order given."""
    dev = images.device
    T, H, W = images.shape
    N, h, w = masks.shape
    out = torch.empty(N, T, dtype=torch.float32, device=dev)
    lib = STAMP_FLUX.lib()
    with torch.cuda.device(dev):
        cap = lib.stamp_flux_max_pixels()
        if h * w > cap:
            raise KernelError(f"stamp_flux: a {h} x {w} mask exceeds the {cap} pixel offsets "
                              f"one block's shared memory holds")
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.stamp_flux(images.data_ptr(), masks.data_ptr(), r0s.data_ptr(), c0s.data_ptr(),
                            out.data_ptr(), N, T, H, W, h, w, stream)
    if rc != 0:
        raise KernelError(f"stamp_flux launch failed: CUDA error {rc}")
    STAMP_FLUX.launches += 1
    return out


def stamp_flux_cuda(images, masks, r0s, c0s) -> torch.Tensor:
    """(N, T) float32 masked finite sums from the CUDA kernel, on the images' card."""
    dev = images.device
    if dev.type != "cuda":
        raise ValueError(f"stamp_flux_cuda needs CUDA tensors, got {dev}")
    N = masks.shape[0]
    if images.dtype != torch.float32 or not images.is_contiguous() or images.dim() != 3:
        raise ValueError(f"images: need a contiguous float32 (T, H, W) tensor, got "
                         f"{images.dtype}")
    if masks.device != dev or masks.dtype not in (torch.bool, torch.uint8) or masks.dim() != 3:
        raise ValueError(f"masks: need a bool/uint8 (N, h, w) tensor on {dev}")
    for name, x in (("r0s", r0s), ("c0s", c0s)):
        if x.device != dev or x.dtype != torch.int32 or tuple(x.shape) != (N,):
            raise ValueError(f"{name}: need an int32 ({N},) tensor on {dev}")
    # Checked after the launch, so that the card is not idle while the host
    # waits; the kernel reads nothing for a target with a negative corner.
    negative = ((r0s.min() < 0) | (c0s.min() < 0)) if N else None
    if masks.dtype == torch.bool:
        masks = masks.view(torch.uint8)
    out = in_frame_order(_launch, images, masks, r0s, c0s)
    if N and bool(negative):
        raise ValueError("stamp corners must not be negative")
    return out


def stamp_extract_flux(images, masks, r0s, c0s, h: int, w: int) -> torch.Tensor:
    """Masked stamp sums: (T, H, W) cube x (N, h, w) masks -> (N, T) fluxes.

    The counterpart of the JAX package's ``pallas_extract_flux``: NaN and
    ±inf are missing; a cadence whose in-mask pixels are all missing is
    NaN.  ``masks``, ``r0s`` and ``c0s`` go to the images' device.  Raises
    ``ValueError`` where the JAX function does (T not a multiple of 8; the
    padded window (ceil8(h+7), ceil128(w+127)) larger than the image) and
    for corners below zero.
    """
    T, H, W = images.shape
    hp = -(-(h + 7) // 8) * 8
    wp = -(-(w + 127) // 128) * 128
    if hp > H or wp > W:
        raise ValueError("padded stamp window exceeds image size")
    if T % T_CHUNK:
        raise ValueError(f"T must be a multiple of {T_CHUNK}")
    dev = images.device
    masks = torch.as_tensor(masks, device=dev)
    r0s = torch.as_tensor(r0s, device=dev).to(torch.int32)
    c0s = torch.as_tensor(c0s, device=dev).to(torch.int32)
    if tuple(masks.shape[1:]) != (h, w) or r0s.shape != masks.shape[:1] \
            or c0s.shape != masks.shape[:1]:
        raise ValueError(f"masks {tuple(masks.shape)} and corners {tuple(r0s.shape)}, "
                         f"{tuple(c0s.shape)} do not match N stamps of ({h}, {w})")
    if dev.type == "cuda":
        return stamp_flux_cuda(images, masks, r0s, c0s)   # refuses negative corners itself
    if masks.shape[0] and bool((r0s.min() < 0) | (c0s.min() < 0)):
        raise ValueError("stamp corners must not be negative")
    if dev.type == "cpu":
        return stamp_flux_plain(images.to(torch.float32), masks, r0s, c0s)
    raise ValueError(f"no stamp extraction path for device {dev}")
