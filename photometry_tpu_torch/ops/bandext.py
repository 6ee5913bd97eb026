"""
Banded aperture extraction: the port of ``photometry_tpu/ops/bandext.py``.

Every target's aperture sums over every cadence, as 10 masked reductions
per (target, cadence) followed by the shared epilogue :func:`_combine`,
which applies the NaN / all-zero / all-bad semantics and the 1-based
centroid origin of ``core.engine.extract_flux_core`` (reference
BasePhotometry.py:1323-1414).

- On a CUDA tensor the sums come from the hand-written Hopper kernel
  ``ops/csrc/band_extract.cu`` (:func:`band_sums_cuda`), which replaces the
  TPU's Pallas ``_band_kernel``; see the source note there for why the
  TPU's cell/piece layout has no counterpart on the card.
- On a CPU tensor they come from the plain torch gather formulation
  (:func:`band_sums_plain`, the formulation of the reference's
  engine.py:451-495).  It is also what ``chip_smoke.py`` holds the kernel
  against on the card.

The value planes (images, errors, backgrounds) are float32 or bfloat16,
all three of one dtype; sums are float32 either way.  A bfloat16 cube goes
to the kernel's bfloat16 instantiation as it is (no float32 copy), and the
plain version widens only the gathered stamps.

A CUDA tensor always goes to the kernel or raises; nothing falls back.
"""

from __future__ import annotations

import torch

from ..quality import PixelQualityFlags
from ._kernels import BAND_EXTRACT, BAND_EXTRACT_BF16, KernelError

__all__ = ["NQ", "band_extract_flux_batch", "band_sums", "band_sums_plain",
           "band_sums_cuda"]

NQ = 10     #: reductions per (target, cadence), in the order of the kernel's note

#: Elements per gathered (T, n, h, w) block of the plain version.
_PLAIN_BLOCK = 1 << 24


def _as_windows(masks, windows):
    if windows is None:
        return torch.ones_like(masks, dtype=torch.bool)
    return windows.to(torch.bool)


def band_sums_plain(images, images_err, backgrounds, pixelflags, masks, r0s, c0s,
                    windows=None) -> torch.Tensor:
    """The 10 sums (N, NQ, T) by torch gathers, in target chunks of bounded size."""
    T = images.shape[0]
    N, h, w = masks.shape
    masks = masks.to(torch.bool)
    windows = _as_windows(masks, windows)
    dev = images.device
    ii = torch.arange(h, device=dev)
    jj = torch.arange(w, device=dev)
    out = torch.empty(N, NQ, T, dtype=torch.float32, device=dev)
    step = max(1, _PLAIN_BLOCK // max(T * h * w, 1))
    for a in range(0, N, step):
        b = min(a + step, N)
        ridx = (r0s[a:b].long()[:, None] + ii)[:, :, None]          # (n, h, 1)
        cidx = (c0s[a:b].long()[:, None] + jj)[:, None, :]          # (n, 1, w)
        st = images[:, ridx, cidx].to(torch.float32)                # (T, n, h, w)
        se = images_err[:, ridx, cidx].to(torch.float32)
        sb = backgrounds[:, ridx, cidx].to(torch.float32)
        sf = pixelflags[:, ridx, cidx]
        m = masks[a:b][None]
        fin = m & torch.isfinite(st)
        wgt = torch.where(fin & (st > 0), st, 0.0)
        mb = m & torch.isfinite(sb)
        shen = ((sf & PixelQualityFlags.BackgroundShenanigans) != 0) & windows[a:b][None]
        q = [torch.where(fin, st, 0.0), fin, m & (st == 0), wgt, wgt * jj.to(wgt.dtype),
             wgt * ii.to(wgt.dtype)[:, None], torch.where(m & torch.isfinite(se), se * se, 0.0),
             torch.where(mb, sb, 0.0), mb, shen]
        sums = torch.stack([x.to(torch.float32).sum(dim=(2, 3)) for x in q])  # (NQ, T, n)
        out[a:b] = sums.permute(2, 0, 1)
    return out


def _window_bbox(mw: torch.Tensor) -> torch.Tensor:
    """(N, 4) int32 [i_lo, i_hi, j_lo, j_hi) of the nonzero bytes of each stamp."""
    N, h, w = mw.shape
    nz = mw != 0
    rows = nz.any(dim=2).to(torch.int32)
    cols = nz.any(dim=1).to(torch.int32)
    any_ = rows.any(dim=1)
    i_lo = rows.argmax(dim=1)
    i_hi = h - rows.flip(1).argmax(dim=1)
    j_lo = cols.argmax(dim=1)
    j_hi = w - cols.flip(1).argmax(dim=1)
    box = torch.stack([i_lo, i_hi, j_lo, j_hi], dim=1)
    return torch.where(any_[:, None], box, 0).to(torch.int32).contiguous()


def _frame_order(r0s, c0s, W: int):
    """The targets in frame order (row-major stamp corners): the kernel's
    blocks that run together then read nearby rows of each plane.  A
    target's sums do not depend on its place in the launch;
    ``out.index_copy_(0, order, sums)`` puts the rows back."""
    return torch.argsort(r0s.long() * W + c0s.long())


#: The kernel's instantiation and entry point for each dtype of the value planes.
_ENTRY = {torch.float32: (BAND_EXTRACT, "band_extract_sums"),
          torch.bfloat16: (BAND_EXTRACT_BF16, "band_extract_sums_bf16")}


def band_sums_cuda(images, images_err, backgrounds, pixelflags, masks, r0s, c0s,
                   windows=None) -> torch.Tensor:
    """The 10 sums (N, NQ, T) from the CUDA kernel, on the images' card:
    its float32 or its bfloat16 instantiation, by the dtype of ``images``."""
    dev = images.device
    if dev.type != "cuda":
        raise ValueError(f"band_sums_cuda needs CUDA tensors, got {dev}")
    if images.dtype not in _ENTRY:
        raise ValueError(f"images: need float32 or bfloat16, got {images.dtype}")
    kernel, entry = _ENTRY[images.dtype]
    T, H, W = images.shape
    N, h, w = masks.shape
    for name, x, dt in (("images", images, images.dtype),
                        ("images_err", images_err, images.dtype),
                        ("backgrounds", backgrounds, images.dtype),
                        ("pixelflags", pixelflags, torch.uint8)):
        if x.device != dev or x.dtype != dt or tuple(x.shape) != (T, H, W) \
                or not x.is_contiguous():
            raise ValueError(f"{name}: need a contiguous {dt} (T, H, W) tensor on {dev}, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    for name, x in (("masks", masks), ("windows", windows)):
        if x is not None and (x.device != dev or x.dtype not in (torch.bool, torch.uint8)
                              or tuple(x.shape) != (N, h, w)):
            raise ValueError(f"{name}: need a bool/uint8 (N, h, w) tensor on {dev}")
    for name, x in (("r0s", r0s), ("c0s", c0s)):
        if x.device != dev or x.dtype != torch.int32 or tuple(x.shape) != (N,):
            raise ValueError(f"{name}: need an int32 (N,) tensor on {dev}")
    # Checked after the launch, so the card is not idle while the host
    # waits: the kernel reads nothing for a stamp outside the frame.
    outside = ((r0s.min() < 0) | (r0s.max() > H - h) | (c0s.min() < 0)
               | (c0s.max() > W - w)) if N else None
    mw = masks.to(torch.uint8) | (_as_windows(masks, windows).to(torch.uint8) << 1)
    order = _frame_order(r0s, c0s, W)
    mw, r0s, c0s = mw[order].contiguous(), r0s[order].contiguous(), c0s[order].contiguous()
    bbox = _window_bbox(mw)
    out = torch.empty(N, NQ, T, dtype=torch.float32, device=dev)
    launch = getattr(kernel.lib(), entry)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(images.data_ptr(), images_err.data_ptr(), backgrounds.data_ptr(),
                    pixelflags.data_ptr(), mw.data_ptr(), r0s.data_ptr(), c0s.data_ptr(),
                    bbox.data_ptr(), out.data_ptr(), N, T, H, W, h, w, stream)
    if rc != 0:
        raise KernelError(f"{entry} launch failed: CUDA error {rc}")
    kernel.launches += 1
    if N and bool(outside):
        raise ValueError("stamp corners put a stamp outside the (H, W) frame")
    return torch.empty_like(out).index_copy_(0, order, out)


def band_sums(images, images_err, backgrounds, pixelflags, masks, r0s, c0s,
              windows=None) -> torch.Tensor:
    """The 10 sums (N, NQ, T): the kernel for CUDA tensors, the plain version for CPU ones."""
    if images.device.type == "cuda":
        return band_sums_cuda(images, images_err, backgrounds, pixelflags, masks, r0s, c0s,
                              windows)
    if images.device.type == "cpu":
        return band_sums_plain(images, images_err, backgrounds, pixelflags, masks, r0s, c0s,
                               windows)
    raise ValueError(f"no extraction path for device {images.device}")


def _combine(Q, r0s, c0s, mask_size):
    """Per-target sums (N, NQ, T) -> flux, flux_err, flux_bkg (N, T),
    centroid (N, T, 2) in 1-based CCD coords and shenanigans_any (N, T),
    with the semantics of the reference's ``_combine`` (bandext.py:381-420)."""
    total, n_fin, n_zero, wsum, mom_c, mom_r, err2, bsum, bn, shen = Q.unbind(1)
    all_zero = n_zero >= mask_size[:, None] - 0.5
    all_bad = (n_fin < 0.5) | all_zero
    flux = torch.where(all_bad, torch.nan, total)
    ferr = torch.where(all_bad, torch.nan, torch.sqrt(err2))
    den = torch.clamp(wsum, min=1e-30)
    cx = (mom_c + (c0s.to(wsum.dtype) + 1.0)[:, None] * wsum) / den
    cy = (mom_r + (r0s.to(wsum.dtype) + 1.0)[:, None] * wsum) / den
    cent = torch.where(wsum[..., None] > 0, torch.stack([cx, cy], dim=-1), torch.nan)
    fbkg = torch.where(bn > 0.5, bsum, torch.nan)
    return flux, ferr, fbkg, cent, shen > 0.5


def band_extract_flux_batch(images, images_err, backgrounds, pixelflags, masks, r0s, c0s,
                            h: int, w: int, windows=None):
    """Aperture sums of N targets over all T cadences; same outputs as the
    reference's ``band_extract_flux_batch`` / ``extract_flux_core``.

    images/images_err/backgrounds (T, H, W) float32 or bfloat16 (all three
    of one dtype), pixelflags (T, H, W) uint8; masks (N, h, w) bool; r0s/c0s (N,) int32 stamp corners;
    ``windows`` (N, h, w) bool limits the shenanigans flag to each target's
    logical stamp.  Returns flux, flux_err, flux_bkg (N, T), centroid
    (N, T, 2) and shenanigans_any (N, T), on the images' device.
    """
    return _extract(band_sums, images, images_err, backgrounds, pixelflags, masks, r0s, c0s,
                    h, w, windows)


def _extract(sums, images, images_err, backgrounds, pixelflags, masks, r0s, c0s, h, w,
             windows):
    """``_combine`` of the sums that ``sums`` (band_sums or band_sums_plain) computes."""
    if tuple(masks.shape[1:]) != (h, w):
        raise ValueError(f"masks shape {tuple(masks.shape[1:])} != stamp ({h}, {w})")
    Q = sums(images, images_err, backgrounds, pixelflags, masks, r0s, c0s, windows)
    mask_size = masks.reshape(masks.shape[0], -1).to(torch.float32).sum(dim=1)
    return _combine(Q, r0s, c0s, mask_size)
