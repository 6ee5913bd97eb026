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
from ..utils.profiling import count
from ._kernels import BAND_EXTRACT, BAND_EXTRACT_BF16, KernelError

__all__ = ["NQ", "band_extract_flux_batch", "band_sums", "band_sums_plain",
           "band_sums_cuda", "band_sums_streamed"]

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


def _check_targets(masks, windows, r0s, c0s, dev):
    N, h, w = masks.shape
    for name, x in (("masks", masks), ("windows", windows)):
        if x is not None and (x.device != dev or x.dtype not in (torch.bool, torch.uint8)
                              or tuple(x.shape) != (N, h, w)):
            raise ValueError(f"{name}: need a bool/uint8 (N, h, w) tensor on {dev}")
    for name, x in (("r0s", r0s), ("c0s", c0s)):
        if x.device != dev or x.dtype != torch.int32 or tuple(x.shape) != (N,):
            raise ValueError(f"{name}: need an int32 (N,) tensor on {dev}")


def _check_planes(planes, where, device_type):
    """The four (T, H, W) planes: contiguous, on one device of ``device_type``,
    the value planes float32 or bfloat16 (all three of one dtype), the flags uint8."""
    images = planes[0]
    if images.device.type != device_type:
        raise ValueError(f"{where} needs {device_type.upper()} tensors, got {images.device}")
    if images.dtype not in _ENTRY:
        raise ValueError(f"images: need float32 or bfloat16, got {images.dtype}")
    for name, x, dt in zip(("images", "images_err", "backgrounds", "pixelflags"), planes,
                           (images.dtype,) * 3 + (torch.uint8,)):
        if x.device != images.device or x.dtype != dt or x.shape != images.shape \
                or x.dim() != 3 or not x.is_contiguous():
            raise ValueError(f"{name}: need a contiguous {dt} (T, H, W) tensor on "
                             f"{images.device}, got {x.dtype} {tuple(x.shape)} on {x.device}")


def _plan(masks, r0s, c0s, windows, H: int, W: int):
    """What every launch over these targets shares, built once a call: the
    frame order, the kernel's target arguments in it (mask|window bytes,
    corners, window boxes) and the corner check (a device bool, read after
    the launches so that the card is not idle while the host waits: the
    kernel reads nothing for a stamp outside the frame)."""
    N, h, w = masks.shape
    outside = ((r0s.min() < 0) | (r0s.max() > H - h) | (c0s.min() < 0)
               | (c0s.max() > W - w)) if N else None
    mw = masks.to(torch.uint8) | (_as_windows(masks, windows).to(torch.uint8) << 1)
    order = _frame_order(r0s, c0s, W)
    mw, r0s, c0s = mw[order].contiguous(), r0s[order].contiguous(), c0s[order].contiguous()
    return order, (mw, r0s, c0s, _window_bbox(mw)), outside


def _launch(planes, targets, out):
    """One launch of the instantiation for the planes' dtype on the current
    stream: sums of every target over the planes' T frames into ``out``
    (N, NQ, T), rows in the plan's frame order."""
    kernel, entry = _ENTRY[planes[0].dtype]
    T, H, W = planes[0].shape
    N, h, w = targets[0].shape
    dev = planes[0].device
    launch = getattr(kernel.lib(), entry)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(*(x.data_ptr() for x in planes), *(x.data_ptr() for x in targets),
                    out.data_ptr(), N, T, H, W, h, w, stream)
    if rc != 0:
        raise KernelError(f"{entry} launch failed: CUDA error {rc}")
    kernel.launches += 1


def _finish(out, order, outside):
    """The corner check (one host sync), then the rows back in the caller's order."""
    if outside is not None and bool(outside):
        raise ValueError("stamp corners put a stamp outside the (H, W) frame")
    return torch.empty_like(out).index_copy_(0, order, out)


def band_sums_cuda(images, images_err, backgrounds, pixelflags, masks, r0s, c0s,
                   windows=None) -> torch.Tensor:
    """The 10 sums (N, NQ, T) from the CUDA kernel, on the images' card:
    its float32 or its bfloat16 instantiation, by the dtype of ``images``."""
    planes = (images, images_err, backgrounds, pixelflags)
    _check_planes(planes, "band_sums_cuda", "cuda")
    dev = images.device
    _check_targets(masks, windows, r0s, c0s, dev)
    T, H, W = images.shape
    order, targets, outside = _plan(masks, r0s, c0s, windows, H, W)
    out = torch.empty(masks.shape[0], NQ, T, dtype=torch.float32, device=dev)
    _launch(planes, targets, out)
    return _finish(out, order, outside)


#: Frames of a host-to-device copy from pageable host memory: two pinned
#: staging buffers of this many frames of each plane (~0.87 GB at 2048x2048).
STAGE_FRAMES = 16


def _band_sums_streamed_cuda(planes, masks, r0s, c0s, windows, dev, chunk: int):
    """The kernel over host planes, ``chunk`` frames at a time on card ``dev``.

    Two device buffers of ``chunk`` frames per plane and a copy stream, so
    that the next chunk's copies need not wait for a chunk's kernel (events
    order the buffers' reuse).  Pinned planes are copied as they are;
    pageable ones go through two pinned staging buffers of ``STAGE_FRAMES``
    frames, which the host fills while the copy engine drains the other.  The plan
    (compaction, order, boxes), the output and the corner check are built
    once a call; each chunk's launch writes its sums into a (N, NQ, chunk)
    part that is copied into its columns of the output on the card (the
    kernel is unchanged: its sums for a cadence do not depend on T, so they
    equal the device path's bit for bit).  Returns once the last chunk's
    copies and launch have finished (the caller reads the sums right
    after), so that a span around the call holds the whole transfer.
    """
    T, H, W = planes[0].shape
    N = masks.shape[0]
    order, targets, outside = _plan(masks, r0s, c0s, windows, H, W)
    out = torch.empty(N, NQ, T, dtype=torch.float32, device=dev)
    n_buf = max(min(chunk, T), 1)
    bufs = [[torch.empty((n_buf, H, W), dtype=p.dtype, device=dev) for p in planes]
            for _ in range(2)]
    pinned = all(p.is_pinned() for p in planes)
    piece = min(STAGE_FRAMES, n_buf)
    stage = None if pinned else [[torch.empty((piece, H, W), dtype=p.dtype, pin_memory=True)
                                  for p in planes] for _ in range(2)]
    main = torch.cuda.current_stream(dev)
    copy = torch.cuda.Stream(dev)
    loaded, used, staged = ([torch.cuda.Event() for _ in range(2)] for _ in range(3))
    n_pieces = 0
    for i, t0 in enumerate(range(0, T, chunk)):
        k, n = i % 2, min(chunk, T - t0)
        copy.wait_event(used[k])            # the kernel of chunk i - 2 has read buffer k
        for a in range(0, n, piece):
            m, lo = min(piece, n - a), t0 + a
            if pinned:
                srcs = [p[lo:lo + m] for p in planes]
            else:
                s = n_pieces % 2
                staged[s].synchronize()     # its last copy to the card has finished
                for st, p in zip(stage[s], planes):
                    st[:m].copy_(p[lo:lo + m])
                srcs = [st[:m] for st in stage[s]]
            with torch.cuda.stream(copy):
                for b, src in zip(bufs[k], srcs):
                    b[a:a + m].copy_(src, non_blocking=True)
            if not pinned:
                staged[s].record(copy)
                n_pieces += 1
        loaded[k].record(copy)
        main.wait_event(loaded[k])
        part = torch.empty(N, NQ, n, dtype=torch.float32, device=dev)
        _launch([b[:n] for b in bufs[k]], targets, part)
        out[:, :, t0:t0 + n] = part
        used[k].record(main)
    main.synchronize()              # the last launch waited on the last chunk's copies
    if not pinned:
        count("stream_staged_bytes", sum(p.numel() * p.element_size() for p in planes))
    return _finish(out, order, outside)


def band_sums_streamed(images, images_err, backgrounds, pixelflags, masks, r0s, c0s,
                       windows=None, *, device, chunk: int = 128) -> torch.Tensor:
    """The 10 sums (N, NQ, T) of host-resident (T, H, W) planes, ``chunk``
    frames at a time on ``device`` (where the masks, corners and windows
    are, and the output goes): the kernel on each device-resident chunk on
    a card, the plain version per chunk on the CPU.  Counts one
    ``stream_passes`` and the planes' bytes in ``stream_bytes``
    (``utils.profiling``)."""
    planes = (images, images_err, backgrounds, pixelflags)
    _check_planes(planes, "band_sums_streamed (host planes)", "cpu")
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:      # where a tensor made on "cuda" lands
        dev = torch.device("cuda", torch.cuda.current_device())
    if chunk < 1:
        raise ValueError(f"chunk={chunk}: need at least one frame")
    count("stream_passes")
    count("stream_bytes", sum(p.numel() * p.element_size() for p in planes))
    if dev.type == "cuda":
        _check_targets(masks, windows, r0s, c0s, dev)
        return _band_sums_streamed_cuda(planes, masks, r0s, c0s, windows, dev, chunk)
    if dev.type != "cpu":
        raise ValueError(f"no extraction path for device {dev}")
    out = torch.empty(masks.shape[0], NQ, images.shape[0], dtype=torch.float32)
    for t0 in range(0, images.shape[0], chunk):
        out[:, :, t0:t0 + chunk] = band_sums_plain(*(p[t0:t0 + chunk] for p in planes), masks,
                                                   r0s, c0s, windows)
    return out


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
