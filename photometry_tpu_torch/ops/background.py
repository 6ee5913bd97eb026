"""
Sky-background estimation for TESS full-frame images, on torch tensors.

Port of ``photometry_tpu/ops/background.py`` (reference
photometry/backgrounds.py:52-206): a radial component for the corner glow
(the mode of log-flux in rings about the camera centre, median-smoothed
over rings and mapped back to 2-D by a natural cubic spline) iterated
``bkgiters`` times against a tiled 2-D SExtractor-mode component (sigma
clipped per tile, 3x3 NaN-median filtered over the tile grid, empty tiles
filled from their neighbours, cubic B-spline zoomed back to pixels).

The JAX package ``vmap``s one frame's program over the chunk; here every
step is written for a (F, H, W) chunk at once, so a chunk is one batched
program.  The ring modes' count tables come from the segment-histogram
kernel on a card (``ops/seghist.py``), the tile modes from the tile-mode
kernel (``ops/tilemode.py``).  The ``lax.scan`` forward and
backward fill of empty rings becomes a ``cummax`` of valid indices and a
gather.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils.mathutils import moving_median_central, nanmedian, nanmin
from ..utils.profiling import count
from ._kernels import TILE_MODE
from .median15 import _symmetric_pad
from .spline import eval_natural_spline, make_natural_spline
from .stats import segment_kde_mode
from .tilemode import tile_mode
from .zoom import spline_zoom

__all__ = ["estimate_background", "radial_coordinates", "default_hist_stride",
           "CAMERA_CENTRE_XY"]

#: Pixel coordinates of the TESS camera centre w.r.t. each (camera, ccd),
#: from sector-1 WCS solutions (reference backgrounds.py:121-138).  Zero-based
#: "real" CCD coordinates (the column includes the +44 science-area offset).
CAMERA_CENTRE_XY = {
    (1, 1): [2158.222313, 2099.523364],
    (1, 2): [-5.653058, 2098.018608],
    (1, 3): [2141.511437, 2099.868226],
    (1, 4): [-22.406442, 2100.116443],
    (2, 1): [2148.588316, 2094.033024],
    (2, 2): [-16.806140, 2095.810070],
    (2, 3): [2151.351646, 2105.747100],
    (2, 4): [-13.118570, 2105.982211],
    (3, 1): [2152.175481, 2092.337442],
    (3, 2): [-10.494413, 2093.108135],
    (3, 3): [2145.029218, 2107.883573],
    (3, 4): [-17.374782, 2105.296746],
    (4, 1): [2149.259760, 2091.433315],
    (4, 2): [-12.906931, 2093.350054],
    (4, 3): [2148.906766, 2110.730620],
    (4, 4): [-14.629676, 2111.341670],
}


def radial_coordinates(shape, camera: int, ccd: int, col_offset: int = 44) -> np.ndarray:
    """Distance (pixels) of every pixel from the TESS camera centre, float32.

    ``col_offset`` is the science-area column offset of real TESS FFIs.
    """
    xycen = CAMERA_CENTRE_XY.get((camera, ccd))
    if xycen is None:
        raise ValueError(f"Invalid CAMERA or CCD: CAMERA={camera}, CCD={ccd}")
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]].astype(np.float64)
    return np.hypot(xx + col_offset - xycen[0], yy - xycen[1]).astype(np.float32)


def default_hist_stride(shape, device) -> int:
    """The JAX package's rule: the ring-mode histograms take every second
    row and column off the CPU on frames of >= 2 Mpx, else every pixel."""
    return 2 if (shape[0] * shape[1] >= 2_000_000
                 and torch.device(device).type != "cpu") else 1


# ---------------------------------------------------------------------------
# Radial component
# ---------------------------------------------------------------------------

def _fill_from_valid(modes: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Each invalid ring takes the last valid mode before it, else the
    first after it, else NaN (the JAX forward/backward scan)."""
    n = modes.shape[-1]
    idx = torch.arange(n, device=modes.device).expand_as(modes)
    fwd_i = torch.cummax(torch.where(valid, idx, -1), dim=-1).values
    rev = torch.where(valid, n - 1 - idx, -1).flip(-1)
    bwd_i = (n - 1 - torch.cummax(rev, dim=-1).values).flip(-1)       # n where none
    fwd = torch.where(fwd_i >= 0, torch.gather(modes, -1, fwd_i.clamp(min=0)), torch.nan)
    bwd = torch.where(bwd_i < n, torch.gather(modes, -1, bwd_i.clamp(max=n - 1)), torch.nan)
    return torch.where(valid, modes, torch.where(torch.isfinite(fwd), fwd, bwd))


def _radial_component(img, mask, r, ring_idx, n_rings: int, bin_centers, smooth: int,
                      hist_stride: int = 1, plain: bool = False):
    """Radial corner-glow profiles of (F, H, W) frames on the radius image.

    ``hist_stride`` subsamples the mode histograms' input pixels (every
    stride-th row and column); the profile is evaluated at full resolution.
    """
    nf = img.shape[0]
    pix = torch.where(mask, torch.nan, img)
    zeropoint = (-nanmin(pix.reshape(nf, -1), dim=-1) + 1.0)[:, None, None]
    logpix = torch.log10(img + zeropoint)
    s = hist_stride
    modes = segment_kde_mode(logpix[:, ::s, ::s].reshape(nf, -1),
                             ring_idx[::s, ::s].reshape(-1), n_rings,
                             mask=mask[:, ::s, ::s].reshape(nf, -1), min_count=8,
                             plain=plain)
    if smooth:
        modes = moving_median_central(modes, smooth, dim=-1)
    valid = torch.isfinite(modes)
    filled = _fill_from_valid(modes, valid)
    filled = torch.where(torch.isfinite(filled), filled, 0.0)
    prof = eval_natural_spline(make_natural_spline(bin_centers, filled), r, clamp=True)
    bkg_radial = torch.pow(10.0, prof) - zeropoint
    ok = (valid.sum(dim=-1) >= 3)[:, None, None]
    return torch.where(ok, bkg_radial, 0.0)


# ---------------------------------------------------------------------------
# Tiled SExtractor-mode component
# ---------------------------------------------------------------------------

def _nan_median3(grid: torch.Tensor) -> torch.Tensor:
    """3x3 NaN-median filter of (F, th, tw) tile grids, symmetric edges
    (scipy 'reflect', the filter photutils applies to the mesh)."""
    th, tw = grid.shape[-2:]
    p = _symmetric_pad(grid, 1)
    shifts = torch.stack([p[:, dy:dy + th, dx:dx + tw] for dy in range(3) for dx in range(3)], 0)
    return nanmedian(shifts, dim=0)


def _fill_nan_tiles(grid: torch.Tensor, iters: int = 16) -> torch.Tensor:
    """Replace NaN tiles by the mean of their finite neighbours, ``iters``
    times; what is still NaN then takes the frame's median tile."""
    th, tw = grid.shape[-2:]
    for _ in range(iters):
        p = torch.nn.functional.pad(grid, (1, 1, 1, 1), value=float("nan"))
        shifts = torch.stack([p[:, dy:dy + th, dx:dx + tw]
                              for dy in range(3) for dx in range(3)], 0)
        fin = torch.isfinite(shifts)
        cnt = fin.sum(dim=0)
        mean = torch.where(fin, shifts, 0.0).sum(dim=0) / torch.clamp(cnt, min=1)
        grid = torch.where(torch.isnan(grid) & (cnt > 0), mean, grid)
    med = nanmedian(grid.reshape(grid.shape[0], -1), dim=-1)[:, None, None]
    return torch.where(torch.isnan(grid), med, grid)


def _tiled_mode(img, mask, tile: int, exclude_fraction: float, plain: bool = False):
    """Per-tile sigma-clipped SExtractor mode of (F, H, W) frames, filtered
    and zoomed back to pixels.  Frames that do not divide into tiles are
    padded with excluded NaN pixels, like photutils' Background2D.  The
    modes come from the tile-mode kernel on a card (``ops/tilemode.py``),
    from the plain version on the CPU or with ``plain``."""
    H, W = img.shape[-2:]
    grid = tile_mode(img, mask, tile, 1.0 - exclude_fraction, plain=plain)
    grid = _fill_nan_tiles(_nan_median3(grid))
    th, tw = grid.shape[-2:]
    return spline_zoom(grid, (th * tile, tw * tile))[:, :H, :W]


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------

def _ring_geometry(r_host: np.ndarray, radial_cutoff: float, radial_pixel_step: float):
    """Ring edges for the radius image, with the sub-CCD fallback of rings
    about the frame corner farthest from the camera centre."""
    H, W = r_host.shape
    rmax = float(np.max(r_host))
    bins = np.arange(radial_cutoff, rmax + radial_pixel_step, radial_pixel_step)
    if len(bins) < 4:
        # The camera-centre radius range inside a sub-CCD frame spans too
        # few ring steps to resolve the glow: rings about the frame corner
        # farthest from the camera centre instead, the step scaled to the
        # frame diagonal (the JAX package's fallback, background.py:264-283).
        corner_r = {(0, 0): r_host[0, 0], (0, W - 1): r_host[0, -1],
                    (H - 1, 0): r_host[-1, 0], (H - 1, W - 1): r_host[-1, -1]}
        gy, gx = max(corner_r, key=corner_r.get)
        yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
        r_host = np.hypot(yy - gy, xx - gx).astype(np.float32)
        radial_pixel_step = max(2, int(round(float(np.hypot(H, W)) / 48)))
        radial_cutoff = 0.0
        rmax = float(np.max(r_host))
        bins = np.arange(0.0, rmax + radial_pixel_step, radial_pixel_step)
    return r_host, bins, radial_cutoff, radial_pixel_step


def estimate_background(images: torch.Tensor, mask: Optional[torch.Tensor] = None,
                        camera: Optional[int] = None, ccd: Optional[int] = None,
                        flux_cutoff: float = 8e4, bkgiters: int = 3,
                        radial_cutoff: float = 2400, radial_pixel_step: int = 15,
                        radial_smooth: int = 3, tile: int = 64, col_offset: int = 44,
                        radius_image: Optional[np.ndarray] = None,
                        hist_stride: Optional[int] = None, plain: bool = False):
    """Sky background of a stack of FFIs, on the images' device.

    Parameters:
        images: (F, H, W) or (H, W) tensor of calibrated flux (e-/s).
        mask: optional boolean tensor (same shape or broadcastable), True = exclude.
        camera, ccd: TESS camera/CCD for the radial component; without them
            and without ``radius_image`` only the tiled component runs (the
            reference's behaviour for non-TESS images, backgrounds.py:154-157).
        radius_image: optional (H, W) radius map, overrides camera/ccd.
        flux_cutoff: pixels brighter than this are excluded.
        tile: tile size of the 2-D component (64 for real FFIs).
        hist_stride: subsampling of the ring-mode histograms; None takes
            :func:`default_hist_stride`.
        plain: build the ring histograms and the tile modes with the plain
            versions on any device (for comparisons on the card).

    Returns:
        (bkg, mask_used): the background, and the boolean exclusion mask applied.

    The frames whose tile modes the kernel fitted add to the counter
    ``background_kernel_frames`` (``utils.profiling``) once a call, read
    from the kernel's launch count; a call on the plain path adds 0.
    """
    images = images.to(torch.float32)
    dev = images.device
    squeeze = images.ndim == 2
    if squeeze:
        images = images[None]
    nf, H, W = images.shape
    base_mask = ~torch.isfinite(images) | (images > flux_cutoff) | (images < 0)
    if mask is not None:
        base_mask = base_mask | mask.to(device=dev, dtype=torch.bool)

    use_radial = radius_image is not None or camera is not None
    if use_radial:
        if radius_image is None:
            radius_image = radial_coordinates((H, W), camera, ccd, col_offset)
        r_host, bins, radial_cutoff, radial_pixel_step = _ring_geometry(
            np.asarray(radius_image, np.float32), radial_cutoff, radial_pixel_step)
        use_radial = len(bins) >= 4
    bkg_radial = torch.zeros_like(images)
    bkg_square = torch.zeros_like(images)
    if use_radial:
        n_rings = len(bins) - 1
        bin_centers = torch.as_tensor(bins[1:] - radial_pixel_step / 2, dtype=torch.float32,
                                      device=dev)
        rel = (r_host - np.float32(radial_cutoff)) / np.float32(radial_pixel_step)
        ring_idx = np.clip(rel.astype(np.int32), -1, n_rings - 1)
        ring_idx = np.where(r_host < np.float32(radial_cutoff), -1, ring_idx).astype(np.int32)
        ring_idx = torch.from_numpy(ring_idx).to(dev)
        r = torch.from_numpy(r_host).to(dev)
        stride = default_hist_stride((H, W), dev) if hist_stride is None else hist_stride
    tile = min(tile, H, W)
    launches = TILE_MODE.launches
    for _ in range(bkgiters if use_radial else 1):
        if use_radial:
            bkg_radial = _radial_component(images - bkg_square, base_mask, r, ring_idx,
                                           n_rings, bin_centers, radial_smooth,
                                           hist_stride=stride, plain=plain)
        bkg_square = _tiled_mode(images - bkg_radial, base_mask, tile, exclude_fraction=0.5,
                                 plain=plain)
    count("background_kernel_frames", nf if TILE_MODE.launches > launches else 0)
    total = bkg_radial + bkg_square
    bkg = torch.where(base_mask.reshape(nf, -1).all(dim=-1)[:, None, None], torch.nan, total)
    if squeeze:
        return bkg[0], base_mask[0]
    return bkg, base_mask
