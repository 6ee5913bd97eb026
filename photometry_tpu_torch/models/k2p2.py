"""
K2P2 pixel-mask construction for a batch of target stamps, on torch tensors.

Port of ``photometry_tpu/models/k2p2.py:build_masks_batch`` and its
helpers.  The reference writes each stage for one (h, w) stamp and
``vmap``s it; here the batch is a leading dimension written out, except the
fixed-point labeling stages, which run batch-last (h, w, N) through
``ops.labeling`` as in the reference.  Masks, ``found_mask``, ``no_flux``
and ``in_mask`` are bit-identical to the JAX package on the parity corpus
(tests/test_torch_k2p2.py).

Stages (reference k2p2v2.py line numbers as in the JAX module):
threshold from a Gaussian-KDE mode + MAD; exact DBSCAN(eps=sqrt(2));
catalog-seeded watershed on the blurred flux; 4-neighbour hole fill;
saturated-column extension; minimum-aperture fallback.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops.filters import gaussian_blur2d
from ..ops.labeling import dbscan_labels, label_components, watershed_segment
from ..utils.mathutils import nanmax, nanmedian, nanmin, nanquantile

__all__ = ["K2P2Params", "build_masks_batch"]

SATURATION_LIMIT = 7.0  #: Tmag above which (fainter) overflow extension is disabled.


class K2P2Params(NamedTuple):
    thresh: float = 0.8               #: CUT = MODE + thresh * MAD
    min_no_pixels_in_mask: int = 4
    min_for_cluster: int = 4
    ws_blur: float = 0.5
    ws_thres: float = 0.0             #: relative threshold for local maxima
    ws_footprint: int = 3
    segmentation: bool = True
    extend_overflow: bool = True


def _batch_last(x):
    return x.permute(1, 2, 0)


def _batch_first(x):
    return x.permute(2, 0, 1)


# ---------------------------------------------------------------------------
# Mode + threshold
# ---------------------------------------------------------------------------

def _kde_mode_scott(flux, valid, n_grid: int = 100, newton_iters: int = 3):
    """Gaussian-KDE mode with Scott bandwidth, per row of (N, P) pixels.

    Returns (mode, bandwidth), each (N,).
    """
    dt = flux.dtype
    n = torch.clamp(valid.sum(dim=1), min=1)
    nf = n.to(dt)
    fv = torch.where(valid, flux, torch.nan)
    flux = torch.where(valid, flux, 0.0)
    mean = torch.nansum(torch.where(valid, flux, 0.0), dim=1) / nf
    std = torch.sqrt(torch.nansum(torch.where(valid, (flux - mean[:, None]) ** 2, 0.0), dim=1)
                     / torch.clamp(n - 1, min=1).to(dt))
    q75 = nanquantile(fv, 0.75)
    q25 = nanquantile(fv, 0.25)
    iqr = (q75 - q25) / 1.349
    sigma = torch.where((iqr > 0) & (iqr < std), iqr, std)
    bw = 1.059 * sigma * nf ** (-0.2)
    bw = torch.clamp(bw, min=1e-10)

    lo = nanmin(fv) - 3 * bw
    hi = nanmax(fv) + 3 * bw
    ar = torch.arange(n_grid, dtype=dt, device=flux.device)
    grid = lo[:, None] + (hi - lo)[:, None] * ar / (n_grid - 1)

    z = (grid[:, None, :] - flux[:, :, None]) / bw[:, None, None]
    dens = torch.where(valid[:, :, None], torch.exp(-0.5 * z * z), 0.0).sum(dim=1)
    x0 = torch.take_along_dim(grid, dens.argmax(dim=1, keepdim=True), dim=1)[:, 0]

    # Second-stage fine grid around the coarse argmax (see the reference):
    step_c = (hi - lo) / (n_grid - 1)
    n_fine = 64
    arf = torch.arange(n_fine, dtype=dt, device=flux.device)
    fgrid = (x0 - step_c)[:, None] + 2 * step_c[:, None] * arf / (n_fine - 1)
    zf = (fgrid[:, None, :] - flux[:, :, None]) / bw[:, None, None]
    densf = torch.where(valid[:, :, None], torch.exp(-0.5 * zf * zf), 0.0).sum(dim=1)
    x0 = torch.take_along_dim(fgrid, densf.argmax(dim=1, keepdim=True), dim=1)[:, 0]

    # Newton refinement on the smooth KDE (analytic derivatives):
    for _ in range(newton_iters):
        u = (x0[:, None] - flux) / bw[:, None]
        w = torch.where(valid, torch.exp(-0.5 * u * u), 0.0)
        d1 = (w * (-u)).sum(dim=1) / bw
        d2 = (w * (u * u - 1.0)).sum(dim=1) / (bw * bw)
        step = torch.where(d2 < 0, d1 / d2, 0.0)
        step = torch.minimum(torch.maximum(step, -bw), bw)
        x0 = x0 - step
    return x0, bw


def _threshold(sumimages, params: K2P2Params):
    """MODE + thresh*MAD cut of each stamp's sum-image flux histogram; (N,) each."""
    flat = sumimages.reshape(sumimages.shape[0], -1)
    finite = torch.isfinite(flat) & (flat > 0)
    # Trim top 15% and absolute cut at 70000 (k2p2v2.py:402-409):
    q85 = nanquantile(torch.where(finite, flat, torch.nan), 0.85)
    valid = finite & (flat <= q85[:, None]) & (flat < 70000)
    mode, bw = _kde_mode_scott(flat, valid)
    below = finite & (flat < mode[:, None])
    mad1 = 1.482602218505602 * nanmedian(
        torch.where(below, torch.abs(flat - mode[:, None]), torch.nan))
    cut = mode + params.thresh * mad1
    any_flux = finite.any(dim=1)
    return cut, bw, any_flux


# ---------------------------------------------------------------------------
# Catalog-seeded watershed markers
# ---------------------------------------------------------------------------

def _shifted(p, dy, dx, H, W):
    return p[:, dy:dy + H, dx:dx + W]


def _local_maxima(img, footprint: int, threshold_rel: float):
    """Boolean local-maximum map of (N, H, W) images, (footprint x footprint) nbhd."""
    N, H, W = img.shape
    half = footprint // 2
    p = torch.full((N, H + 2 * half, W + 2 * half), -torch.inf, dtype=img.dtype,
                   device=img.device)
    p[:, half:half + H, half:half + W] = img
    best = torch.full_like(img, -torch.inf)
    for dy in range(footprint):
        for dx in range(footprint):
            if dy == half and dx == half:
                continue
            best = torch.maximum(best, _shifted(p, dy, dx, H, W))
    # Relative tolerance for float32 near-ties (see the reference):
    is_max = img >= best - 1e-5 * torch.abs(best)
    if threshold_rel > 0:
        is_max = is_max & (img > threshold_rel * img.amax(dim=(1, 2), keepdim=True))
    return is_max


def _catalog_marker_pix(blurred, above_cut, cat_col, cat_row, cat_tmag,
                        cat_valid, params: K2P2Params):
    """Flat pixel index of each star's marker (-1 = no marker), (N, K).

    A star claims the nearest local maximum within dist_factor*sqrt(2)
    (5 for stars at or brighter than the saturation limit, 2 for fainter).
    """
    N, H, W = blurred.shape
    maxima = (_local_maxima(blurred, params.ws_footprint, params.ws_thres)
              & above_cut).reshape(N, 1, H * W)
    yy, xx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=blurred.device),
                            torch.arange(W, dtype=torch.float32, device=blurred.device),
                            indexing="ij")
    d2 = ((xx.reshape(1, 1, -1) - cat_col[:, :, None]) ** 2
          + (yy.reshape(1, 1, -1) - cat_row[:, :, None]) ** 2)       # (N, K, HW)
    d2 = torch.where(maxima, d2, torch.inf)
    flat_idx = d2.argmin(dim=2)
    dmin = torch.sqrt(torch.take_along_dim(d2, flat_idx[:, :, None], dim=2)[:, :, 0])
    dist_factor = torch.where(cat_tmag > SATURATION_LIMIT, 2.0, 5.0)
    ok = cat_valid & (dmin < dist_factor * math.sqrt(2.0))
    return torch.where(ok, flat_idx, -1)


def _rasterize_markers(marker_pix, H: int, W: int):
    """(N, K) flat marker pixels -> (N, H, W) int32 marker images, ids 1..K.

    Where stars share a pixel the later one wins, as in the reference's
    ordered scatter; ``amax`` over the increasing ids says the same thing
    deterministically (duplicate-index ``index_put_`` on CUDA does not).
    """
    N, K = marker_pix.shape
    idx = torch.where(marker_pix >= 0, marker_pix, H * W)
    ids = torch.arange(1, K + 1, dtype=torch.int32, device=marker_pix.device).expand(N, K)
    flat = torch.zeros(N, H * W + 1, dtype=torch.int32, device=marker_pix.device)
    flat = flat.scatter_reduce(1, idx, ids, reduce="amax", include_self=True)
    return flat[:, :-1].reshape(N, H, W)


def _saturated_pixel_map(sumimage, above):
    """Columns whose above-cut pixels form a bleed trail, restricted to the
    above-cut region (reference k2p2_saturated gate, k2p2v2.py:747-800)."""
    vals = torch.where(above, sumimage, torch.nan)                 # (N, H, W)
    diffs = vals[:, 1:, :] - vals[:, :-1, :]
    colmax = nanmax(vals, dim=1)
    colmed = nanmedian(vals, dim=1)
    ratio = torch.abs(nanmedian(diffs, dim=1)) / colmax
    n_col = above.sum(dim=1)
    sat_col = (n_col >= 3) & (ratio < 0.01) & (colmed >= colmax / 2)
    return above & sat_col[:, None, :]


def _clean_marker_pix(marker_pix, blurred, patch):
    """Within each connected patch of saturated pixels keep only the marker at
    the highest blurred flux, ties broken by flat index (k2p2v2.py:193-218).

    ``patch``: (N, H, W) connected-component labels of the saturated map.
    """
    N = marker_pix.shape[0]
    HW = patch.shape[1] * patch.shape[2]
    pf = patch.reshape(N, -1)
    bf = blurred.reshape(N, -1)
    valid = marker_pix >= 0
    pidx = torch.clamp(marker_pix, min=0)
    pk = torch.where(valid, torch.take_along_dim(pf, pidx, dim=1), 0)
    sk = torch.where(valid, torch.take_along_dim(bf, pidx, dim=1), -torch.inf)
    same = (pk[:, :, None] == pk[:, None, :]) & (pk[:, :, None] > 0) & valid[:, None, :]
    best = torch.where(same, sk[:, None, :], -torch.inf).amax(dim=2)
    at_best = same & (sk[:, None, :] >= best[:, :, None])
    first = torch.where(at_best, pidx[:, None, :], HW).amin(dim=2)
    keep = valid & ((pk == 0) | ((sk >= best) & (pidx == first)))
    return torch.where(keep, marker_pix, -1)


# ---------------------------------------------------------------------------
# Saturated columns / overflow lanes
# ---------------------------------------------------------------------------

def _saturated_column_extension(sumimage, mask_main, above_cut, mags_total):
    """Extend masks along saturated (bleed) columns (k2p2v2.py:291-341),
    only where the combined magnitude of the stars in the mask is brighter
    than the saturation limit (k2p2v2.py:592-615)."""
    N, H, W = sumimage.shape
    simg = torch.where(torch.isfinite(sumimage), sumimage, -torch.inf)
    in_mask = torch.where(mask_main, sumimage, torch.nan)
    mask_max = nanmax(in_mask.reshape(N, -1))

    diffs = in_mask[:, 1:, :] - in_mask[:, :-1, :]
    ratio = torch.abs(nanmedian(diffs, dim=1)) / nanmax(in_mask, dim=1)
    col_med = nanmedian(in_mask, dim=1)
    col_has = mask_main.any(dim=1)
    saturated_col = col_has & (ratio < 0.01) & (col_med >= mask_max[:, None] / 2)

    # Row-contiguous run of above-cut pixels containing the column's peak:
    peak_row = torch.where(mask_main, simg, -torch.inf).argmax(dim=1)    # (N, W)
    rows = torch.arange(H, device=sumimage.device)[None, :, None]
    gap = ~above_cut
    below_peak = rows <= peak_row[:, None, :]
    above_peak = rows >= peak_row[:, None, :]
    lo = torch.where(gap & below_peak, rows, -1).amax(dim=1) + 1         # (N, W)
    hi = torch.where(gap & above_peak, rows, H).amin(dim=1) - 1
    run = (rows >= lo[:, None, :]) & (rows <= hi[:, None, :]) & above_cut
    add = run & saturated_col[:, None, :]

    allow = (mags_total <= SATURATION_LIMIT)[:, None, None]
    return torch.where(allow, mask_main | add, mask_main)


def _fill_holes_4(mask):
    """Fill pixels whose 4 cross-neighbours are all in the mask (k2p2v2:546-557)."""
    N, H, W = mask.shape
    p = torch.zeros(N, H + 2, W + 2, dtype=torch.float32, device=mask.device)
    p[:, 1:H + 1, 1:W + 1] = mask.to(torch.float32)
    s = (_shifted(p, 0, 1, H, W) + _shifted(p, 2, 1, H, W)
         + _shifted(p, 1, 0, H, W) + _shifted(p, 1, 2, H, W))
    return mask | ((s > 3.8) & ~mask)


# ---------------------------------------------------------------------------
# Main entry
# ---------------------------------------------------------------------------

def _mask_tail(sumimage, seg, above, any_flux, cut, bw, cat_col, cat_row,
               cat_tmag, cat_valid, target_row, target_col, collected,
               params: K2P2Params):
    """Main-basin pick, hole fill, overflow extension, fallback, flags."""
    N, H, W = sumimage.shape
    ar = torch.arange(N, device=sumimage.device)
    tr = torch.clamp(torch.round(target_row).to(torch.int32), 0, H - 1).long()
    tc = torch.clamp(torch.round(target_col).to(torch.int32), 0, W - 1).long()
    main_label = seg[ar, tr, tc]
    mask_main = (seg == main_label[:, None, None]) & (main_label > 0)[:, None, None]
    mask_size0 = mask_main.sum(dim=(1, 2))
    found = (main_label > 0) & (mask_size0 >= params.min_no_pixels_in_mask) & any_flux

    mask_main = _fill_holes_4(mask_main)

    yy, xx = torch.meshgrid(torch.arange(H, device=sumimage.device),
                            torch.arange(W, device=sumimage.device), indexing="ij")
    rr = torch.round(cat_row)
    rc = torch.round(cat_col)
    cat_r = torch.clamp(rr.to(torch.int32), 0, H - 1).long()
    cat_c = torch.clamp(rc.to(torch.int32), 0, W - 1).long()
    star_inside = cat_valid & (rr >= 0) & (rr <= H - 1) & (rc >= 0) & (rc <= W - 1)
    star_in_mask = star_inside & mask_main[ar[:, None], cat_r, cat_c]
    flux_sum = torch.where(star_in_mask, 10 ** (-0.4 * cat_tmag), 0.0).sum(dim=1)
    mags_total = torch.where(flux_sum > 0, -2.5 * torch.log10(flux_sum), torch.inf)
    if params.extend_overflow:
        mask_ext = _saturated_column_extension(sumimage, mask_main, above, mags_total)
        mask_main = torch.where(found[:, None, None], mask_ext, mask_main)

    min_ap = ((torch.abs(xx.to(torch.float32) - target_col[:, None, None]) <= 1)
              & (torch.abs(yy.to(torch.float32) - target_row[:, None, None]) <= 1)
              & collected)
    mask = torch.where(found[:, None, None], mask_main, min_ap)

    edge = torch.stack([mask[:, 0, :].any(dim=1), mask[:, -1, :].any(dim=1),
                        mask[:, :, 0].any(dim=1), mask[:, :, -1].any(dim=1)], dim=1)
    in_mask = star_inside & mask[ar[:, None], cat_r, cat_c]
    return {
        "mask": mask,
        "found_mask": found,
        "no_flux": ~any_flux,
        "edge": edge,
        "cut": cut,
        "bandwidth": bw,
        "in_mask": in_mask,
        "mask_size": mask.sum(dim=(1, 2)),
    }


def build_masks_batch(sumimages, cat_col, cat_row, cat_tmag, cat_starid,
                      cat_valid, target_row, target_col, target_tmag,
                      collected=None, params: K2P2Params = K2P2Params(),
                      debug: bool = False) -> dict:
    """K2P2 masks of N target stamps.

    sumimages: (N, h, w) float32; cat_*: (N, K) padded catalogs in stamp
    coordinates; target_*: (N,).  Returns a dict of (N, ...) tensors on the
    stamps' device: ``mask``, ``found_mask``, ``no_flux``, ``edge``,
    ``cut``, ``bandwidth``, ``in_mask``, ``mask_size``.  With ``debug``,
    also the intermediate images of the K2P2 diagnostic figure, as the
    reference's ``build_mask(debug=True)`` (k2p2v2.py:664-744): ``above``
    (pixels over the cut), ``labels`` (DBSCAN), ``seg`` (the watershed) and
    ``blurred`` (the flux that drives it).
    """
    if collected is None:
        collected = torch.isfinite(sumimages)
    H, W = sumimages.shape[1:]

    # A. threshold:
    cut, bw, any_flux = _threshold(sumimages, params)
    above = torch.where(torch.isfinite(sumimages), sumimages > cut[:, None, None], False)

    # B. DBSCAN clustering, batch-last:
    labels = _batch_first(dbscan_labels(_batch_last(above),
                                        min_samples=params.min_for_cluster))
    above2 = above & (labels > 0)

    # C. blur + markers, D. watershed (batch-last):
    if params.segmentation:
        flux_above = torch.where(above2, torch.nan_to_num(sumimages), 0.0)
        blurred = gaussian_blur2d(flux_above, params.ws_blur)
        marker_pix = _catalog_marker_pix(blurred, above2, cat_col, cat_row,
                                         cat_tmag, cat_valid, params)
        sat_maps = _saturated_pixel_map(sumimages, above2)
        patch = _batch_first(label_components(_batch_last(sat_maps)))
        marker_pix = _clean_marker_pix(marker_pix, blurred, patch)
        markers = _rasterize_markers(marker_pix, H, W)
        seg = _batch_first(watershed_segment(_batch_last(blurred), _batch_last(markers),
                                             _batch_last(above2), connectivity=1))
    else:
        blurred = torch.where(above2, torch.nan_to_num(sumimages), 0.0) if debug else None
        seg = torch.where(above2, labels, 0)

    # E. tail:
    out = _mask_tail(sumimages, seg, above, any_flux, cut, bw, cat_col, cat_row,
                     cat_tmag, cat_valid, target_row, target_col, collected, params)
    if debug:
        out.update(above=above, labels=labels, seg=seg, blurred=blurred)
    return out
