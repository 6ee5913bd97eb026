"""
Per-target diagnostic figures behind ``--plot``.

Port of ``photometry_tpu/diagnostics.py`` (reference BasePhotometry.py:394-397,
1021-1027): figures land in ``<output>/plots/<starid:011d>/``.

- every method: ``sumimage``, the sum image with the target marked;
- aperture: ``masks_flux``, the K2P2 5-panel (sum image, significant flux,
  clustering + watershed, extracted clusters, final masks;
  k2p2v2.py:664-744), from the mask builder re-run on the target's stamp
  with ``debug=True`` (:func:`k2p2_debug`);
- psf and linpsf: ``psf_fit``, image | fit | residual at the middle
  cadence with the minimum aperture outlined (psf_photometry.py:178-185,
  linpsf_photometry.py:174-194), from the ``diag_fit`` the extractor keeps
  with ``keep_diag=True``;
- halo: ``<starid>_weightmap_<k>``, SymLog TV-min weight maps per time
  segment (halo_photometry.py:229-241).

The figures are host matplotlib, imported (through ``plots``) only when a
figure is drawn: :func:`k2p2_debug`, the one piece of device work (the K2P2
re-run of one stamp, on the context's device), needs none.  A failed figure
is logged and skipped, except what says the port or the card cannot do
the work (the dispatcher's ``_PROPAGATE``), which propagates as it does
from the photometry.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from .core.dispatcher import _PROPAGATE

logger = logging.getLogger(__name__)

__all__ = ["plot_target_diagnostics", "target_plot_folder", "k2p2_debug"]


def target_plot_folder(base_folder: str, starid: int) -> str:
    """``<base>/plots/<starid:011d>`` (BasePhotometry.py:396)."""
    return os.path.join(base_folder, "plots", f"{int(starid):011d}")


def _target_stamp_position(res, ctx):
    """Main-target (row, col) in stamp coordinates."""
    row, col = ctx.target_position(res.target["ra"], res.target["decl"])
    s = res.stamp
    return float(row) - s[0], float(col) - s[2]


def plot_sumimage(res, ctx, folder: str) -> str:
    """Sum image + target marker (BasePhotometry.py:1021-1027)."""
    from .plots import plot_image, plt, save_figure
    tr, tc = _target_stamp_position(res, ctx)
    s = res.stamp
    fig, ax = plt.subplots()
    plot_image(res.sumimage_stamp, ax=ax, offset_axes=(s[2] + 1, s[0] + 1),
               xlabel="Pixel Column Number", ylabel="Pixel Row Number", cbar="right")
    ax.plot(tc + s[2] + 1, tr + s[0] + 1, "r+")
    path = save_figure(os.path.join(folder, "sumimage"), fig=fig)
    plt.close(fig)
    return path


def k2p2_debug(res, ctx, device=None) -> dict:
    """The K2P2 mask builder re-run with ``debug=True`` on the target's final
    stamp, on ``device`` (default: the context's): numpy ``above``,
    ``labels``, ``seg``, ``blurred``, ``mask`` and ``cut`` of that one stamp.
    The stamp catalog is the one the aperture pass builds
    (``engine._stamp_catalog``)."""
    from .core.engine import (DEFAULT_K2P2_PARAMS, _catalog_bucket, _full_catalog_positions,
                              _stamp_catalog, _stamp_catalog_select)
    from .models.k2p2 import build_masks_batch
    dev = torch.device(device) if device is not None else ctx.device
    s = res.stamp
    sumimg = np.asarray(res.sumimage_stamp, np.float32)
    cat_all = _full_catalog_positions(ctx)
    idx = _stamp_catalog_select(cat_all, s[0], s[1], s[2], s[3])
    cat = _stamp_catalog(cat_all, idx, s[0], s[2], _catalog_bucket(max(len(idx), 1)))
    tr, tc = _target_stamp_position(res, ctx)

    def one(x, dtype=None):
        return torch.as_tensor(np.asarray(x)[None], dtype=dtype, device=dev)

    out = build_masks_batch(
        one(sumimg), one(cat["col"], torch.float32), one(cat["row"], torch.float32),
        one(cat["tmag"], torch.float32), one(cat["starid"]), one(cat["valid"]),
        one(np.float32(tr)), one(np.float32(tc)),
        one(np.float32(res.target.get("tmag", 10.0))), one(np.isfinite(sumimg)),
        params=DEFAULT_K2P2_PARAMS, debug=True)
    return {k: out[k][0].cpu().numpy() for k in ("above", "labels", "seg", "blurred", "mask",
                                                 "cut")}


def plot_k2p2_diagnostic(res, ctx, folder: str) -> str:
    """The K2P2 5-panel mask diagnostic (k2p2v2.py:664-744)."""
    from .plots import plot_image, plot_outline, plt, save_figure
    sumimg = np.asarray(res.sumimage_stamp, np.float32)
    dbg = k2p2_debug(res, ctx)
    above, labels, seg = dbg["above"], dbg["labels"], dbg["seg"]
    collected = np.isfinite(sumimg)
    final_mask = np.asarray(res.mask if res.mask is not None else dbg["mask"], bool)

    NY, NX = sumimg.shape
    aspect = 0.5 if NY / max(NX, 1) > 5 else 0.2
    fig = plt.figure(figsize=(2 * plt.figaspect(aspect)))
    fig.subplots_adjust(wspace=0.12)

    ax = fig.add_subplot(151)
    plot_image(sumimg, ax=ax, scale="log", title="Sum-image")

    # Significant flux: 0 = not collected, 1 = below cut, 2 = above cut
    sig = np.zeros_like(sumimg)
    sig[collected] = 1.0
    sig[above] = 2.0
    ax = fig.add_subplot(152)
    plot_image(sig, ax=ax, scale="linear", percentile=100, cmap="nipy_spectral",
               title="Significant flux")

    ax = fig.add_subplot(153)
    lab_img = np.where(labels > 0, labels.astype(float), np.nan)
    plot_image(lab_img, ax=ax, scale="linear", percentile=100, cmap="gist_rainbow",
               title="Clustering + Watershed")
    ny, nx = np.nonzero(above & (labels <= 0))
    ax.plot(nx, ny, "+", color="k", markersize=5)

    ax = fig.add_subplot(154)
    seg_img = np.where(seg > 0, seg.astype(float), 0.0)
    plot_image(seg_img, ax=ax, scale="linear", percentile=100, cmap="nipy_spectral",
               title="Extracted clusters")
    plot_outline(final_mask, ax=ax, color="k", lw=1.5)

    ax = fig.add_subplot(155)
    plot_image(sumimg, ax=ax, scale="log", title="Final masks")
    for lab in np.unique(seg[seg > 0]):
        plot_outline(seg == lab, ax=ax, color="0.7", lw=1.5)
    plot_outline(final_mask, ax=ax, color="r", lw=2.5)

    path = save_figure(os.path.join(folder, "masks_flux"), fig=fig)
    plt.close(fig)
    return path


def plot_psf_fit(res, folder: str) -> str:
    """Image | fit | residual at the middle cadence (psf_photometry.py:178-185)."""
    from .plots import plot_image_fit_residuals, plot_outline, plt, save_figure
    diag = res.details.get("diag_fit")
    if diag is None:
        raise ValueError("result carries no diag_fit payload "
                         "(extractor not called with keep_diag=True)")
    fig = plt.figure(figsize=(14, 6))
    axes = plot_image_fit_residuals(fig, diag["data"], diag["model"])
    mini = diag.get("mini_aperture")
    if mini is not None and np.any(mini):
        plot_outline(mini, ax=axes[2], color="k", lw=2)
    fig.suptitle(f"TIC {res.starid} — {res.method} fit, cadence {diag.get('cadence', '?')}")
    path = save_figure(os.path.join(folder, "psf_fit"), fig=fig)
    plt.close(fig)
    return path


def plot_halo_weightmap(res, folder: str) -> list:
    """SymLog TV-min weight maps per segment (halo_photometry.py:229-241)."""
    from .plots import matplotlib, plot_image, plt, save_figure
    wmdict = res.details.get("halo_weightmap")
    if wmdict is None:
        raise ValueError("result carries no halo_weightmap")
    paths = []
    for k, wm in enumerate(np.asarray(wmdict["weightmap"])):
        wm = np.array(wm, np.float64)
        if res.mask is not None:
            wm[~np.asarray(res.mask, bool)] = np.nan
        vlim = np.nanmax(np.abs(wm)) if np.any(np.isfinite(wm)) else 1.0
        vlim = max(float(vlim), 1e-12)
        norm = matplotlib.colors.SymLogNorm(linthresh=0.1 * vlim, vmin=-vlim, vmax=vlim,
                                            base=10)
        fig, ax = plt.subplots()
        plot_image(wm, ax=ax, scale=norm, title="TV-min Weightmap", cmap="bwr",
                   cbar="right", clabel="Weights")
        paths.append(save_figure(os.path.join(folder, f"{res.starid:d}_weightmap_{k + 1:d}"),
                                 fig=fig))
        plt.close(fig)
    return paths


def plot_target_diagnostics(res, ctx, base_folder: str) -> list:
    """Render every applicable diagnostic figure of one result; returns the
    files written.  A figure that fails is logged and skipped; without
    matplotlib this raises ``ImportError`` (figures were asked for)."""
    from . import plots  # noqa: F401
    folder = target_plot_folder(base_folder, res.starid)
    os.makedirs(folder, exist_ok=True)
    written = []

    def _try(fn, *a):
        try:
            out = fn(*a)
        except _PROPAGATE:
            raise
        except Exception:
            logger.warning("Diagnostic figure %s failed for %d", getattr(fn, "__name__", fn),
                           res.starid, exc_info=True)
            return
        written.extend(out if isinstance(out, list) else [out])

    if res.sumimage_stamp is not None and res.stamp is not None:
        _try(plot_sumimage, res, ctx, folder)
    if res.method == "aperture" and res.stamp is not None:
        _try(plot_k2p2_diagnostic, res, ctx, folder)
    if res.method in ("psf", "linpsf") and "diag_fit" in res.details:
        _try(plot_psf_fit, res, folder)
    if res.method == "halo" and "halo_weightmap" in res.details:
        _try(plot_halo_weightmap, res, folder)
    return written
