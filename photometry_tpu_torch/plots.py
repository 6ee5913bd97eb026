"""
Plotting utilities of the diagnostics (host matplotlib, in no hot path).

The port's copy of ``photometry_tpu/plots.py`` (reference photometry/plots.py):
``plot_image`` with log/sqrt/linear stretches and percentile intervals
(plots.py:76-282), the 3-panel image/fit/residual figure (:285-339), mask
outline tracing (:342-397), the backend switches and ``save_figure``
(:400-424).  The Agg backend is forced for cluster use (:24).

matplotlib is imported only by this module and ``movie``; ``diagnostics``
imports this module inside the functions that draw.  The package, every
drain without plots and the K2P2 debug images run on a machine without
matplotlib.
"""

from __future__ import annotations

import logging
import os

import matplotlib
matplotlib.use("Agg")  # clusters have no display
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402

logger = logging.getLogger(__name__)

__all__ = ["plot_image", "plot_image_fit_residuals", "plot_outline", "save_figure", "plt"]


def _stretch(data, scale: str, vmin, vmax):
    d = np.asarray(data, np.float64)
    if vmin is None or vmax is None:
        finite = d[np.isfinite(d)]
        if finite.size == 0:
            return np.zeros_like(d), 0.0, 1.0
        lo, hi = np.percentile(finite, [4.5, 95.5])
        vmin = lo if vmin is None else vmin
        vmax = hi if vmax is None else vmax
    if vmax <= vmin:
        vmax = vmin + 1e-30
    with np.errstate(invalid="ignore"):   # NaN pixels render as masked
        x = np.clip((d - vmin) / (vmax - vmin), 0, 1)
    if scale == "linear":
        y = x
    elif scale == "sqrt":
        y = np.sqrt(x)
    elif scale == "log":
        a = 1000.0
        y = np.log(a * x + 1) / np.log(a + 1)
    elif scale == "squared":
        y = x ** 2
    else:
        raise ValueError(f"Invalid scale: {scale}")
    return y, vmin, vmax


def plot_image(image, ax=None, scale="log", cmap=None, origin="lower",
               vmin=None, vmax=None, xlabel=None, ylabel=None, cbar=None,
               clabel="Flux ($e^{-}s^{-1}$)", title=None, percentile=95.5,
               offset_axes=None, **kwargs):
    """Display a 2-D image with astronomy-friendly stretches.

    NaNs render as black (reference plots.py behavior).
    """
    if ax is None:
        ax = plt.gca()
    if cmap is None:
        cmap = plt.get_cmap("Blues")
    else:
        cmap = plt.get_cmap(cmap) if isinstance(cmap, str) else cmap
    cmap = cmap.copy()
    cmap.set_bad("k")

    image = np.ma.masked_invalid(np.asarray(image, np.float64))
    finite = image.compressed()
    if finite.size and (vmin is None or vmax is None):
        plo = 0.5 * (100 - percentile)
        lo, hi = np.percentile(finite, [plo, 100 - plo])
        vmin = lo if vmin is None else vmin
        vmax = hi if vmax is None else vmax

    extent = None
    if offset_axes is not None:
        H, W = image.shape
        extent = (offset_axes[0] - 0.5, offset_axes[0] + W - 0.5,
                  offset_axes[1] - 0.5, offset_axes[1] + H - 0.5)

    if isinstance(scale, matplotlib.colors.Normalize):
        # A matplotlib norm (e.g. SymLogNorm for halo weight maps) is passed
        # straight through, matching reference plots.py's scale handling:
        im = ax.imshow(image, cmap=cmap, origin=origin, norm=scale,
                       extent=extent, interpolation="nearest", **kwargs)
    else:
        stretched, vmin, vmax = _stretch(image.filled(np.nan), scale, vmin, vmax)
        stretched = np.ma.masked_invalid(stretched)
        im = ax.imshow(stretched, cmap=cmap, origin=origin, vmin=0, vmax=1,
                       extent=extent, interpolation="nearest", **kwargs)
    if title:
        ax.set_title(title)
    if xlabel:
        ax.set_xlabel(xlabel)
    if ylabel:
        ax.set_ylabel(ylabel)
    if cbar:
        loc = cbar if isinstance(cbar, str) else "right"
        cb = plt.colorbar(im, ax=ax, location=loc if loc in ("left", "right", "top", "bottom") else "right")
        if clabel:
            cb.set_label(clabel)
    return im


def plot_image_fit_residuals(fig, image, fit, residuals=None):
    """3-panel (image | fit | residuals) figure (plots.py:285-339)."""
    if residuals is None:
        residuals = np.asarray(image) - np.asarray(fit)
    axes = fig.subplots(ncols=3)
    plot_image(image, ax=axes[0], title="Image")
    plot_image(fit, ax=axes[1], title="PSF fit")
    plot_image(residuals, ax=axes[2], scale="linear", title="Residuals")
    for ax in axes:
        ax.set_xticklabels([])
        ax.set_yticklabels([])
    return axes


def plot_outline(mask, ax=None, color="r", lw=2, **kwargs):
    """Trace and optionally draw the boundary of a boolean mask.

    Returns an (M, 2) array of (x, y) polyline points in pixel coordinates
    (reference plots.py:342-397).
    """
    mask = np.asarray(mask, bool)
    segments = []
    H, W = mask.shape
    for r in range(H):
        for c in range(W):
            if not mask[r, c]:
                continue
            if r == 0 or not mask[r - 1, c]:
                segments.append(((c - 0.5, r - 0.5), (c + 0.5, r - 0.5)))
            if r == H - 1 or not mask[r + 1, c]:
                segments.append(((c - 0.5, r + 0.5), (c + 0.5, r + 0.5)))
            if c == 0 or not mask[r, c - 1]:
                segments.append(((c - 0.5, r - 0.5), (c - 0.5, r + 0.5)))
            if c == W - 1 or not mask[r, c + 1]:
                segments.append(((c + 0.5, r - 0.5), (c + 0.5, r + 0.5)))
    if not segments:
        return np.zeros((0, 2))
    pts = np.array([p for seg in segments for p in seg])
    if ax is not None:
        from matplotlib.collections import LineCollection
        ax.add_collection(LineCollection(segments, colors=color, lw=lw, **kwargs))
    return pts


def plots_interactive(backend=("QtAgg", "Qt5Agg", "MacOSX", "Qt4Agg",
                               "Qt5Cairo", "TkAgg", "GTK4Agg")):
    """Switch to the first working interactive backend (reference
    plots.py:33-62); silently stays on the current backend when none of
    the candidates is importable (headless clusters)."""
    logger = logging.getLogger(__name__)
    if isinstance(backend, str):
        backend = [backend]
    try:
        from matplotlib.backends import BackendFilter, backend_registry
        interactive = backend_registry.list_builtin(BackendFilter.INTERACTIVE)
    except ImportError:  # matplotlib < 3.9
        interactive = matplotlib.rcsetup.interactive_bk
    for bckend in backend:
        if bckend not in interactive:
            continue
        try:
            plt.switch_backend(bckend)
        except (ModuleNotFoundError, ImportError):
            continue
        logger.debug("Interactive backend selected: %s", bckend)
        break


def plots_noninteractive():
    """Switch to the non-interactive Agg backend (reference plots.py:64-73)."""
    plt.switch_backend("Agg")


def set_copyright(fig, xpos=0.01, ypos=0.99, fontsize=12):
    """Footer credit on movie/diagnostic figures (run_ffimovie.py:59-64)."""
    plt.text(ypos, xpos, "Created by photometry-tpu-torch",
             verticalalignment="bottom", horizontalalignment="right",
             transform=fig.transFigure, color="0.3", fontsize=fontsize)


def save_figure(path, fig=None, fmt="png", dpi=100):
    """Save a figure, creating directories as needed (plots.py:400-424)."""
    if fig is None:
        fig = plt.gcf()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if not path.endswith("." + fmt):
        path = path + "." + fmt
    fig.savefig(path, format=fmt, dpi=dpi, bbox_inches="tight")
    return path
