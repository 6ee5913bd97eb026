"""
Per-target diagnostic metrics, batched, on torch tensors.

Port of ``photometry_tpu/core/metrics.py``: ``compute_metrics_batch``
(mean flux, variance, rms_hour, ptp, variability, median centroid —
reference BasePhotometry.py:1344-1407), its one-light-curve form
``compute_metrics``, and ``crowding_metrics_batch``
(SPOC FLFRCSAP / CROWDSAP from an integrated-Gaussian PSF model).  The
reference ``vmap``s one light curve; here the target batch is the leading
dimension.  Medians use the numpy-matching ``utils.mathutils.nanmedian``;
einsums run in full float32 (TF32 is off, ``device.py``).
"""

from __future__ import annotations

import math

import torch

from .. import device  # noqa: F401  (float32 precision policy)
from ..quality import TESSQualityFlags
from ..utils.mathutils import nanmedian, polyfit_detrend, ptp_metric, rms_timescale

__all__ = ["compute_metrics", "compute_metrics_batch", "crowding_metrics_batch"]


def crowding_metrics_batch(masks, cat_row, cat_col, cat_flux, cat_valid, is_target,
                           t_row, t_col, t_flux, sigma: float) -> dict:
    """PSF-flux completeness and crowding of aperture masks.

    masks (N, h, w) bool; cat_* (N, K) stamp-frame positions and e-/s;
    is_target (N, K); t_row/t_col/t_flux (N,) the target itself; ``sigma``
    the PSF width in pixels.  Returns {"completeness", "crowdsap"}, (N,) each.
    """
    masks = masks.to(torch.float32)
    N, h, w = masks.shape
    d = torch.tensor(math.sqrt(2.0), dtype=torch.float32) * torch.tensor(sigma, dtype=torch.float32)
    d = d.to(masks.device)
    yy = torch.arange(h, dtype=torch.float32, device=masks.device)
    xx = torch.arange(w, dtype=torch.float32, device=masks.device)

    def axis_frac(centers, grid):
        dz = grid[None, None, :] - centers[:, :, None]               # (N, K, n)
        return 0.5 * (torch.special.erf((dz + 0.5) / d) - torch.special.erf((dz - 0.5) / d))

    ey = axis_frac(cat_row, yy)                                       # (N, K, h)
    ex = axis_frac(cat_col, xx)                                       # (N, K, w)
    s_k = torch.einsum("nkh,nhw,nkw->nk", ey, masks, ex)
    s_k = torch.where(cat_valid, s_k, 0.0)

    ety = axis_frac(t_row[:, None], yy)[:, 0]                         # (N, h)
    etx = axis_frac(t_col[:, None], xx)[:, 0]
    s_t = torch.einsum("nh,nhw,nw->n", ety, masks, etx)

    neigh = torch.where(is_target, 0.0, cat_flux * s_k).sum(dim=1)
    own = t_flux * s_t
    total = own + neigh
    crowdsap = torch.where(total > 0, own / torch.clamp(total, min=1e-30), torch.nan)
    return {"completeness": s_t, "crowdsap": crowdsap}


def compute_metrics_batch(time, flux, flux_err, quality, pos_centroid) -> dict:
    """Diagnostic metrics of N light curves.

    time (T,) float32, flux/flux_err (N, T), quality (T,) int, pos_centroid
    (N, T, 2).  Cadences failing the default quality bitmask are excluded
    (BasePhotometry.py:1352-1354).  Returns a dict of (N,) tensors
    (``pos_centroid``: (N, 2)).
    """
    good = TESSQualityFlags.filter(quality)
    fl = torch.where(good, flux, torch.nan)
    fe = torch.where(good, flux_err, torch.nan)
    t = torch.where(good, time, torch.nan)

    mean_flux = nanmedian(fl)
    rel = fl / mean_flux[:, None] - 1.0
    rel_err = torch.abs(1.0 / mean_flux)[:, None] * fe

    fin = torch.isfinite(rel)
    nn = fin.sum(dim=1)
    mean_rel = torch.nansum(torch.where(fin, rel, 0.0), dim=1) / torch.clamp(nn, min=1)
    variance = (torch.nansum(torch.where(fin, (rel - mean_rel[:, None]) ** 2, 0.0), dim=1)
                / torch.clamp(nn - 1, min=1))

    rms_hour = rms_timescale(t, rel)
    ptp = ptp_metric(rel)

    pc = torch.where(good[:, None], pos_centroid, torch.nan)
    pos_med = nanmedian(pc, dim=1)

    detrend = polyfit_detrend(t, rel, rel_err)
    resid = rel - detrend
    rfin = torch.isfinite(resid)
    nr = rfin.sum(dim=1)
    mr = torch.nansum(torch.where(rfin, resid, 0.0), dim=1) / torch.clamp(nr, min=1)
    std_resid = torch.sqrt(torch.nansum(torch.where(rfin, (resid - mr[:, None]) ** 2, 0.0), dim=1)
                           / torch.clamp(nr - 1, min=1))
    variability = std_resid / nanmedian(rel_err)

    return {
        "mean_flux": mean_flux,
        "variance": variance,
        "rms_hour": rms_hour,
        "ptp": ptp,
        "pos_centroid": pos_med,
        "variability": variability,
    }


def compute_metrics(time, flux, flux_err, quality, pos_centroid) -> dict:
    """Diagnostic metrics of one light curve: flux/flux_err (T,),
    pos_centroid (T, 2); :func:`compute_metrics_batch` on a batch of one.
    Returns 0-d tensors (``pos_centroid``: (2,))."""
    out = compute_metrics_batch(time, flux[None], flux_err[None], quality, pos_centroid[None])
    return {k: v[0] for k, v in out.items()}
