"""
Linear PSF photometry: simultaneous least-squares fluxes with fixed centroids.

Port of ``photometry_tpu/models/linpsf.py`` (reference
photometry/linpsf_photometry.py): star positions are fixed per cadence from
the jitter-shifted catalog (linpsf_photometry.py:116); the design matrix A
holds the unit-flux PRF of each fitted star over the good pixels
(:126-133); fluxes solve the normal equations (:22-34); contamination of the
main target comes from the fitted fluxes (:206-216), WARNING above 0.1.

Every (target, cadence) frame of a stamp bucket is solved at once: A is
built for all N*T frames by ``PRF.design_matrix_batch`` as (N, T, S, h*w),
the normal equations are two batched float32 products, and the (S, S)
systems go through ``ops.smallsolve.solve_spd_small``.  No hand kernel: the
JAX package computes this in XLA, outside any Pallas kernel.  The JAX
package's AOT prefetch (``prefetch_linpsf_programs``) has no counterpart:
PyTorch compiles nothing ahead of time.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..core.engine import TargetResult, _full_catalog_positions, _host, aperture_image
from ..core.metrics import compute_metrics_batch
from ..core.status import STATUS
from ..ops.smallsolve import solve_spd_small
from .psf_common import (CUTOFF_RADIUS, bucket_psf_groups, context_prf, context_stamps,
                         logical_stamp_mask, minimum_aperture_mask, setup_psf_target)

logger = logging.getLogger(__name__)

__all__ = ["linpsf_timeseries", "linpsf_timeseries_batch", "extract_linpsf_batch"]

#: Device-memory budget for one linPSF target chunk, bytes (see :func:`_chunks`).
_GROUP_BYTES = 1_500_000_000


def linpsf_timeseries_batch(images, rows_t, cols_t, valid, prf, shape, S: int) -> dict:
    """Linear-PSF solves of (N, T, h, w) stamp stacks: N*T (h*w x S) systems.

    Parameters:
        images: (N, T, h, w) background-subtracted fluxes (NaN = bad pixel).
        rows_t, cols_t: (N, T, S) jitter-shifted star positions (stamp coords).
        valid: (N, S) bool of real (non-padding) stars.

    Returns dict with fluxes (N, T, S) and model images (N, T, h, w).
    """
    h, w = shape
    A = prf.design_matrix_batch(rows_t, cols_t, (h, w), CUTOFF_RADIUS)   # (N, T, S, hw)
    lead = A.shape[:-2]
    b = torch.nan_to_num(images).reshape(*lead, h * w)
    good = torch.isfinite(images).reshape(*lead, 1, h * w).to(A.dtype)
    Aw = A * good * valid[:, None, :, None].to(A.dtype)
    bw = b * good[..., 0, :]
    AtA = Aw @ Aw.transpose(-1, -2) + 1e-9 * torch.eye(S, dtype=A.dtype, device=A.device)
    fluxes = solve_spd_small(AtA, (Aw @ bw[..., None])[..., 0])
    fluxes = torch.where(valid[:, None, :], fluxes, torch.zeros((), device=A.device))
    model = (fluxes[..., None, :] @ A)[..., 0, :].reshape(*lead, h, w)
    return {"fluxes": fluxes, "models": model}


def linpsf_timeseries(images, rows_t, cols_t, valid, prf, shape, S: int) -> dict:
    """One target's (T, h, w) stack: :func:`linpsf_timeseries_batch` at N = 1,
    returning fluxes (T, S) and models (T, h, w)."""
    out = linpsf_timeseries_batch(images[None], rows_t[None], cols_t[None], valid[None],
                                  prf, shape, S)
    return {k: v[0] for k, v in out.items()}


def _chunks(group, T: int, bh: int, bw: int, S: int, prf):
    """Split a bucket group so the solve's working set fits the budget.

    Per target and cadence the solve holds the stamp and background, the
    NaN-masked stamp, A, A*good and one more stamp-sized temporary per
    star, and the table route's Catmull-Rom taps, (S, h + w, 4, K).
    """
    floats = (4 + 3 * S) * bh * bw
    if prf._grid_separable:
        floats += S * (bh + bw) * 4 * prf._svd_factors()[0].shape[1]
    n_max = max(1, _GROUP_BYTES // (4 * T * floats))
    for i in range(0, len(group), n_max):
        yield group[i:i + n_max]


def extract_linpsf_batch(ctx, starids, prf=None, keep_diag: bool = False, **_kw) -> list:
    """Linear PSF photometry for a batch of targets on one context.

    Targets are grouped into padded stamp buckets and each group is solved in
    :func:`linpsf_timeseries_batch` calls; pixels outside each target's
    logical stamp are NaN, which zeroes their rows in the design matrix.
    """
    prf = context_prf(ctx, prf)
    cat_all = _full_catalog_positions(ctx)
    T = ctx.n_times
    t_nc = ctx.time - ctx.timecorr
    var_const = float(np.float32(ctx.n_readout * ctx.readnoise ** 2 / ctx.gain ** 2))
    dev = ctx.device
    zero = torch.zeros((), device=dev)

    setups = [setup_psf_target(ctx, int(sid), cat_all) for sid in starids]
    results = {}
    for (bh, bw), full_group in bucket_psf_groups(ctx, setups).items():
        S = len(full_group[0][0].valid)
        for group in _chunks(full_group, T, bh, bw, S, prf):
            r0s = np.array([g[1] for g in group], np.int32)
            c0s = np.array([g[2] for g in group], np.int32)
            imgs, bkgs = context_stamps(ctx, r0s, c0s, bh, bw)
            logical = np.stack([logical_stamp_mask(st.stamp, r0, c0, bh, bw)
                                for st, r0, c0 in group])
            imgs = torch.where(torch.as_tensor(logical, device=dev)[:, None], imgs, torch.nan)

            valid = np.stack([st.valid for st, _, _ in group])          # (N, S)
            rows0 = np.stack([st.rows0 + (st.stamp[0] - r0) for st, r0, _ in group])
            cols0 = np.stack([st.cols0 + (st.stamp[2] - c0) for st, _, c0 in group])
            rows_ccd = np.where(valid, rows0 + r0s[:, None], 0.0)
            cols_ccd = np.where(valid, cols0 + c0s[:, None], 0.0)
            # Jitter-shifted positions per cadence (catalog_attime equivalent):
            jit_all = ctx.motion.jitter_batch(t_nc, cols_ccd.ravel(), rows_ccd.ravel()
                                              ).reshape(T, len(group), S, 2)
            rows_t = np.moveaxis(rows0[None] + np.where(valid[None], jit_all[..., 1], 0.0), 0, 1)
            cols_t = np.moveaxis(cols0[None] + np.where(valid[None], jit_all[..., 0], 0.0), 0, 1)

            out = linpsf_timeseries_batch(
                imgs, torch.as_tensor(rows_t, dtype=torch.float32, device=dev),
                torch.as_tensor(cols_t, dtype=torch.float32, device=dev),
                torch.as_tensor(valid, device=dev), prf, (bh, bw), S)
            tr_b = np.array([st.target_row + (st.stamp[0] - r0) for st, r0, _ in group])
            tc_b = np.array([st.target_col + (st.stamp[2] - c0) for st, _, c0 in group])
            mini_b = np.stack([minimum_aperture_mask((bh, bw), tr, tcol)
                               for tr, tcol in zip(tr_b, tc_b)])
            target_idx = np.array([st.target_idx for st, _, _ in group])

            # Photon-noise flux error from the variance map, and the
            # background under the minimum aperture (float32 on the device):
            mini_d = torch.as_tensor(mini_b, device=dev)[:, None]
            var_d = torch.nansum(torch.where(mini_d, torch.abs(imgs + bkgs) + var_const, zero),
                                 dim=(2, 3))
            fbkg_d = torch.nansum(torch.where(mini_d, bkgs, zero), dim=(2, 3))
            fluxes, var, fbkg = (_host(x).astype(np.float64)
                                 for x in (out["fluxes"], var_d, fbkg_d))   # (N, T, S), (N, T)
            flux = np.take_along_axis(fluxes, target_idx[:, None, None], axis=2)[:, :, 0]
            flux_err = np.sqrt(np.maximum(var, 0.0))

            pos = np.stack([
                np.take_along_axis(cols_t, target_idx[:, None, None], axis=2)[:, :, 0]
                + c0s[:, None] + 1,
                np.take_along_axis(rows_t, target_idx[:, None, None], axis=2)[:, :, 0]
                + r0s[:, None] + 1], axis=2)                                 # (N, T, 2)

            metrics = compute_metrics_batch(
                torch.as_tensor(ctx.time, dtype=torch.float32, device=dev),
                torch.as_tensor(flux, dtype=torch.float32, device=dev),
                torch.as_tensor(flux_err, dtype=torch.float32, device=dev),
                torch.as_tensor(ctx.quality, device=dev),
                torch.as_tensor(pos, dtype=torch.float32, device=dev))
            metrics = {k: _host(v) for k, v in metrics.items()}

            diag_models = diag_data = diag_mid = None
            if keep_diag:
                # Best-fit model images at the middle cadence for the fit /
                # residual diagnostic figure (linpsf_photometry.py:174-194).
                diag_mid = T // 2
                pm = np.stack([rows_t[:, diag_mid], cols_t[:, diag_mid],
                               np.where(valid, fluxes[:, diag_mid], 0.0)],
                              axis=2).astype(np.float32)                    # (N, S, 3)
                diag_models = _host(prf.render_batch(torch.as_tensor(pm, device=dev),
                                                     (bh, bw), CUTOFF_RADIUS))
                diag_data = _host(imgs[:, diag_mid])

            for i, (setup, r0, c0) in enumerate(group):
                s = setup.stamp
                nh, nw = s[1] - s[0], s[3] - s[2]
                # Contamination from fitted fluxes (linpsf_photometry.py:206-216):
                others = np.delete(np.arange(S), setup.target_idx)
                sum_others = (np.nansum(np.nanmedian(fluxes[i][:, others], axis=0))
                              if len(others) else 0.0)
                med_target = np.nanmedian(flux[i])
                contamination = (float(np.clip(
                    sum_others / max(med_target + sum_others, 1e-30), 0, None))
                    if (med_target + sum_others) > 0 else np.nan)

                mini = minimum_aperture_mask((nh, nw), setup.target_row, setup.target_col)
                status = STATUS.OK
                details = {
                    "mean_flux": float(metrics["mean_flux"][i]),
                    "variance": float(metrics["variance"][i]),
                    "rms_hour": float(metrics["rms_hour"][i]),
                    "ptp": float(metrics["ptp"][i]),
                    "variability": float(metrics["variability"][i]),
                    "pos_centroid": metrics["pos_centroid"][i].tolist(),
                    "mask_size": int(mini.sum()),
                    "stamp": tuple(s),
                    "stamp_resizes": 0,
                    "contamination": contamination,
                    "n_stars_fit": int(setup.valid.sum()),
                }
                if np.isfinite(contamination) and contamination > 0.1:
                    status = STATUS.WARNING
                if np.all(~np.isfinite(flux[i])):
                    status = STATUS.ERROR
                    details["errors"] = ["Final lightcurve fluxes are all NaNs"]
                if keep_diag:
                    details["diag_fit"] = {"data": diag_data[i], "model": diag_models[i],
                                           "cadence": diag_mid,
                                           "mini_aperture": np.asarray(mini_b[i])}

                t_i, tc_i = ctx.corrected_time(setup.target["ra"], setup.target["decl"])
                lc = {
                    "time": t_i, "timecorr": tc_i,
                    "cadenceno": ctx.cadenceno, "quality": ctx.quality,
                    "flux": flux[i], "flux_err": flux_err[i],
                    "flux_background": fbkg[i],
                    "pos_centroid": pos[i],
                    "pos_corr": jit_all[:, i, setup.target_idx, :],
                }
                add_headers = {}
                if np.isfinite(contamination):
                    add_headers["AP_CONT"] = (round(contamination, 8),
                                              "Contamination from fitted fluxes")
                stamp_wcs = None
                if ctx.wcs is not None:
                    stamp_wcs = ctx.wcs.copy()
                    if ctx.datasource == "ffi":      # a TPF's WCS is the stamp's already
                        stamp_wcs.crpix = stamp_wcs.crpix - np.array([s[2], s[0]])

                results[setup.starid] = TargetResult(
                    starid=setup.starid, method="linpsf", status=status,
                    sector=ctx.sector, camera=ctx.camera, ccd=ctx.ccd,
                    cadence=ctx.cadence, data_rel=ctx.data_rel,
                    target=setup.target, lightcurve=lc, mask=mini,
                    aperture_image=aperture_image(ctx, s, mini),
                    sumimage_stamp=ctx.sumimage[s[0]:s[1], s[2]:s[3]],
                    stamp=tuple(s), details=details, additional_headers=add_headers,
                    num_frm=ctx.num_frm, n_readout=ctx.n_readout,
                    ticver=ctx.catalog.settings.ticver, stamp_wcs=stamp_wcs)
    return [results[int(sid)] for sid in starids]
