"""
Nonlinear PSF photometry by batched Levenberg-Marquardt, on torch tensors.

Port of ``photometry_tpu/models/psf_fit.py`` (reference
psf_photometry.py): per cadence, fit (row, column, flux) of the <=5
nearest catalog stars by a fixed number of damped Gauss-Newton steps under
the Gaussian_d / Gaussian_m / Poisson likelihoods, the first cadence from
the catalog, every cadence from that solution, then the MOMF residual
aperture correction (psf_photometry.py:168-171) and flux errors from the
Gauss-Newton covariance.

Two routes, chosen by the same static rule as the JAX package:

- **fused**: tensors on the card and ``models.psf_fused.fused_ok`` true (a
  grid-separable table PRF, K <= 4, Gaussian_d, S <= 8, stamps <= 32x32).
  Both phases go through ``psf_fused.fused_warm_fit``, the hand-written
  CUDA kernel ``ops/csrc/psf_warm_fit.cu``.
- **plain**: :func:`make_psf_fitter` over the batch, the counterpart of the
  JAX package's XLA path, for every other configuration and on the CPU.

Nothing is compiled ahead of time in the port (PyTorch runs eagerly and the
kernel is built once per process), so the JAX package's AOT prefetch has no
counterpart here, and nothing catches a kernel failure to re-run the
fitter.  The open recorder (``utils.profiling``) counts the instances each
fit was handed, ``psf_instances``, and those the fused route fitted,
``psf_fused_instances``, and times ``extract_psf_batch``'s steps:
``psf.setup``, ``psf.gather``, ``psf.fit`` and ``psf.results``.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..core.engine import TargetResult, _full_catalog_positions, _host, aperture_image
from ..core.metrics import compute_metrics_batch
from ..core.status import STATUS
from ..ops.smallsolve import solve_spd_small, spd_inverse_diag_small
from ..utils.profiling import count, span
from .psf_common import (CUTOFF_RADIUS, bucket_psf_groups, context_prf, context_stamps,
                         logical_stamp_mask, minimum_aperture_mask, setup_psf_target)
from .psf_fused import fused_ok, fused_warm_fit

logger = logging.getLogger(__name__)

__all__ = ["make_psf_fitter", "fit_psf_timeseries_batch", "extract_psf_batch", "LM_ITERS",
           "LM_ITERS_WARM"]

LM_ITERS = 12
#: Iterations for warm-started cadences (phase 2): damped GN converges
#: quadratically from the first-frame solution, so ~half suffices.
LM_ITERS_WARM = 6
LM_LAMBDA = 1e-3


def _unpack(p, S):
    return p[..., :S], p[..., S:2 * S], p[..., 2 * S:]


def make_psf_fitter(prf, shape, S: int, lhood_stat: str = "Gaussian_d",
                    n_iters: int = LM_ITERS):
    """The batched LM fitting function.

    Returns ``fit(img, bkg, var_const, p0, valid) -> (p, mdl, flux_var)``
    with ``img``/``bkg`` (..., h, w), ``p0`` (..., 3S) packed as
    [rows, cols, fluxes], ``valid`` (..., S) and
    ``var_const = n_readout * readnoise^2 / gain^2``; leading dimensions
    are independent instances.
    """
    h, w = shape
    dev = prf.device
    eye = torch.eye(3 * S, dtype=torch.float64, device=dev)

    def render(p):
        rows, cols, fluxes = _unpack(p, S)
        return prf.integrate_to_image(torch.stack([rows, cols, fluxes], dim=-1), (h, w),
                                      CUTOFF_RADIUS)

    def weights(img, bkg, mdl, var_const):
        if lhood_stat == "Gaussian_d":
            var = torch.abs(img + bkg) + var_const
        elif lhood_stat == "Gaussian_m":
            var = torch.abs(mdl + bkg) + var_const
        elif lhood_stat == "Poisson":
            var = torch.clamp(mdl, min=1e-9)
        else:
            raise ValueError(f"Invalid statistic: '{lhood_stat}'")
        return 1.0 / torch.clamp(var, min=1e-9)

    def model_and_jac(p):
        """(model image, unweighted Jacobian pieces) from one PRF evaluation;
        pieces are None where the PRF has no closed-form derivative."""
        rows, cols, fluxes = _unpack(p, S)
        if prf.has_analytic_grads:
            rr = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
            cc = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
            drow = rr - rows[..., None, None]                           # (..., S, h, w)
            dcol = cc - cols[..., None, None]
            q, qy, qx = prf.pixel_fraction_grads(drow, dcol)
            cut = drow ** 2 + dcol ** 2 < CUTOFF_RADIUS ** 2
            zero = torch.zeros((), device=dev)
            q, qy, qx = (torch.where(cut, x, zero) for x in (q, qy, qx))
            # pixel_fraction_grads' qy is d q/d drow = -d q/d row_s:
            qr, qc = -qy, -qx
        elif prf._grid_separable:
            q, qr, qc = prf.render_separable_with_grads(rows, cols, (h, w), CUTOFF_RADIUS)
        else:
            return render(p), None
        mdl = torch.einsum("...shw,...s->...hw", q, fluxes)
        return mdl, (q, qr, qc, fluxes)

    def normal_eq(pieces, wmap, diff):
        """(JtJ, Jt(-r)) of the weighted least squares, in float64, without
        forming the (h*w, 3S) Jacobian: the flux factors of the position
        columns scale the (3, 3, S, S) blocks after one contraction over
        pixels."""
        q, qr, qc, fluxes = pieces
        lead = q.shape[:-3]
        X = torch.stack([qr, qc, q], dim=-4).reshape(*lead, 3, S, h * w).double()
        Xw = X * wmap.reshape(*lead, 1, 1, h * w)
        G = torch.einsum("...asp,...ctp->...acst", Xw, X)               # (..., 3, 3, S, S)
        g = torch.einsum("...asp,...p->...as", Xw, diff.reshape(*lead, h * w).double())
        fluxes = fluxes.double()
        f1 = torch.stack([fluxes, fluxes, torch.ones_like(fluxes)], dim=-2)   # (..., 3, S)
        JtJ = G * f1[..., :, None, :, None] * f1[..., None, :, None, :]
        JtJ = JtJ.transpose(-3, -2).reshape(*lead, 3 * S, 3 * S)
        Jtg = (g * f1).reshape(*lead, 3 * S)                            # = -(J^T r)
        return JtJ, Jtg

    def jacfwd_normal_eq(p, sw, img0, mdl):
        """The same terms by forward-mode autodiff of the render, for table
        PRFs without a separable closed form."""
        lead = p.shape[:-1]
        pf, swf, imf = p.reshape(-1, 3 * S), sw.reshape(-1, h * w), img0.reshape(-1, h * w)

        def resid(pp, s_, im):
            return s_ * (im - render(pp).reshape(h * w))

        J = torch.func.vmap(torch.func.jacfwd(resid), in_dims=(0, 0, 0))(pf, swf, imf)
        J = J.reshape(*lead, h * w, 3 * S).double()
        r = (sw * (img0 - mdl)).reshape(*lead, h * w, 1).double()
        JtJ = J.transpose(-1, -2) @ J
        Jtg = -(J.transpose(-1, -2) @ r)[..., 0]
        return JtJ, Jtg

    def fit(img, bkg, var_const, p0, valid):
        img = torch.as_tensor(img, dtype=torch.float32, device=dev)
        bkg = torch.as_tensor(bkg, dtype=torch.float32, device=dev)
        good = torch.isfinite(img)
        img0 = torch.nan_to_num(img)
        # Gaussian_d weights depend only on the data: computed once.
        wconst = (weights(img0, bkg, None, var_const) * good
                  if lhood_stat == "Gaussian_d" else None)
        valid = torch.as_tensor(valid, device=dev).to(torch.bool)
        par_valid = torch.cat([valid, valid, valid], dim=-1).to(torch.float64)
        pv_outer = par_valid[..., :, None] * par_valid[..., None, :]

        def wls_terms(p):
            """(model, JtJ, Jtg) at p, dummy-star rows/cols zeroed."""
            mdl, pieces = model_and_jac(p)
            wmap = wconst if wconst is not None else weights(img0, bkg, mdl, var_const) * good
            if pieces is not None:
                JtJ, Jtg = normal_eq(pieces, wmap, img0 - mdl)
            else:
                JtJ, Jtg = jacfwd_normal_eq(p, torch.sqrt(wmap), img0, mdl)
            return mdl, JtJ * pv_outer, Jtg * par_valid

        p = torch.as_tensor(p0, dtype=torch.float32, device=dev)
        for _ in range(n_iters):
            _, JtJ, Jtg = wls_terms(p)
            damp = LM_LAMBDA * torch.diag_embed(torch.diagonal(JtJ, dim1=-2, dim2=-1)) + 1e-8 * eye
            dp = solve_spd_small(JtJ + damp, Jtg) * par_valid
            rows, cols, fluxes = _unpack(p + dp.float(), S)
            # Physical constraints (reference prior: flux >= 0).  Only real
            # stars are clipped: the final covariance relies on dummy
            # Jacobian columns being exactly zero.
            fluxes = torch.clamp(fluxes, min=0.0)
            rows = torch.where(valid, torch.clamp(rows, -2.0, h + 1.0), rows)
            cols = torch.where(valid, torch.clamp(cols, -2.0, w + 1.0), cols)
            p = torch.cat([rows, cols, fluxes], dim=-1)
        # Flux covariance from the final Jacobian, regularised relative to
        # the largest diagonal entry (dummy columns are exactly zero):
        mdl, JtJ, _ = wls_terms(p)
        dmax = torch.diagonal(JtJ, dim1=-2, dim2=-1).max(dim=-1).values
        ridge = 1e-6 * torch.clamp(dmax, min=1.0)
        flux_var = spd_inverse_diag_small(JtJ + ridge[..., None, None] * eye)[..., 2 * S:].float()
        flux_var = torch.where(torch.isfinite(flux_var), flux_var, torch.nan)
        return p, mdl, flux_var

    return fit


def _select(x, onehot):
    """(N, T, S) x (N, S) one-hot -> (N, T): each instance's main target."""
    return torch.sum(x * onehot[:, None, :], dim=-1)


def _fit_fused_batch(images, backgrounds, var_const, p0, valid, mini_ap, target_idx,
                     prf, shape, S: int):
    """Both LM phases through ``psf_fused.fused_warm_fit``: phase 1 fits
    the N first cadences at LM_ITERS, phase 2 the N*T instances at
    LM_ITERS_WARM, each warm-started from its target's phase-1 solution."""
    N, T, h, w = images.shape
    onehot = torch.nn.functional.one_hot(target_idx.long(), S).to(torch.float32)
    out1 = fused_warm_fit(images[:, 0], backgrounds[:, 0], var_const, p0, valid, mini_ap,
                          onehot, prf, shape, S, LM_ITERS)

    def flat(a):                                # (N, ...) -> (N*T, ...)
        return torch.repeat_interleave(a, T, dim=0)

    out = fused_warm_fit(images.reshape(N * T, h, w), backgrounds.reshape(N * T, h, w),
                         var_const, flat(out1["params"]), flat(valid), flat(mini_ap),
                         flat(onehot), prf, shape, S, LM_ITERS_WARM)
    params = out["params"].reshape(N, T, 3 * S)
    rows, cols, fluxes = _unpack(params, S)
    return {
        "flux": _select(fluxes, onehot) + out["flux_ap"].reshape(N, T),
        "flux_err": torch.sqrt(torch.clamp(out["fluxvar_target"].reshape(N, T), min=0.0)),
        "pos": torch.stack([_select(rows, onehot), _select(cols, onehot)], dim=-1),
        "all_fluxes": fluxes,
        "params": params,
    }


def _fit_plain_batch(images, backgrounds, var_const, p0, valid, mini_ap, target_idx,
                     prf, shape, S: int, lhood_stat: str):
    """Both phases through :func:`make_psf_fitter` over the batch."""
    N, T, h, w = images.shape
    onehot = torch.nn.functional.one_hot(target_idx.long(), S).to(torch.float32)
    fit = make_psf_fitter(prf, shape, S, lhood_stat)
    fit_warm = make_psf_fitter(prf, shape, S, lhood_stat, n_iters=LM_ITERS_WARM)
    p_first, _, _ = fit(images[:, 0], backgrounds[:, 0], var_const, p0, valid)
    p, mdl, flux_var = fit_warm(images, backgrounds, var_const,
                                p_first[:, None].expand(N, T, 3 * S),
                                valid[:, None].expand(N, T, S))
    rows, cols, fluxes = _unpack(p, S)
    # MOMF aperture correction on residuals (psf_photometry.py:168-171):
    keep = mini_ap[:, None] & torch.isfinite(images)
    flux_ap = torch.sum(torch.where(keep, torch.nan_to_num(images) - mdl,
                                    torch.zeros((), device=images.device)), dim=(-2, -1))
    return {
        "flux": _select(fluxes, onehot) + flux_ap,
        "flux_err": torch.sqrt(torch.clamp(_select(flux_var, onehot), min=0.0)),
        "pos": torch.stack([_select(rows, onehot), _select(cols, onehot)], dim=-1),
        "all_fluxes": fluxes,
        "params": p,
    }


def fit_psf_timeseries_batch(images, backgrounds, var_const, p0, valid, mini_ap,
                             target_idx, prf, shape, S: int, lhood_stat: str = "Gaussian_d",
                             fused=None) -> dict:
    """Target-batched LM PSF fit of (N, T, h, w) stamp stacks.

    ``p0`` (N, 3S), ``valid`` (N, S), ``mini_ap`` (N, h, w), ``target_idx``
    (N,).  Returns flux, flux_err (N, T), pos (N, T, 2) [row, col of the main
    target in stamp coords], all_fluxes (N, T, S) and params (N, T, 3S).

    ``fused=None`` takes the fused kernel route when the tensors are on the
    card and ``fused_ok`` admits the configuration; ``fused=True`` takes it
    wherever ``fused_ok`` holds (on the CPU that runs the kernel's plain
    version).
    """
    if fused is None:
        fused = images.is_cuda
    N, T = images.shape[:2]
    count("psf_instances", N * (T + 1))          # the first cadences, then every cadence
    if fused and fused_ok(prf, shape, S, lhood_stat):
        count("psf_fused_instances", N * (T + 1))
        return _fit_fused_batch(images, backgrounds, var_const, p0, valid, mini_ap,
                                target_idx, prf, shape, S)
    return _fit_plain_batch(images, backgrounds, var_const, p0, valid, mini_ap, target_idx,
                            prf, shape, S, lhood_stat)


#: Device-memory budget for one PSF target-batch, bytes: the two stamp
#: cubes plus the plain fitter's ~3S+1 stamp-sized buffers per target.
_GROUP_BYTES = 1_500_000_000


def _group_chunks(group, T: int, bh: int, bw: int):
    """Split a bucket group so the LM working set fits the budget.

    Yields ``(chunk, true_n)``; the chunk is padded to a power of two
    (capped at the budget) by repeating its last target, as the JAX
    package does to bound its compiled shapes; callers read ``[:true_n]``.
    """
    per_target = (2 + 16) * 4 * T * bh * bw
    n_max = max(1, _GROUP_BYTES // per_target)
    for i in range(0, len(group), n_max):
        chunk = group[i:i + n_max]
        n = len(chunk)
        npad = 1
        while npad < n:
            npad *= 2
        npad = min(npad, n_max)
        yield chunk + [chunk[-1]] * (npad - n), n


def extract_psf_batch(ctx, starids, lhood_stat: str = "Gaussian_d", prf=None,
                      keep_diag: bool = False, fused=None, **_kw) -> list:
    """Nonlinear PSF photometry for a batch of targets on one context.

    Targets are grouped into padded stamp buckets and each group is fitted
    in one :func:`fit_psf_timeseries_batch` call; pixels outside a target's
    logical stamp are NaN (zero weight in the fit), so bucketing does not
    change the numbers.  A background that is not finite counts as zero in
    its pixel's Gaussian_d weight, as it does in FLUX_BKG's sum: the pixel
    stays in the fit and in the residual sum rather than spoiling its
    cadence.  ``fused`` is passed through.
    """
    with span("psf.setup"):
        prf = context_prf(ctx, prf)
        cat_all = _full_catalog_positions(ctx)
        var_const = ctx.n_readout * ctx.readnoise ** 2 / ctx.gain ** 2
        T = ctx.n_times
        t_nc = ctx.time - ctx.timecorr
        dev = ctx.device
        setups = [setup_psf_target(ctx, int(sid), cat_all) for sid in starids]
        groups = bucket_psf_groups(ctx, setups)

    results = {}
    for (bh, bw), full_group in groups.items():
        for group, N in _group_chunks(full_group, T, bh, bw):
            with span("psf.setup"):
                S = len(group[0][0].valid)
                r0s = np.array([g[1] for g in group], np.int32)
                c0s = np.array([g[2] for g in group], np.int32)
                logical = np.stack([logical_stamp_mask(st.stamp, r0, c0, bh, bw)
                                    for st, r0, c0 in group])
                # Star positions in bucket coords; jitter-shift to the first
                # cadence for all N*S stars in one motion-model call:
                valid = np.stack([st.valid for st, _, _ in group])          # (N, S)
                rows0 = np.stack([st.rows0 + (st.stamp[0] - r0) for st, r0, _ in group])
                cols0 = np.stack([st.cols0 + (st.stamp[2] - c0) for st, _, c0 in group])
                rows_ccd = np.where(valid, rows0 + r0s[:, None], 0.0)
                cols_ccd = np.where(valid, cols0 + c0s[:, None], 0.0)
                jit_all = ctx.motion.jitter_batch(t_nc, cols_ccd.ravel(), rows_ccd.ravel()
                                                  ).reshape(T, len(group), S, 2)
                rows_t0 = rows0 + np.where(valid, jit_all[0, :, :, 1], 0.0)
                cols_t0 = cols0 + np.where(valid, jit_all[0, :, :, 0], 0.0)
                fluxes0 = np.stack([st.fluxes0 for st, _, _ in group])
                p0 = np.concatenate([rows_t0, cols_t0, fluxes0], axis=1)    # (N, 3S)

                tr_b = np.array([st.target_row + (st.stamp[0] - r0) for st, r0, _ in group])
                tc_b = np.array([st.target_col + (st.stamp[2] - c0) for st, _, c0 in group])
                mini = np.stack([minimum_aperture_mask((bh, bw), tr, tcol)
                                 for tr, tcol in zip(tr_b, tc_b)])
                target_idx = np.array([st.target_idx for st, _, _ in group], np.int64)

            with span("psf.gather"):
                imgs, bkgs = context_stamps(ctx, r0s, c0s, bh, bw)
                imgs = torch.where(torch.as_tensor(logical, device=dev)[:, None], imgs,
                                   torch.nan)
                mini_d = torch.as_tensor(mini, device=dev)
                fbkg_d = torch.nansum(torch.where(mini_d[:, None], bkgs,
                                                  torch.zeros((), device=dev)), dim=(2, 3))

            with span("psf.fit"):
                out = fit_psf_timeseries_batch(
                    imgs, torch.nan_to_num(bkgs, nan=0.0), float(np.float32(var_const)),
                    torch.as_tensor(p0, dtype=torch.float32, device=dev),
                    torch.as_tensor(valid, device=dev), mini_d,
                    torch.as_tensor(target_idx, device=dev), prf, (bh, bw), S, lhood_stat,
                    fused=fused)
                flux, flux_err, pos, fbkg = (_host(x).astype(np.float64) for x in
                                             (out["flux"], out["flux_err"], out["pos"], fbkg_d))

            with span("psf.results"):
                # centroid in 1-based CCD coords (MOM_CENTR convention):
                cent = np.stack([pos[:, :, 1] + c0s[:, None] + 1,
                                 pos[:, :, 0] + r0s[:, None] + 1], axis=2)

                metrics = compute_metrics_batch(
                    torch.as_tensor(ctx.time, dtype=torch.float32, device=dev),
                    torch.as_tensor(flux, dtype=torch.float32, device=dev),
                    torch.as_tensor(flux_err, dtype=torch.float32, device=dev),
                    torch.as_tensor(ctx.quality, device=dev),
                    torch.as_tensor(cent, dtype=torch.float32, device=dev))
                metrics = {k: _host(v) for k, v in metrics.items()}

                diag_models = diag_data = diag_mid = None
                if keep_diag:
                    # Best-fit model images at the middle cadence, for the fit /
                    # residual diagnostic figure (psf_photometry.py:178-185).
                    diag_mid = T // 2
                    p_mid = out["params"][:, diag_mid]                        # (N, 3S)
                    pm = torch.stack([p_mid[:, :S], p_mid[:, S:2 * S], p_mid[:, 2 * S:]], dim=2)
                    diag_models = _host(prf.render_batch(pm, (bh, bw), CUTOFF_RADIUS))
                    diag_data = _host(imgs[:, diag_mid])

                for i, (setup, r0, c0) in enumerate(group[:N]):
                    s = setup.stamp
                    nh, nw = s[1] - s[0], s[3] - s[2]
                    mask_stamp = minimum_aperture_mask((nh, nw), setup.target_row,
                                                       setup.target_col)
                    sum_stamp = ctx.sumimage[s[0]:s[1], s[2]:s[3]]
                    aperture = aperture_image(ctx, s, mask_stamp)

                    status = STATUS.OK
                    details = {
                        "mean_flux": float(metrics["mean_flux"][i]),
                        "variance": float(metrics["variance"][i]),
                        "rms_hour": float(metrics["rms_hour"][i]),
                        "ptp": float(metrics["ptp"][i]),
                        "variability": float(metrics["variability"][i]),
                        "pos_centroid": metrics["pos_centroid"][i].tolist(),
                        "mask_size": int(mask_stamp.sum()),
                        "stamp": tuple(s),
                        "stamp_resizes": 0,
                        "n_stars_fit": int(setup.valid.sum()),
                    }
                    if np.all(~np.isfinite(flux[i])):
                        status = STATUS.ERROR
                        details["errors"] = ["Final lightcurve fluxes are all NaNs"]
                    if keep_diag:
                        details["diag_fit"] = {"data": diag_data[i], "model": diag_models[i],
                                               "cadence": diag_mid,
                                               "mini_aperture": np.asarray(mini[i])}

                    t_i, tc_i = ctx.corrected_time(setup.target["ra"], setup.target["decl"])
                    lc = {
                        "time": t_i, "timecorr": tc_i,
                        "cadenceno": ctx.cadenceno, "quality": ctx.quality,
                        "flux": flux[i], "flux_err": flux_err[i],
                        "flux_background": fbkg[i],
                        "pos_centroid": cent[i],
                        "pos_corr": jit_all[:, i, setup.target_idx, :],
                    }
                    stamp_wcs = None
                    if ctx.wcs is not None:
                        stamp_wcs = ctx.wcs.copy()
                        if ctx.datasource == "ffi":      # a TPF's WCS is the stamp's already
                            stamp_wcs.crpix = stamp_wcs.crpix - np.array([s[2], s[0]])

                    results[setup.starid] = TargetResult(
                        starid=setup.starid, method="psf", status=status,
                        sector=ctx.sector, camera=ctx.camera, ccd=ctx.ccd,
                        cadence=ctx.cadence, data_rel=ctx.data_rel,
                        target=setup.target, lightcurve=lc, mask=mask_stamp,
                        aperture_image=aperture, sumimage_stamp=sum_stamp,
                        stamp=tuple(s), details=details, num_frm=ctx.num_frm,
                        n_readout=ctx.n_readout, ticver=ctx.catalog.settings.ticver,
                        stamp_wcs=stamp_wcs)
    return [results[int(sid)] for sid in starids]
