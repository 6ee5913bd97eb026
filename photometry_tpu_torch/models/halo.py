"""
Halo photometry: TV-minimised weighted-aperture light curves for saturated stars.

Port of ``photometry_tpu/models/halo.py`` (reference
photometry/halo/halo_photometry.py, which delegates to ``halophot``): pixel
weights ``w = softmax(z)`` minimise a variation objective of the weighted,
per-pixel median-normalised flux,

    F_t   = sum_p w_p f_tp / median_t(f_tp)
    TV(w) = sum_t |F_t - F_{t-1}| / mean(F)

by Adam over a fixed iteration count, per time-split segment, on a 22x22
stamp of the pixels within 20 px of the target; the flux is rescaled by
mag2flux(tmag), errors propagate through the weightmap, and the weightmap
is kept for the FITS WEIGHTMAP extension.

The descent is torch code, batched over targets (no hand kernel: the JAX
package runs it in XLA).  Its gradient is written out rather than taken by
autograd: the objective is linear in ``w`` up to the outer function of
``dF = D @ w``, so one step is two matvecs over the (T, P) matrix and a
softmax, with no graph over the iterations.  It also fixes |x|'(0) = +1,
the derivative JAX takes at 0 (torch's autograd takes 0 there).  Adam runs
in float32 with optax's constants and bias correction; nothing in the loop
synchronises with the host.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..core.engine import TargetResult, _full_catalog_positions, _host, aperture_image
from ..core.metrics import compute_metrics_batch
from ..core.status import STATUS
from ..parallel.mesh import map_time
from ..quality import TESSQualityFlags
from ..utils.mathutils import mag2flux

logger = logging.getLogger(__name__)

__all__ = ["DIST_MAX", "STAMP_SIZE", "MAXITER", "LEARNING_RATE", "SATURATION_FLUX",
           "OBJECTIVES", "SECTOR_SPLITS", "tvmin_weights", "tvmin_weights_batch",
           "find_split_times", "extract_halo_batch"]

DIST_MAX = 20.0
STAMP_SIZE = 22
MAXITER = 101
LEARNING_RATE = 0.05
#: Approximate calibrated flux of a saturated TESS pixel [e-/s]; used for
#: the per-segment SAT_PIXELS diagnostic (halo_photometry.py:210-226).
SATURATION_FLUX = 1.5e5
#: Supported objective functions (halophot's tv/tv_o2/l2v/l3v variants).
OBJECTIVES = ("tv", "tv_o2", "l2v", "l3v")

#: Hard-coded downlink-gap split times per sector (halo_photometry.py:126-138).
SECTOR_SPLITS = {
    1: (1339.0, 1347.366, 1349.315),
    2: (1368.0,),
    3: (1395.52,),
    8: (1529.50,),
}


def _tvmin_core(flux_norm, good_time, pixel_ok, maxiter: int, lr: float, objective: str):
    """TV-min of N (T, P) instances: ``flux_norm`` (N, T, P) float32,
    ``good_time`` (N, T) and ``pixel_ok`` (N, P) bool; returns (w (N, P),
    objective (N,)) at the final logits.

    ``D`` (first- or second-order differences, good-cadence rows only) and
    the good-cadence column means are formed once; each step is ``D @ w``,
    ``D^T s`` and the softmax Jacobian-vector product.
    """
    f32 = torch.float32
    gt = good_time.to(f32)
    n_good = torch.clamp(gt.sum(-1), min=1.0)
    mean_fn = (gt[:, None, :] @ flux_norm)[:, 0] / n_good[:, None]          # (N, P)
    if objective == "tv_o2":
        ok = good_time[:, 2:] & good_time[:, 1:-1] & good_time[:, :-2]
        D = ((flux_norm[:, 2:] - 2.0 * flux_norm[:, 1:-1] + flux_norm[:, :-2])
             * ok[..., None].to(f32))
    else:
        both = good_time[:, 1:] & good_time[:, :-1]
        D = (flux_norm[:, 1:] - flux_norm[:, :-1]) * both[..., None].to(f32)
    Dt = D.transpose(1, 2).contiguous()
    # Masked-pixel logits: softmax weight exactly 0, and so is their gradient.
    zmask = torch.where(pixel_ok, 0.0, -1e30).to(f32)

    def forward(z):
        w = torch.softmax(z + zmask, dim=-1)
        dF = (D @ w[..., None])[..., 0]                                      # (N, Tm)
        if objective == "l2v":
            num = torch.sum(dF * dF, dim=-1)
        elif objective == "l3v":
            num = torch.sum(torch.abs(dF) ** 3, dim=-1)
        else:
            num = torch.sum(torch.abs(dF), dim=-1)
        mean_F = torch.sum(mean_fn * w, dim=-1)
        return w, dF, num, mean_F

    def value(num, mean_F):
        return num / torch.clamp(mean_F, min=1e-30)

    def grad(z):
        w, dF, num, mean_F = forward(z)
        if objective == "l2v":
            s = 2.0 * dF
        elif objective == "l3v":
            s = 3.0 * dF * torch.abs(dF)
        else:
            s = torch.where(dF >= 0, 1.0, -1.0)
        M = torch.clamp(mean_F, min=1e-30)
        dM = (mean_F > 1e-30).to(f32) * (-num / (M * M))                   # d value / d mean_F
        g_w = (Dt @ s[..., None])[..., 0] / M[:, None] + dM[:, None] * mean_fn
        return w * (g_w - torch.sum(w * g_w, dim=-1, keepdim=True))

    z = torch.zeros_like(mean_fn)
    m = torch.zeros_like(z)
    v = torch.zeros_like(z)
    for t in range(1, maxiter + 1):
        g = grad(z)
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        # bias corrections in float32, as a float32 step counter gives them:
        mhat = m / float(np.float32(1) - np.float32(0.9) ** np.float32(t))
        vhat = v / float(np.float32(1) - np.float32(0.999) ** np.float32(t))
        z = z - lr * mhat / (torch.sqrt(vhat) + 1e-8)
    w, _, num, mean_F = forward(z)
    return w, value(num, mean_F)


def _check_objective(objective: str):
    if objective not in OBJECTIVES:
        raise ValueError(f"Invalid halo objective: '{objective}'")


def tvmin_weights(flux_norm, good_time, maxiter: int = MAXITER, lr: float = LEARNING_RATE,
                  objective: str = "tv"):
    """Optimise softmax pixel weights minimising a variation objective.

    Parameters:
        flux_norm: (T, P) per-pixel median-normalised fluxes (NaN-free).
        good_time: (T,) bool — cadences that participate in the objective.
        objective: ``tv`` sum |dF| / mean(F), ``tv_o2`` sum |d2F| / mean(F),
            ``l2v`` sum dF^2 / mean(F), ``l3v`` sum |dF|^3 / mean(F).

    Returns:
        (w, value): (P,) weights summing to 1, and the final objective value.
    """
    _check_objective(objective)
    flux_norm = torch.as_tensor(flux_norm, dtype=torch.float32)
    good_time = torch.as_tensor(good_time, dtype=torch.bool, device=flux_norm.device)
    ok = torch.ones(1, flux_norm.shape[1], dtype=torch.bool, device=flux_norm.device)
    w, val = _tvmin_core(flux_norm[None], good_time[None], ok, maxiter, lr, objective)
    return w[0], val[0]


def tvmin_weights_batch(flux_norm, good_time, pixel_ok, maxiter: int = MAXITER,
                        lr: float = LEARNING_RATE, objective: str = "tv"):
    """Batched TV-min: N targets at once (the production halo path).

    Parameters:
        flux_norm: (N, T, P) median-normalised pixel fluxes, the pixel axis
            padded to a common P (padding value irrelevant: masked).
        good_time: (N, T) bool per-target objective cadences.
        pixel_ok: (N, P) bool — valid pixels; masked pixels get weight 0.

    Returns:
        (w, value): (N, P) weights (each row sums to 1 over its valid
        pixels) and (N,) final objective values.
    """
    _check_objective(objective)
    flux_norm = torch.as_tensor(flux_norm, dtype=torch.float32)
    dev = flux_norm.device
    return _tvmin_core(flux_norm, torch.as_tensor(good_time, dtype=torch.bool, device=dev),
                       torch.as_tensor(pixel_ok, dtype=torch.bool, device=dev),
                       maxiter, lr, objective)


def find_split_times(sector: int, time, timecorr) -> tuple:
    """Split timestamps: per-sector table, else the mid-series gap finder."""
    if sector in SECTOR_SPLITS:
        splits = SECTOR_SPLITS[sector]
    else:
        t = time - timecorr
        dt = np.append(np.diff(t), 0)
        t0 = np.nanmin(t)
        ttot = np.nanmax(t) - t0
        indx = (t0 + 0.30 * ttot < t) & (t < t0 + 0.70 * ttot) & (dt > 0.5)
        if np.sum(indx) == 1:
            i = int(np.where(indx)[0][0])
            splits = (0.5 * (t[i] + t[i + 1]) + timecorr[i],)
        else:
            splits = None
    if splits is not None:
        splits = tuple(s for s in splits if np.nanmin(time) < s < np.nanmax(time))
        if not splits:
            splits = None
    return splits


def extract_halo_batch(ctx, starids, maxiter: int = MAXITER, objective: str = "tv",
                       sigclip: bool = False, **_kw) -> list:
    """Halo photometry for a batch of targets on one context.

    ``objective`` selects the halophot variation objective; ``sigclip`` adds
    one sigma-clipping pass per segment: cadences deviating > 3 robust sigma
    from the segment's median flux leave the objective and the weights are
    optimised again (halophot's sigclip option, halo_photometry.py:87-97).
    The batch descends together, one :func:`tvmin_weights_batch` call per
    time segment, after one batched stamp fetch.
    """
    T = ctx.n_times
    H, W = ctx.shape
    dev = ctx.device
    cat_all = _full_catalog_positions(ctx)

    def _error(sid, tgt, msg):
        return TargetResult(
            starid=int(sid), method="halo", status=STATUS.ERROR,
            sector=ctx.sector, camera=ctx.camera, ccd=ctx.ccd,
            cadence=ctx.cadence, data_rel=ctx.data_rel, target=tgt,
            lightcurve={}, details={"errors": [msg]},
            num_frm=ctx.num_frm, n_readout=ctx.n_readout,
            ticver=ctx.catalog.settings.ticver)

    # ---- stamp geometry and pixel masks (host) -------------------------------
    half = STAMP_SIZE // 2
    h = min(STAMP_SIZE, H)
    w = min(STAMP_SIZE, W)
    results = {}
    work = []       # (sid, tgt, row, col, r0, c0, pixel_mask)
    for sid in starids:
        tgt = ctx.catalog.target(int(sid))
        row, col = ctx.target_position(tgt["ra"], tgt["decl"])
        # 22x22 stamp around the target (halo_photometry.py:101-102):
        r0 = int(np.clip(int(round(row)) - half, 0, max(H - STAMP_SIZE, 0)))
        c0 = int(np.clip(int(round(col)) - half, 0, max(W - STAMP_SIZE, 0)))
        yy, xx = np.mgrid[0:h, 0:w]
        dist = np.hypot(yy + r0 - row, xx + c0 - col)
        pixel_mask = ctx.collected[r0:r0 + h, c0:c0 + w] & (dist <= DIST_MAX)
        if pixel_mask.sum() < 4:
            results[int(sid)] = _error(sid, tgt, "Too few pixels for halo photometry")
            continue
        work.append((int(sid), tgt, row, col, r0, c0, pixel_mask))
    if not work:
        return [results[int(s)] for s in starids]

    # ---- one batched stamp fetch, normalised on the host in float64 -----------
    def fetch(cube):
        """(N, T, h, w) float64 stamps, sliced where the cube lies (a host
        cube's slabs on the host, as photometry_tpu/models/halo.py:258-262;
        a mesh context's shard by shard, joined in time order and cut to
        the true T) and widened there (numpy has no bfloat16)."""
        def slabs(c):
            return torch.stack([c[:, r0:r0 + h, c0:c0 + w]
                                for (_, _, _, _, r0, c0, _) in work]).to(torch.float32)
        return _host(map_time(cube, slabs, 1)).astype(np.float64)

    imgs_all, errs_all = fetch(ctx.images), fetch(ctx.images_err)

    good_t = np.isfinite(ctx.time)
    quality_ok = TESSQualityFlags.filter(ctx.quality)
    fns, usables, meds, n_sats, kept = [], [], [], [], []
    for i, (sid, tgt, row, col, r0, c0, pixel_mask) in enumerate(work):
        flux_pix = imgs_all[i][:, pixel_mask]               # (T, P_i)
        med = np.nanmedian(flux_pix, axis=0)
        usable = np.isfinite(med) & (med > 0)
        if usable.sum() < 1:
            results[sid] = _error(sid, tgt, "Halo optimization failed")
            continue
        fn = flux_pix[:, usable] / med[usable][None, :]
        fns.append(np.nan_to_num(fn, nan=1.0))
        usables.append(usable)
        meds.append(med[usable])
        # Saturated pixels among the usable mask pixels:
        n_sats.append(int(np.sum(med[usable] > SATURATION_FLUX)))
        kept.append(i)
    work = [work[i] for i in kept]
    errs_all = errs_all[kept]
    if not work:
        return [results[int(s)] for s in starids]

    # The pixel axis is padded to the widest target; padded pixels are
    # masked (weight exactly 0) and their constant 1.0 adds nothing to D.
    N = len(work)
    P_max = max(f.shape[1] for f in fns)
    fn_pad = np.ones((N, T, P_max), np.float32)
    pix_ok = np.zeros((N, P_max), bool)
    for i, f in enumerate(fns):
        fn_pad[i, :, :f.shape[1]] = f
        pix_ok[i, :f.shape[1]] = True

    # ---- batched TV-min per time segment --------------------------------------
    splits = find_split_times(ctx.sector, ctx.time, ctx.timecorr)
    edges = [-np.inf] + (list(splits) if splits else []) + [np.inf]
    seg_weights = []    # (seg_idx, (N, P_max) weights)
    fn_dev = torch.as_tensor(fn_pad, device=dev)
    pix_dev = torch.as_tensor(pix_ok, device=dev)
    for a, b in zip(edges[:-1], edges[1:]):
        seg = good_t & (ctx.time > a) & (ctx.time <= b)
        if seg.sum() < 3:
            continue
        seg_idx = np.where(seg)[0]
        gt = (quality_ok & seg)[seg_idx]                    # shared (T_seg,)
        fseg = fn_dev[:, torch.as_tensor(seg_idx, device=dev)]
        keep_b = np.broadcast_to(gt, (N, gt.size)).copy()
        w_b, _ = tvmin_weights_batch(fseg, torch.as_tensor(keep_b, device=dev), pix_dev,
                                     maxiter=maxiter, objective=objective)
        w_b = _host(w_b).astype(np.float64)
        if sigclip:
            # One robust-sigma clipping pass on the optimised fluxes; the
            # batch descends again with per-target keep masks (targets that
            # do not clip keep theirs: the descent is deterministic):
            F0 = np.einsum("ntp,np->nt", fn_pad[:, seg_idx], w_b)
            any_clip = False
            for i in range(N):
                medF = np.nanmedian(F0[i][gt])
                mad = 1.4826 * np.nanmedian(np.abs(F0[i][gt] - medF))
                keep = gt & (np.abs(F0[i] - medF) <= 3.0 * max(mad, 1e-12))
                if keep.sum() >= 3 and keep.sum() < gt.sum():
                    keep_b[i] = keep
                    any_clip = True
            if any_clip:
                w_b, _ = tvmin_weights_batch(fseg, torch.as_tensor(keep_b, device=dev), pix_dev,
                                             maxiter=maxiter, objective=objective)
                w_b = _host(w_b).astype(np.float64)
        seg_weights.append((seg_idx, w_b))

    # ---- per-target light curves -------------------------------------------------
    curves = []     # (work item, flux, flux_err, halo_weightmap)
    for i, item in enumerate(work):
        sid, tgt, row, col, r0, c0, pixel_mask = item
        usable, med = usables[i], meds[i]
        P = med.size
        flux_out = np.full(T, np.nan)
        flux_err_out = np.full(T, np.nan)
        wm_list, cad1_list, cad2_list, sat_list = [], [], [], []
        normfactor = float(mag2flux(tgt["tmag"]))
        for seg_idx, w_b in seg_weights:
            wseg = w_b[i, :P]
            flux_out[seg_idx] = (fns[i][seg_idx] @ wseg) * normfactor
            # weightmap in raw-flux units (w applied to raw pixel values):
            wm_pix = np.zeros(pixel_mask.sum())
            wm_pix[usable] = wseg / med
            wm = np.zeros((h, w))
            wm[pixel_mask] = wm_pix
            flux_err_out[seg_idx] = np.abs(normfactor) * np.sqrt(
                np.nansum(wm[None] ** 2 * errs_all[i][seg_idx] ** 2, axis=(1, 2)))
            wm_list.append(wm.astype(np.float32))
            cad1_list.append(int(ctx.cadenceno[seg_idx[0]]))
            cad2_list.append(int(ctx.cadenceno[seg_idx[-1]]))
            sat_list.append(n_sats[i])
        if not wm_list:
            results[sid] = _error(sid, tgt, "Halo optimization failed")
            continue
        curves.append((item, flux_out, flux_err_out, {
            "initial_cadence": cad1_list, "final_cadence": cad2_list,
            "sat_pixels": sat_list, "weightmap": np.stack(wm_list)}))
    if not curves:
        return [results[int(s)] for s in starids]

    # Positions: catalog + jitter (halo computes no centroids):
    rows = np.array([c[0][2] for c in curves])
    cols = np.array([c[0][3] for c in curves])
    jit_all = ctx.motion.jitter_batch(ctx.time - ctx.timecorr, cols, rows)     # (T, n, 2)
    pos = np.stack([cols[None] + 1 + jit_all[..., 0], rows[None] + 1 + jit_all[..., 1]],
                   axis=-1).transpose(1, 0, 2)                                # (n, T, 2)
    metrics = compute_metrics_batch(
        torch.as_tensor(ctx.time, dtype=torch.float32, device=dev),
        torch.as_tensor(np.stack([c[1] for c in curves]), dtype=torch.float32, device=dev),
        torch.as_tensor(np.stack([c[2] for c in curves]), dtype=torch.float32, device=dev),
        torch.as_tensor(ctx.quality, device=dev),
        torch.as_tensor(pos, dtype=torch.float32, device=dev))
    metrics = {k: _host(v) for k, v in metrics.items()}

    for j, ((sid, tgt, row, col, r0, c0, pixel_mask), flux_out, flux_err_out,
            halo_wm) in enumerate(curves):
        s = (r0, r0 + h, c0, c0 + w)
        # skip targets: catalog stars inside the pixel mask:
        rr = np.round(cat_all["row"]).astype(int) - r0
        cc = np.round(cat_all["col"]).astype(int) - c0
        inside = (rr >= 0) & (rr < h) & (cc >= 0) & (cc < w)
        in_mask = np.zeros(len(cat_all["starid"]), bool)
        in_mask[inside] = pixel_mask[rr[inside], cc[inside]]
        skip_targets = [int(x) for x in cat_all["starid"][in_mask] if int(x) != int(sid)]

        details = {
            "mean_flux": float(metrics["mean_flux"][j]),
            "variance": float(metrics["variance"][j]),
            "rms_hour": float(metrics["rms_hour"][j]),
            "ptp": float(metrics["ptp"][j]),
            "variability": float(metrics["variability"][j]),
            "pos_centroid": metrics["pos_centroid"][j].tolist(),
            "mask_size": int(pixel_mask.sum()),
            "stamp": s,
            "stamp_resizes": 0,
            "halo_weightmap": halo_wm,
        }
        add_headers = {
            "HALO_VER": ("photometry-tpu-torch", "Native PyTorch TV-min implementation"),
            "HALO_OBJ": (objective, "Halo objective function"),
            "HALO_MXI": (maxiter, "Halo max optimisation iterations"),
            "HALO_SCL": (bool(sigclip), "Halo sigma clipping"),
        }
        t_i, tc_i = ctx.corrected_time(tgt["ra"], tgt["decl"])
        lc = {
            "time": t_i, "timecorr": tc_i,
            "cadenceno": ctx.cadenceno, "quality": ctx.quality,
            "flux": flux_out, "flux_err": flux_err_out,
            "flux_background": np.full(T, np.nan),
            "pos_centroid": pos[j], "pos_corr": jit_all[:, j, :],
        }
        stamp_wcs = None
        if ctx.wcs is not None:
            stamp_wcs = ctx.wcs.copy()
            if ctx.datasource == "ffi":      # a TPF's WCS is the stamp's already
                stamp_wcs.crpix = stamp_wcs.crpix - np.array([c0, r0])

        results[sid] = TargetResult(
            starid=int(sid), method="halo", status=STATUS.OK,
            sector=ctx.sector, camera=ctx.camera, ccd=ctx.ccd,
            cadence=ctx.cadence, data_rel=ctx.data_rel, target=tgt,
            lightcurve=lc, mask=pixel_mask,
            aperture_image=aperture_image(ctx, s, pixel_mask),
            sumimage_stamp=ctx.sumimage[s[0]:s[1], s[2]:s[3]],
            stamp=s, details=details, additional_headers=add_headers,
            skip_targets=skip_targets, num_frm=ctx.num_frm,
            n_readout=ctx.n_readout, ticver=ctx.catalog.settings.ticver,
            stamp_wcs=stamp_wcs)
    return [results[int(s)] for s in starids]
