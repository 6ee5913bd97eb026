"""A pool of Target Pixel Files of one CCD, written in set-up from the seed.

Frozen copies of the smoke run's phase-8 builders (``tpf_layout``,
``tpf_signal``, ``write_phase8``, ``write_tpf``) with the sizes of the
configuration: ``n_tpf`` isolated primaries of Tmag 8-11 on the seeded
field, their stamps 21x21 (the brightest eighth), 15x15 (the next eighth)
or 11x11, T cadences at ``cadence_s``, POS_CORR drifting, a 1% sinusoid on
each primary, every field star within 8 px of a stamp rendered into it,
SPOC aperture bits, ``gzip`` of the files gzipped.  The files go through
the program's FITS writer (an input format, as a mission file would be);
the pixel arrays stay in memory for the reference.
"""

import os

import numpy as np
import torch

from . import field as fld
from .todo import write_todo


def pick(rng, rows, cols, tmag, n, H, W):
    """Indices of ``n`` primaries (isolated: no star within 12 px brighter
    than 2 mag fainter; 30 px from the edges and from each other) in Tmag
    order, and their stamp sides."""
    picked = []
    for i in rng.permutation(np.where((tmag >= 8.0) & (tmag <= 11.0))[0]):
        r, c = rows[i], cols[i]
        if min(r, c, H - 1 - r, W - 1 - c) < 30:
            continue
        d = np.hypot(rows - r, cols - c)
        if np.any((d < 12) & (d > 0) & (tmag < tmag[i] + 2)):
            continue
        if any(np.hypot(rows[j] - r, cols[j] - c) < 30 for j in picked):
            continue
        picked.append(int(i))
        if len(picked) == n:
            break
    if len(picked) != n:
        raise RuntimeError(f"room for {len(picked)} of {n} TPF targets")
    idx = np.array(picked)
    main = idx[np.argsort(tmag[idx], kind="stable")]
    sides = np.full(len(main), 11)
    q = len(main) // 8
    sides[:q], sides[q:2 * q] = 21, 15
    return main, sides


def signal(device, gen, rows, cols, tmag, i, r0, c0, side, t, pos_corr, amp, period, phase, sig):
    """A TPF's (T, side, side) flux, flux_err and background (float32, host):
    the field stars near the stamp at their positions plus ``pos_corr``,
    star ``i`` with its sinusoid, Gaussian noise of
    sqrt((flux + 20) / 96 + (10 / 96)^2) on a 20 e-/s background."""
    T = len(t)
    near = np.where((rows > r0 - 8) & (rows < r0 + side + 8)
                    & (cols > c0 - 8) & (cols < c0 + side + 8))[0]
    f64 = dict(device=device, dtype=torch.float64)
    yy = torch.arange(r0, r0 + side, **f64)[None, :, None]
    xx = torch.arange(c0, c0 + side, **f64)[None, None, :]
    dc = torch.as_tensor(pos_corr[:, 0], **f64)[:, None, None]
    dr = torch.as_tensor(pos_corr[:, 1], **f64)[:, None, None]
    tt = torch.as_tensor(t, **f64)
    flux = torch.zeros(T, side, side, **f64)
    for j in near:
        f = float(fld.mag2flux(tmag[j]))
        fj = f * (1 + amp * torch.sin(2 * np.pi * tt / period + phase)) if j == i else \
            torch.full_like(tt, f)
        g = torch.exp(-0.5 * ((yy - rows[j] - dr) ** 2 + (xx - cols[j] - dc) ** 2) / sig ** 2)
        flux += fj[:, None, None] * g / (2 * np.pi * sig ** 2)
    sigma = torch.sqrt((flux + 20.0) / 96.0 + (10.0 / 96.0) ** 2)
    flux = flux + sigma * torch.randn(flux.shape, generator=gen, **f64)
    return (flux.float().cpu().numpy(), sigma.float().cpu().numpy(),
            np.full((T, side, side), 20.0, np.float32))


def write_tpf(path, ticid, sector, camera, ccd, columns, aperture, ap_header, cadence):
    """A Target Pixel File in the SPOC layout (gzipped if ``path`` ends in .gz)."""
    from photometry_tpu_torch.io import fits as pf
    prim, pix = pf.Header(), pf.Header()
    for key, v in (("TELESCOP", "TESS"), ("TICID", int(ticid)), ("SECTOR", sector),
                   ("CAMERA", camera), ("CCD", ccd), ("DATA_REL", 38)):
        prim.set(key, v)
    pix.set("TIMEDEL", cadence / 86400)
    pf.write_fits(path, [pf.PrimaryHDU(None, header=prim),
                         pf.BinTableHDU(columns, header=pix, name="PIXELS"),
                         pf.ImageHDU(aperture, header=ap_header, name="APERTURE")],
                  checksum=False)


def pool(cfg, seed, device, folder):
    """Write the pool, its catalog and its todo list into ``folder``.  The
    field, the primaries, their stamps and which files are gzipped come
    from the configuration's ``field_seed`` (every seed gets the same
    work); the seed draws each primary's period and phase and the noise.
    Returns {"planes": {primary starid: (flux, err, bkg)}, "tasks":
    [(starid, tmag, datasource)], "bytes": bytes of pixel files}."""
    from photometry_tpu_torch.catalog import make_catalog_from_arrays
    from photometry_tpu_torch.io import fits as pf
    rng = np.random.default_rng(cfg["field_seed"])
    run_rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    H, W, T, cadence = cfg["rows"], cfg["cols"], cfg["n_times"], cfg["cadence_s"]
    sig = cfg["field"]["psf_sigma_px"]
    rows, cols, tmag, _ = fld.make_field(rng, cfg["field"], H, W, image=False)
    wcs = fld.field_wcs(H, W)
    ra, dec = wcs.radec_of_rowcol(rows, cols)
    os.makedirs(folder, exist_ok=True)
    make_catalog_from_arrays(folder, 1, 1, 1, starid=np.arange(1, len(rows) + 1),
                             ra_j2000=ra, dec_j2000=dec, pm_ra=np.zeros(len(rows)),
                             pm_dec=np.zeros(len(rows)), tmag=tmag, reference_time=2458340.0)
    main, sides = pick(rng, rows, cols, tmag, cfg["n_tpf"], H, W)
    gz = set(rng.choice(len(main), cfg["gzip"], replace=False).tolist())
    planes, tasks, nbytes = {}, [], 0
    t = 1325.3 + (np.arange(T) + 0.5) * cadence / 86400
    days = t - t[0]
    pos_corr = np.stack([0.03 * days + 0.05 * np.sin(2 * np.pi * days / 1.1),
                         -0.02 * days + 0.04 * np.cos(2 * np.pi * days / 0.7)],
                        axis=1).astype(np.float32)
    for k, (i, side) in enumerate(zip(main, sides)):
        r0 = int(round(rows[i])) - side // 2
        c0 = int(round(cols[i])) - side // 2
        period, phase = run_rng.uniform(1.0, 5.0), run_rng.uniform(0, 2 * np.pi)
        flux, err, bkg = signal(device, gen, rows, cols, tmag, i, r0, c0, side, days, pos_corr,
                                0.01, period, phase, sig)
        quality = np.zeros(T, np.int32)
        quality[::2500] = 32                                  # Desat: out of the sum image
        aperture = np.full((side, side), 1 | 64, np.int32)
        aperture[[0, -1], :] |= 4
        aperture[:, [0, -1]] |= 4
        mid = side // 2
        aperture[mid - 1:mid + 2, mid - 1:mid + 2] |= 2 | 8
        ap_hdr = wcs.shifted(drow=r0, dcol=c0).to_header(pf.Header())
        ap_hdr.set("CRVAL1P", c0 + 1)
        ap_hdr.set("CRVAL2P", r0 + 1)
        sid = int(i) + 1
        path = os.path.join(folder, f"tess2020186164531-s0001-{sid:016d}-0120-s_tp.fits"
                            + (".gz" if k in gz else ""))
        write_tpf(path, sid, 1, 1, 1,
                  {"TIME": t + 0.003, "TIMECORR": np.full(T, 0.003, np.float32),
                   "CADENCENO": np.arange(T, dtype=np.int32), "FLUX": flux, "FLUX_ERR": err,
                   "FLUX_BKG": bkg, "QUALITY": quality, "POS_CORR1": pos_corr[:, 0],
                   "POS_CORR2": pos_corr[:, 1]}, aperture, ap_hdr, cadence)
        nbytes += os.path.getsize(path)
        planes[sid] = (flux, err, bkg)
        tasks.append((sid, float(tmag[i]), "tpf"))
        # Secondary targets, as the todo list finds them: catalog stars
        # brighter than Tmag 15 whose pixel lies inside the collected stamp.
        y, x = rows - r0, cols - c0
        inside = (x >= -0.5) & (y >= -0.5) & (x <= side - 0.5) & (y <= side - 0.5)
        inside[i] = False
        for j in np.where(inside & (tmag < 15.0))[0]:
            tasks.append((int(j) + 1, float(tmag[j]), f"tpf:{sid}"))
    write_todo(folder, [s for s, _, _ in tasks], [m for _, m, _ in tasks],
               datasources=[d for _, _, d in tasks], cadences=[cadence] * len(tasks))
    return {"planes": planes, "tasks": tasks, "bytes": nbytes}
