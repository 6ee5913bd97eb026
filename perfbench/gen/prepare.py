"""Raw full-frame images of one CCD for the prepare stage, written in set-up.

Frozen copy of the smoke run's phase-5 builders (``prepare_inputs``,
``phase5_tpf``): T calibrated FFIs in the raw TESS geometry (the science
area at rows 0:H, columns 44:44+W of a ``raw_rows`` x ``raw_cols`` frame),
CAL and UNCERT HDUs, of the field of ``field.make_field`` (drawn from the
configuration's ``field_seed``) on a sky of ``sky`` e-/s with a glow
rising towards the corner farthest from the camera centre, drifting 5%
over the frames, with noise of (signal / ``exptime_s`` + 0.01) variance
drawn from the seed on the card, a saturated 30x30 patch in frame 70 % T
and the ``flagged_frames`` flagged by the spacecraft (DQUALITY); a
catalog and one 2-min TPF.  The files go through the program's FITS writer; the pixel arrays the
reference needs are kept on the card.
"""

import os

import numpy as np
import torch

from . import field as fld


def tpf_target(rows, cols, tmag, shape, side=11):
    """A star fainter than the 4,096 brightest (a third of a smaller field),
    20 px inside the CCD, whose stamp holds two or more other such stars:
    (index, r0, c0)."""
    skip_brightest = min(4096, len(tmag) // 3)
    rank = np.empty(len(tmag), int)
    rank[np.argsort(tmag, kind="stable")] = np.arange(len(tmag))
    faint = rank >= skip_brightest
    for i in np.where(faint)[0]:
        r0, c0 = int(round(rows[i])) - side // 2, int(round(cols[i])) - side // 2
        if min(r0, c0) < 20 or r0 + side > shape[0] - 20 or c0 + side > shape[1] - 20:
            continue
        y, x = rows - r0, cols - c0
        inside = (x >= -0.5) & (y >= -0.5) & (x <= side - 0.5) & (y <= side - 0.5)
        inside[i] = False
        if inside.sum() >= 2 and faint[inside].all():
            return int(i), r0, c0
    raise RuntimeError("no faint star with two faint neighbours for the TPF")


def frames(cfg, seed, device, folder):
    """Write the FFIs, the catalog and the TPF into ``folder``.  Returns the
    files in time order, the (T, H, W) science-area CAL and UNCERT planes
    on ``device``, and the sky: frame k's is ``glow * drift[k]``, with the
    (H, W) ``glow`` on ``device`` and the (T,) ``drift``."""
    from photometry_tpu_torch.catalog import make_catalog_from_arrays
    from photometry_tpu_torch.io import fits as pf
    from photometry_tpu_torch.ops.background import radial_coordinates
    from .tpf import write_tpf
    H, W, T = cfg["rows"], cfg["cols"], cfg["n_times"]
    sector, camera, ccd = cfg["sector"], cfg["camera"], cfg["ccd"]
    sky, exptime, dt = cfg["noise"]["sky"], cfg["noise"]["exptime_s"], cfg["cadence_s"] / 86400
    rng = np.random.default_rng(cfg["field_seed"])
    rows, cols, tmag, img0 = fld.make_field(rng, cfg["field"], H, W)
    wcs = fld.field_wcs(H, W)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    # Raw TESS geometry, or (a frame of the science area alone, at small
    # sizes) a simulated one with no column offset:
    raw = (cfg["raw_rows"], cfg["raw_cols"]) != (H, W)
    off = 44 if raw else 0
    r = radial_coordinates((H, W), camera, ccd, col_offset=off)
    glow = sky + 400.0 * np.exp(-(r.max() - r) / 200.0)
    drift = 1.0 + 0.05 * np.sin(2 * np.pi * np.arange(T) / T)
    bc, s0 = 0.003, cfg["tstart"]
    stars = torch.as_tensor(img0, device=device)
    glow_t = torch.as_tensor(glow.astype(np.float32), device=device)
    patch = (70 % T, slice(H // 2, H // 2 + 30), slice(W // 3, W // 3 + 30))
    hdr_wcs = wcs.shifted(dcol=-off).to_header()
    cal = torch.empty(T, H, W, device=device)
    unc = torch.empty(T, H, W, device=device)
    files = []
    os.makedirs(folder, exist_ok=True)
    raw_img = np.zeros((cfg["raw_rows"], cfg["raw_cols"]), np.float32)
    raw_unc = np.zeros_like(raw_img)
    for k in range(T):
        signal = stars + glow_t * float(drift[k])
        err = torch.sqrt(torch.clamp(signal, min=0.0) / exptime + 0.01)
        frame = signal + err * torch.randn(H, W, device=device, generator=gen)
        if k == patch[0]:
            frame[patch[1], patch[2]] += 1e5
        cal[k], unc[k] = frame, err
        raw_img[:H, off:off + W] = frame.cpu().numpy()
        raw_unc[:H, off:off + W] = err.cpu().numpy()
        hdr = pf.Header()
        for key, v in (("TELESCOP", "TESS" if raw else "SIMTESS"), ("CAMERA", camera), ("CCD", ccd),
                       ("SECTOR", sector), ("DATA_REL", 38), ("PROCVER", "spoc-5.0.20-20201228"),
                       ("TSTART", s0 + k * dt - dt / 2 + bc), ("TSTOP", s0 + k * dt + dt / 2 + bc),
                       ("EXPOSURE", exptime / 86400), ("BARYCORR", bc), ("FFIINDEX", 100000 + k),
                       ("NUM_FRM", 900), ("GAIN", 5.2), ("READNOIS", 10.0),
                       ("DQUALITY", int(cfg["flagged_frames"].get(str(k), 0)))):
            hdr.set(key, v)
        path = os.path.join(folder, f"tess{2018206190142 + k:013d}-s{sector:04d}-{camera}-{ccd}"
                                    f"-0120-s_ffic.fits")
        pf.write_fits(path, [pf.PrimaryHDU(None, header=hdr),
                             pf.ImageHDU(raw_img, header=hdr_wcs, name="CAL"),
                             pf.ImageHDU(raw_unc, name="UNCERT")], checksum=False)
        files.append(path)
    ra, dec = wcs.radec_of_rowcol(rows, cols)
    n = len(rows)
    make_catalog_from_arrays(folder, sector, camera, ccd, starid=np.arange(1, n + 1),
                             ra_j2000=ra, dec_j2000=dec, pm_ra=np.zeros(n), pm_dec=np.zeros(n),
                             tmag=tmag, reference_time=cfg["reference_time"])
    # One 2-min TPF over the frames, Desat (32) in two frames' cadences:
    nt = 15 * T
    u = s0 - dt / 2 + (np.arange(nt) + 0.5) * 120 / 86400
    quality = np.zeros(nt, np.int32)
    for f in sorted({10 % T, 50 % T}):
        quality[15 * f + 2] = 32
    i, r0, c0 = tpf_target(rows, cols, tmag, (H, W))
    ap = wcs.shifted(drow=r0, dcol=c0).to_header(pf.Header())
    ap.set("CRVAL1P", c0 + 1)
    ap.set("CRVAL2P", r0 + 1)
    flux = np.full((nt, 11, 11), 100.0, np.float32)
    write_tpf(os.path.join(folder, f"tess2018206190142-s{sector:04d}-{i + 1:016d}-0120-s_tp.fits"),
              i + 1, sector, camera, ccd,
              {"TIME": u + bc, "TIMECORR": np.full(nt, bc, np.float32),
               "CADENCENO": np.arange(nt, dtype=np.int32), "FLUX": flux,
               "FLUX_ERR": np.ones_like(flux), "QUALITY": quality},
              np.ones((11, 11), np.int32), ap, 120)
    return files, cal, unc, {"glow": glow_t, "drift": drift}
