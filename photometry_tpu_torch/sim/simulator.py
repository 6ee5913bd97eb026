"""
Synthetic TESS data generation.

The port's own copy of ``photometry_tpu/sim/simulator.py`` (counterpart of
reference simulation/simulateFITS.py:26-456), numpy on the port's own
``io.fits``, ``io.wcs``, ``catalog`` and ``core.timecorr``: the same seed
gives the same truth arrays and the same FFI, TPF and catalog bytes as the
JAX package's simulator.  It produces a fully self-consistent sector-CCD:

- a star catalog (with proper motions) laid out through a TAN WCS,
- an FFI time-series with analytic background (gradient + corner glow),
  pointing jitter, sinusoidal variables, Poisson+read noise,
- per-cadence quality flags,
- SPOC-layout FFI FITS files, Target Pixel Files and catalog SQLite,

while keeping the injected truth (per-star fluxes, per-frame offsets,
true background) available for assertions.
"""

from __future__ import annotations

import os
import dataclasses
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..io import fits as pf
from ..io.wcs import TanWCS
from ..quality import TESSQualityFlags
from ..utils.mathutils import integrated_gaussian, mag2flux

__all__ = ["SimConfig", "SimulatedSector", "simulate_sector"]

PIXEL_SCALE = 21.0  # arcsec/pixel


@dataclass
class SimConfig:
    sector: int = 1
    camera: int = 3
    ccd: int = 2
    shape: tuple = (128, 128)          #: (H, W) science pixels
    n_times: int = 48
    cadence: int = 1800                #: seconds
    n_stars: int = 40
    tmag_range: tuple = (4.0, 14.0)
    bkg_level: float = 100.0           #: e-/s sky level
    bkg_gradient: tuple = (0.15, -0.1)  #: relative gradient across frame
    glow_amp: float = 60.0             #: corner-glow amplitude, e-/s
    glow_scale: float = 0.35           #: corner-glow e-folding, frac of diag
    psf_sigma: float = 1.1             #: Gaussian PSF sigma, pixels
    jitter_amp: float = 0.08           #: pointing drift amplitude, pixels
    read_noise: float = 10.0           #: e- per readout
    exptime_eff: float = 1425.6        #: effective integration per FFI, s
    variable_fraction: float = 0.25
    variable_amp: float = 0.02
    data_rel: int = 99                 #: late DR so no time-offset fix applies
    noise: bool = True
    seed: int = 42
    tstart_btjd: float = 1325.29
    #: explicit star list ((row, col, tmag), ...); overrides random placement
    stars: Optional[tuple] = None


@dataclass
class SimulatedSector:
    """In-memory truth for one simulated sector-CCD."""

    config: SimConfig
    wcs: TanWCS
    time: np.ndarray                 #: (T,) BTJD mid-times
    cadenceno: np.ndarray            #: (T,)
    quality: np.ndarray              #: (T,) int32
    images: np.ndarray               #: (T, H, W) total flux incl. background
    uncert: np.ndarray               #: (T, H, W)
    bkg_true: np.ndarray             #: (T, H, W) injected background
    starid: np.ndarray               #: (N,)
    ra_j2000: np.ndarray
    dec_j2000: np.ndarray
    pm_ra: np.ndarray
    pm_dec: np.ndarray
    tmag: np.ndarray
    row_ref: np.ndarray              #: (N,) true row at reference time
    col_ref: np.ndarray
    flux_true: np.ndarray            #: (N, T) injected per-cadence flux
    jitter: np.ndarray               #: (T, 2) (drow, dcol) per frame
    header: dict = field(default_factory=dict)

    @property
    def mean_flux_true(self):
        return self.flux_true.mean(axis=1)

    def catalog_arrays(self) -> dict:
        return dict(starid=self.starid, ra_j2000=self.ra_j2000,
                    dec_j2000=self.dec_j2000, pm_ra=self.pm_ra,
                    pm_dec=self.pm_dec, tmag=self.tmag)

    # ------------------------------------------------------------------ files
    def write_catalog(self, directory: str, overwrite: bool = True) -> str:
        from ..catalog import make_catalog_from_arrays
        os.makedirs(directory, exist_ok=True)
        H, W = self.config.shape
        corners_x = np.array([1.0, 1.0, W, W])
        corners_y = np.array([1.0, H, H, 1.0])
        ra_c, dec_c = self.wcs.pixel_to_world(corners_x, corners_y)
        footprint = np.stack([ra_c, dec_c], axis=1)
        cam_ra, cam_dec = self.wcs.pixel_to_world(W / 2, H / 2)
        return make_catalog_from_arrays(
            directory, self.config.sector, self.config.camera, self.config.ccd,
            reference_time=self.header["REF_TIME"],
            footprint=footprint, camera_centre=(float(cam_ra[0]), float(cam_dec[0])),
            overwrite=overwrite, **self.catalog_arrays())

    def write_ffis(self, directory: str, raw_geometry: bool = False, gzip: bool = True) -> list:
        """Write per-cadence FFI FITS files in SPOC naming convention."""
        os.makedirs(directory, exist_ok=True)
        cfg = self.config
        paths = []
        wcs_hdr_cache = self.wcs.to_header(pf.Header())
        # Per-frame barycentric correction at the CCD centre (SPOC writes
        # BARYCORR per FFI; the mid-times here are barycentre-corrected, so
        # spacecraft time = TIME - BARYCORR):
        H, W = cfg.shape
        ra_c, dec_c = self.wcs.pixel_to_world(W / 2, H / 2)
        barycorr = _sim_time_corrector(self.time).barycentric_correction(
            self.time, float(ra_c[0]), float(dec_c[0]))
        for k in range(cfg.n_times):
            datestr = f"{2018206192942 + k:013d}"
            name = (f"tess{datestr}-s{cfg.sector:04d}-{cfg.camera:d}-{cfg.ccd:d}"
                    f"-0120-s_ffic.fits" + (".gz" if gzip else ""))
            path = os.path.join(directory, name)
            hdr = pf.Header()
            half_exp = cfg.cadence / 2.0 / 86400.0
            hdr.set("TELESCOP", "TESS" if raw_geometry else "SIMTESS")
            hdr.set("CAMERA", cfg.camera)
            hdr.set("CCD", cfg.ccd)
            hdr.set("SECTOR", cfg.sector)
            hdr.set("DATA_REL", cfg.data_rel)
            hdr.set("PROCVER", "photometry-tpu-sim")
            hdr.set("TSTART", float(self.time[k] - half_exp))
            hdr.set("TSTOP", float(self.time[k] + half_exp))
            hdr.set("EXPOSURE", cfg.exptime_eff / 86400.0)
            hdr.set("BARYCORR", float(barycorr[k]))
            hdr.set("FFIINDEX", int(self.cadenceno[k]))
            hdr.set("NUM_FRM", max(1, cfg.cadence // 2))
            hdr.set("CRBLKSZ", 10)
            hdr.set("GAIN", 5.2)
            hdr.set("READNOIS", cfg.read_noise)
            hdr.set("PSFSIGMA", float(cfg.psf_sigma))
            hdr.set("QUAL_BIT", int(self.quality[k]))
            # Raw-geometry files carry the WCS of the RAW pixel grid
            # (science column c sits at raw column c+44), exactly like
            # SPOC flight FFIs; read_ffi shifts it back at ingest.
            img_hdr = (self.wcs.shifted(dcol=-44) if raw_geometry
                       else self.wcs).to_header(pf.Header())
            img = self.images[k].astype(np.float32)
            err = self.uncert[k].astype(np.float32)
            if raw_geometry:
                full = np.zeros((2078, 2136), np.float32)
                full_err = np.zeros((2078, 2136), np.float32)
                H, W = img.shape
                full[0:H, 44:44 + W] = img
                full_err[0:H, 44:44 + W] = err
                img, err = full, full_err
            pf.write_fits(path, [
                pf.PrimaryHDU(None, header=hdr),
                pf.ImageHDU(img, header=img_hdr, name="CAL"),
                pf.ImageHDU(err, name="UNCERT")])
            paths.append(path)
        return paths

    def write_tpf(self, directory: str, starid: int, stamp=(11, 11),
                  cadence: int = 120, n_times: Optional[int] = None,
                  gzip: bool = True) -> str:
        """Write a SPOC-layout Target Pixel File for one simulated star.

        The TPF time series is generated at the requested cadence (finer than
        the FFI series), re-rendering the star field on the stamp.
        """
        os.makedirs(directory, exist_ok=True)
        cfg = self.config
        rng = np.random.default_rng(cfg.seed + int(starid))
        idx = int(np.where(self.starid == starid)[0][0])
        h, w = stamp
        r0 = int(np.round(self.row_ref[idx])) - h // 2
        c0 = int(np.round(self.col_ref[idx])) - w // 2
        r0 = np.clip(r0, 0, cfg.shape[0] - h)
        c0 = np.clip(c0, 0, cfg.shape[1] - w)
        if n_times is None:
            n_times = int(cfg.n_times * cfg.cadence // cadence)
            n_times = min(n_times, 1000)
        t = self.time[0] + (np.arange(n_times) + 0.5) * cadence / 86400.0

        # Per-cadence star positions with the same slow jitter drift model:
        drow, dcol = _jitter_series(t - t[0], cfg.jitter_amp, cfg.seed)
        yy, xx = np.mgrid[r0:r0 + h, c0:c0 + w]
        flux = np.zeros((n_times, h, w), np.float32)
        near = (np.abs(self.row_ref - (r0 + h / 2)) < h / 2 + 8) & \
               (np.abs(self.col_ref - (c0 + w / 2)) < w / 2 + 8)
        base = mag2flux(self.tmag)
        periods, phases, amps = _variability(self.starid, cfg, rng)
        # Vectorised over the time axis (a real fast TPF is ~118k cadences;
        # the per-cadence Python loop took minutes there), chunked so the
        # (chunk, h, w) erf temporaries stay tens of MB:
        chunk_t = 8192
        for j in np.where(near)[0]:
            for k0 in range(0, n_times, chunk_t):
                k1 = min(k0 + chunk_t, n_times)
                tk = t[k0:k1]
                fl = base[j] * (1 + amps[j] * np.sin(
                    2 * np.pi * (tk - t[0]) / periods[j] + phases[j]))
                flux[k0:k1] += integrated_gaussian(
                    xx[None], yy[None], fl[:, None, None],
                    (self.col_ref[j] + dcol[k0:k1])[:, None, None],
                    (self.row_ref[j] + drow[k0:k1])[:, None, None],
                    cfg.psf_sigma).astype(np.float32)
        bkg = np.full((n_times, h, w), cfg.bkg_level, np.float32)
        exptime = cadence * 0.8  # effective integration per cadence, seconds
        sigma = np.sqrt((flux + bkg) / exptime + (cfg.read_noise / exptime) ** 2).astype(np.float32)
        if cfg.noise:
            flux = flux + rng.standard_normal(flux.shape).astype(np.float32) * sigma

        quality = np.zeros(n_times, np.int32)
        cadno = np.arange(100000, 100000 + n_times, dtype=np.int32)

        prim = pf.Header()
        prim.set("TELESCOP", "TESS")
        prim.set("TICID", int(starid))
        prim.set("OBJECT", f"TIC {starid}")
        prim.set("SECTOR", cfg.sector)
        prim.set("CAMERA", cfg.camera)
        prim.set("CCD", cfg.ccd)
        prim.set("DATA_REL", cfg.data_rel)
        prim.set("PROCVER", "photometry-tpu-sim")

        pix_hdr = pf.Header()
        pix_hdr.set("TIMEDEL", cadence / 86400.0)
        pix_hdr.set("READNOIA", cfg.read_noise)
        pix_hdr.set("GAINA", 5.2)
        pix_hdr.set("NUM_FRM", max(1, cadence // 2))
        pix_hdr.set("NREADOUT", max(1, int(cadence // 2 * 0.8)))
        # Per-cadence barycentric correction at the target position (SPOC
        # TPFs carry TIMECORR; TIME is barycentre-corrected):
        ra_t, dec_t = self.wcs.pixel_to_world(self.col_ref[idx] + 1,
                                              self.row_ref[idx] + 1)
        timecorr = _sim_time_corrector(t).barycentric_correction(
            t, float(np.atleast_1d(ra_t)[0]), float(np.atleast_1d(dec_t)[0]))
        cols = {
            "TIME": t.astype(np.float64),
            "TIMECORR": timecorr.astype(np.float32),
            "CADENCENO": cadno,
            "FLUX": flux,
            "FLUX_ERR": sigma,
            "FLUX_BKG": bkg,
            "QUALITY": quality,
            "POS_CORR1": dcol.astype(np.float32),
            "POS_CORR2": drow.astype(np.float32),
        }
        ap_hdr = self.wcs.to_header(pf.Header())
        # Shift CRPIX into stamp coordinates (stamp corner at 0-based r0,c0):
        ap_hdr.set("CRPIX1", float(self.wcs.crpix[0]) - c0)
        ap_hdr.set("CRPIX2", float(self.wcs.crpix[1]) - r0)
        ap_hdr.set("CRVAL1P", c0 + 1)
        ap_hdr.set("CRVAL2P", r0 + 1)
        aperture = np.full((h, w), 1, np.int32)

        fast = "fast-" if cadence == 20 else ""
        name = f"tess2018206045859-s{cfg.sector:04d}-{int(starid):016d}-0120-s_{fast}tp.fits" + (".gz" if gzip else "")
        path = os.path.join(directory, name)
        pf.write_fits(path, [
            pf.PrimaryHDU(None, header=prim),
            pf.BinTableHDU(cols, header=pix_hdr, name="PIXELS"),
            pf.ImageHDU(aperture, header=ap_hdr, name="APERTURE")])
        return path


def _sim_time_corrector(time_btjd: np.ndarray):
    """Synthetic-ephemeris TimeCorrector covering the sim time span.

    Same analytic family as the download-cache ephemeris
    (core.timecorr.SpacecraftEphemeris.synthetic), so the per-target
    barycentric recomputation in production (BasePhotometry.py:443-453
    counterpart) is differentially consistent with the simulated headers.
    """
    from ..core.timecorr import SpacecraftEphemeris, TimeCorrector
    jd0 = 2457000.0 + float(np.min(time_btjd)) - 5.0
    jd1 = 2457000.0 + float(np.max(time_btjd)) + 5.0
    return TimeCorrector(SpacecraftEphemeris.synthetic(jd0, jd1))


def _jitter_series(dt_days: np.ndarray, amp: float, seed: int):
    """Smooth pseudo-random pointing drift (sum of slow sinusoids)."""
    rng = np.random.default_rng(seed + 777)
    ph = rng.uniform(0, 2 * np.pi, 4)
    drow = amp * (np.sin(2 * np.pi * dt_days / 2.5 + ph[0]) + 0.4 * np.sin(2 * np.pi * dt_days / 0.3 + ph[1]))
    dcol = amp * (np.cos(2 * np.pi * dt_days / 3.1 + ph[2]) + 0.4 * np.sin(2 * np.pi * dt_days / 0.45 + ph[3]))
    return drow, dcol


def _variability(starids, cfg: SimConfig, rng):
    """Deterministic per-star variability parameters."""
    n = len(starids)
    r = np.random.default_rng(cfg.seed + 1234)
    is_var = r.uniform(size=n) < cfg.variable_fraction
    periods = r.uniform(0.5, 5.0, n)
    phases = r.uniform(0, 2 * np.pi, n)
    amps = np.where(is_var, cfg.variable_amp, 0.0)
    return periods, phases, amps


def simulate_sector(cfg: Optional[SimConfig] = None, **kw) -> SimulatedSector:
    """Generate a fully self-consistent simulated sector-CCD."""
    if cfg is None:
        cfg = SimConfig(**kw)
    rng = np.random.default_rng(cfg.seed)
    H, W = cfg.shape
    T = cfg.n_times

    # --- WCS for this CCD: tangent point at CCD centre --------------------
    scale = PIXEL_SCALE / 3600.0
    th = np.deg2rad(8.0 + 5 * cfg.camera + cfg.ccd)
    cd = scale * np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    crval = np.array([(37.0 * cfg.camera + 11 * cfg.ccd) % 360.0, -35.0 + 3 * cfg.ccd])
    wcs = TanWCS(crpix=np.array([W / 2 + 0.5, H / 2 + 0.5]), crval=crval, cd=cd)

    # --- time series -------------------------------------------------------
    time = cfg.tstart_btjd + (np.arange(T) + 0.5) * cfg.cadence / 86400.0
    cadenceno = np.arange(4697, 4697 + T, dtype=np.int32)
    quality = np.zeros(T, np.int32)
    if T >= 12:
        quality[T // 4] = TESSQualityFlags.Desat
        quality[T // 2] = TESSQualityFlags.CoarsePoint
    from ..io.settings import sector_info
    try:
        ref_time = sector_info(cfg.sector).reference_time
    except KeyError:
        ref_time = 2457000.0 + time[T // 2]

    # --- star field ---------------------------------------------------------
    if cfg.stars is not None:
        # Explicit star list ((row, col, tmag), ...) for stress/truth tests.
        arr = np.asarray(cfg.stars, np.float64).reshape(-1, 3)
        order = np.argsort(arr[:, 2])  # brightest first, stable target ids
        arr = arr[order]
        row_ref, col_ref, tmag = arr[:, 0].copy(), arr[:, 1].copy(), arr[:, 2].copy()
        cfg = dataclasses.replace(cfg, n_stars=len(arr))
    else:
        margin = 4.0
        row_ref = rng.uniform(margin, H - margin, cfg.n_stars)
        col_ref = rng.uniform(margin, W - margin, cfg.n_stars)
        tmag = rng.uniform(*cfg.tmag_range, cfg.n_stars)
        tmag.sort()  # brightest first, stable target ids
    starid = np.arange(100000001, 100000001 + cfg.n_stars, dtype=np.int64)
    pm_ra = rng.normal(0, 20, cfg.n_stars)     # mas/yr
    pm_dec = rng.normal(0, 20, cfg.n_stars)

    # Sky positions at reference time from the WCS; J2000 by inverse PM:
    ra_ref, dec_ref = wcs.radec_of_rowcol(row_ref, col_ref)
    years = (ref_time - 2451544.5) / 365.25  # years since J2000
    dec_rate = pm_dec / 3.6e6
    dec_j2000 = dec_ref - years * dec_rate
    ra_rate = pm_ra / np.cos(np.deg2rad(dec_ref - years * dec_rate / 2.0)) / 3.6e6
    ra_j2000 = ra_ref - years * ra_rate

    # --- background truth ----------------------------------------------------
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    gx, gy = cfg.bkg_gradient
    bkg0 = cfg.bkg_level * (1.0 + gx * (xx / W - 0.5) + gy * (yy / H - 0.5))
    # Place the glow at the frame corner farthest from the camera centre —
    # the corner where the real TESS glow sits (reference backgrounds.py
    # models it as radial beyond 2400 px from the camera centre), so the
    # simulated geometry is self-consistent with the production background
    # model's small-frame corner-ring fallback.
    from ..ops.background import radial_coordinates
    rim = radial_coordinates((H, W), cfg.camera, cfg.ccd)
    corner_r = {(0, 0): rim[0, 0], (0, W - 1): rim[0, -1],
                (H - 1, 0): rim[-1, 0], (H - 1, W - 1): rim[-1, -1]}
    cy, cx = max(corner_r, key=corner_r.get)
    r_corner = np.hypot(xx - cx, yy - cy) / np.hypot(H, W)
    glow = cfg.glow_amp * np.exp(-r_corner / cfg.glow_scale)
    # slow multiplicative time variation of the sky:
    tfac = 1.0 + 0.05 * np.sin(2 * np.pi * (time - time[0]) / 6.0)
    bkg_true = (bkg0 + glow)[None, :, :] * tfac[:, None, None]

    # --- stellar signal -------------------------------------------------------
    drow, dcol = _jitter_series(time - time[0], cfg.jitter_amp, cfg.seed)
    base_flux = mag2flux(tmag)
    periods, phases, amps = _variability(starid, cfg, rng)
    flux_true = base_flux[:, None] * (1 + amps[:, None] * np.sin(
        2 * np.pi * (time[None, :] - time[0]) / periods[:, None] + phases[:, None]))

    images = np.empty((T, H, W), np.float32)
    win = int(np.ceil(6 * cfg.psf_sigma))
    for k in range(T):
        frame = bkg_true[k].copy()
        for j in range(cfg.n_stars):
            r = row_ref[j] + drow[k]
            c = col_ref[j] + dcol[k]
            r_lo, r_hi = max(0, int(r) - win), min(H, int(r) + win + 1)
            c_lo, c_hi = max(0, int(c) - win), min(W, int(c) + win + 1)
            if r_lo >= r_hi or c_lo >= c_hi:
                continue
            sub_y, sub_x = np.mgrid[r_lo:r_hi, c_lo:c_hi]
            frame[r_lo:r_hi, c_lo:c_hi] += integrated_gaussian(
                sub_x, sub_y, flux_true[j, k], c, r, cfg.psf_sigma)
        images[k] = frame

    # --- noise ------------------------------------------------------------------
    sigma = np.sqrt(images / cfg.exptime_eff
                    + (cfg.read_noise / cfg.exptime_eff) ** 2).astype(np.float32)
    if cfg.noise:
        images = images + rng.standard_normal(images.shape).astype(np.float32) * sigma

    header = {
        "SECTOR": cfg.sector, "CAMERA": cfg.camera, "CCD": cfg.ccd,
        "DATA_REL": cfg.data_rel, "PROCVER": "photometry-tpu-sim",
        "CADENCE": cfg.cadence, "REF_TIME": ref_time,
        "READNOIS": cfg.read_noise, "GAIN": 5.2,
        "NUM_FRM": max(1, cfg.cadence // 2),
    }
    return SimulatedSector(
        config=cfg, wcs=wcs, time=time, cadenceno=cadenceno, quality=quality,
        images=images, uncert=sigma, bkg_true=bkg_true.astype(np.float32),
        starid=starid, ra_j2000=ra_j2000, dec_j2000=dec_j2000,
        pm_ra=pm_ra, pm_dec=pm_dec, tmag=tmag, row_ref=row_ref, col_ref=col_ref,
        flux_true=flux_true, jitter=np.stack([drow, dcol], axis=1), header=header)
