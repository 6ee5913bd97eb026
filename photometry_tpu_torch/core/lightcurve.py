"""
Light-curve FITS products.

Behavioral counterpart of reference BasePhotometry.save_lightcurve
(BasePhotometry.py:1417-1728): the same file naming
(``tess{starid:011d}-s{sector:03d}-{camera}-{ccd}-c{cadence:04d}-dr{dr:02d}-v{v:02d}-tasoc_lc.fits.gz``),
the same 14-column LIGHTCURVE bintable, SUMIMAGE + APERTURE image HDUs with
stamp WCS, and the optional halo WEIGHTMAP table — written with this
package's own FITS writer.

The port's own copy of ``photometry_tpu/core/lightcurve.py``: the same
headers, columns and ``PROCVER`` string, so both packages write the same
product for the same light curve.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np

from ..io import fits as pf
from ..quality import CorrectorQualityFlags

__all__ = ["save_lightcurve", "lightcurve_filename"]

#: Pipeline version stamped into PROCVER (that of photometry_tpu/version.py).
__version__ = "0.1.0"


def lightcurve_filename(starid, sector, camera, ccd, cadence, data_rel, version) -> str:
    return ("tess{starid:011d}-s{sector:03d}-{camera:d}-{ccd:d}-c{cadence:04d}"
            "-dr{datarel:02d}-v{version:02d}-tasoc_lc.fits.gz").format(
        starid=starid, sector=sector, camera=camera, ccd=ccd,
        cadence=cadence, datarel=data_rel, version=version)


def save_lightcurve(result, output_folder: str, version: int,
                    sumimage: np.ndarray, stamp_wcs=None,
                    halo_weightmap: Optional[dict] = None) -> str:
    """Write one target's light curve to a gzipped FITS file.

    Parameters:
        result: a ``TargetResult`` (core.engine) carrying the light curve,
            mask, aperture image, target info and headers.
        output_folder: directory for the file (created if needed).
        version: processing version for header + filename.
        sumimage: (h, w) stamp sum-image for the SUMIMAGE HDU.
        stamp_wcs: TanWCS of the stamp (CRPIX shifted), or None.
        halo_weightmap: optional halo weightmap dict with keys
            initial_cadence, final_cadence, sat_pixels, weightmap.

    Returns the file path.
    """
    os.makedirs(output_folder, exist_ok=True)
    lc = result.lightcurve
    tgt = result.target
    now = datetime.datetime.now()

    # Propagate BackgroundShenanigans from pixel flags into CorrectorQuality:
    quality = np.zeros(len(lc["time"]), np.int32)
    pixel_shenanigans = lc.get("shenanigans_any")
    if pixel_shenanigans is not None:
        quality |= np.where(pixel_shenanigans,
                            CorrectorQualityFlags.BackgroundShenanigans, 0).astype(np.int32)

    # Drop undefined timestamps (sector-1 alert data problem):
    indx = np.isfinite(lc["time"])

    prim_hdr = pf.Header()
    prim_hdr.set("NEXTEND", 3 + int(halo_weightmap is not None), "number of standard extensions")
    prim_hdr.set("ORIGIN", "photometry-tpu", "institution responsible for creating this file")
    prim_hdr.set("DATE", now.strftime("%Y-%m-%d"), "date the file was created")
    prim_hdr.set("TELESCOP", "TESS", "telescope")
    prim_hdr.set("INSTRUME", "TESS Photometer", "detector type")
    prim_hdr.set("FILTER", "TESS", "Photometric bandpass filter")
    prim_hdr.set("OBJECT", f"TIC {result.starid:d}", "string version of TICID")
    prim_hdr.set("TICID", result.starid, "unique TESS target identifier")
    prim_hdr.set("CAMERA", result.camera, "Camera number")
    prim_hdr.set("CCD", result.ccd, "CCD number")
    prim_hdr.set("SECTOR", result.sector, "Observing sector")
    prim_hdr.set("PROCVER", __version__, "Version of photometry pipeline")
    prim_hdr.set("FILEVER", "1.5", "File format version")
    prim_hdr.set("DATA_REL", result.data_rel, "Data release number")
    prim_hdr.set("VERSION", version, "Version of the processing")
    prim_hdr.set("PHOTMET", result.method, "Photometric method used")
    prim_hdr.set("RADESYS", "ICRS", "reference frame of celestial coordinates")
    prim_hdr.set("EQUINOX", 2000.0, "equinox of celestial coordinate system")
    prim_hdr.set("RA_OBJ", tgt.get("ra_J2000", 0.0), "[deg] Right ascension")
    prim_hdr.set("DEC_OBJ", tgt.get("decl_J2000", 0.0), "[deg] Declination")
    pm_ra = tgt.get("pm_ra")
    pm_dec = tgt.get("pm_decl")
    prim_hdr.set("PMRA", pm_ra if pm_ra else np.nan, "[mas/yr] RA proper motion")
    prim_hdr.set("PMDEC", pm_dec if pm_dec else np.nan, "[mas/yr] Dec proper motion")
    prim_hdr.set("PMTOTAL", float(np.hypot(pm_ra, pm_dec)) if pm_ra is not None and pm_dec is not None else np.nan,
                 "[mas/yr] total proper motion")
    prim_hdr.set("TESSMAG", tgt.get("tmag", np.nan), "[mag] TESS magnitude")
    prim_hdr.set("TEFF", tgt.get("teff") or np.nan, "[K] Effective temperature")
    prim_hdr.set("TICVER", result.ticver, "TESS Input Catalog version")
    for key, val in (result.additional_headers or {}).items():
        if isinstance(val, tuple):
            prim_hdr.set(key, val[0], val[1])
        else:
            prim_hdr.set(key, val)
    prim_hdr.set("DATAVAL", 0, "Data validation flags")

    cols = {
        "TIME": np.asarray(lc["time"], np.float64)[indx],
        "TIMECORR": np.asarray(lc["timecorr"], np.float32)[indx],
        "CADENCENO": np.asarray(lc["cadenceno"], np.int32)[indx],
        "FLUX_RAW": np.asarray(lc["flux"], np.float64)[indx],
        "FLUX_RAW_ERR": np.asarray(lc["flux_err"], np.float64)[indx],
        "FLUX_BKG": np.asarray(lc["flux_background"], np.float64)[indx],
        "FLUX_CORR": np.full(int(indx.sum()), np.nan),
        "FLUX_CORR_ERR": np.full(int(indx.sum()), np.nan),
        "QUALITY": quality[indx],
        "PIXEL_QUALITY": np.asarray(lc["quality"], np.int32)[indx],
        "MOM_CENTR1": np.asarray(lc["pos_centroid"], np.float64)[indx, 0],
        "MOM_CENTR2": np.asarray(lc["pos_centroid"], np.float64)[indx, 1],
        "POS_CORR1": np.asarray(lc["pos_corr"], np.float64)[indx, 0],
        "POS_CORR2": np.asarray(lc["pos_corr"], np.float64)[indx, 1],
    }
    tb_hdr = pf.Header()
    t = cols["TIME"]
    tdel = result.cadence / 86400
    tb_hdr.set("INHERIT", True, "inherit the primary header")
    tb_hdr.set("TIMEREF", "SOLARSYSTEM", "barycentric correction applied to times")
    tb_hdr.set("TIMESYS", "TDB", "time system is Barycentric Dynamical Time (TDB)")
    tb_hdr.set("BJDREFI", 2457000, "integer part of BTJD reference date")
    tb_hdr.set("BJDREFF", 0.0, "fraction of the day in BTJD reference date")
    tb_hdr.set("TIMEUNIT", "d", "time unit for TIME, TSTART and TSTOP")
    if len(t):
        tb_hdr.set("TSTART", float(t[0] - tdel / 2), "observation start time in BTJD")
        tb_hdr.set("TSTOP", float(t[-1] + tdel / 2), "observation stop time in BTJD")
        tb_hdr.set("TELAPSE", float(t[-1] - t[0] + tdel), "[d] TSTOP - TSTART")
    tb_hdr.set("TIMEPIXR", 0.5, "bin time beginning=0 middle=0.5 end=1")
    tb_hdr.set("TIMEDEL", tdel, "[d] time resolution of data")
    tb_hdr.set("NUM_FRM", result.num_frm, "number of frames per time stamp")
    tb_hdr.set("NREADOUT", result.n_readout, "number of read per cadence")

    # Aperture image: bit 1 = collected, 2 = phot mask, 4 = used for bkg,
    # 8 = position mask (same encoding as the reference aperture property):
    aperture = result.aperture_image.astype(np.int32)

    img_hdr = pf.Header()
    img_hdr.set("INHERIT", True, "inherit the primary header")
    if stamp_wcs is not None:
        stamp_wcs.to_header(img_hdr)

    hdus = [
        pf.PrimaryHDU(None, header=prim_hdr),
        pf.BinTableHDU(cols, header=tb_hdr, name="LIGHTCURVE"),
        pf.ImageHDU(np.asarray(sumimage, np.float64), header=img_hdr.copy(), name="SUMIMAGE"),
        pf.ImageHDU(aperture, header=img_hdr.copy(), name="APERTURE"),
    ]
    if halo_weightmap is not None:
        wm_cols = {
            "CADENCENO1": np.asarray(halo_weightmap["initial_cadence"], np.int32),
            "CADENCENO2": np.asarray(halo_weightmap["final_cadence"], np.int32),
            "SAT_PIXELS": np.asarray(halo_weightmap["sat_pixels"], np.int32),
            "WEIGHTMAP": np.asarray(halo_weightmap["weightmap"], np.float32),
        }
        hdus.append(pf.BinTableHDU(wm_cols, header=img_hdr.copy(), name="WEIGHTMAP"))

    filename = lightcurve_filename(result.starid, result.sector, result.camera,
                                   result.ccd, result.cadence, result.data_rel, version)
    filepath = os.path.join(output_folder, filename)
    # Deflate effort is the hot host cost of the production drain (~85% of
    # a level-9 save); level 2 writes <2% larger files ~8x faster:
    from ..io.settings import load_settings
    level = load_settings().getint("products", "gzip_level", fallback=2)
    pf.write_fits(filepath, hdus, gzip_level=level)
    return filepath
