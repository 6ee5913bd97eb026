"""
Readers for TESS pixel products: calibrated FFIs and Target Pixel Files.

The port's own copy of ``photometry_tpu/io/tess.py``, the counterpart of
reference photometry/io.py:25-93 (FFIImage) and the TPF loading in
BasePhotometry.py:307-384, built on the port's own FITS and WCS modules.  Array-first: readers return plain numpy arrays + plain
dict-like headers so the prepare stage can stack frames straight into device
cubes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .fits import read_fits, Header
from .wcs import TanWCS

__all__ = ["FFIFrame", "read_ffi", "TargetPixelFile", "read_tpf"]

#: Science-area crop of raw TESS FFIs: rows 0:2048, columns 44:2092.
TESS_RAW_SHAPE = (2078, 2136)
SCIENCE_ROWS = slice(0, 2048)
SCIENCE_COLS = slice(44, 2092)
SMEAR_ROWS = slice(2058, 2068)
VSMEAR_ROWS = slice(2068, None)


@dataclass
class FFIFrame:
    """One calibrated full-frame image (science area)."""

    data: np.ndarray                      #: (H, W) flux in e-/s
    uncertainty: Optional[np.ndarray]     #: (H, W) 1-sigma errors, or None
    header: dict                          #: merged primary+image headers
    wcs: Optional[TanWCS] = None
    is_tess: bool = False                 #: True when cropped from raw geometry
    smear: Optional[np.ndarray] = None    #: (10, W) smear rows (raw TESS only)
    vsmear: Optional[np.ndarray] = None   #: virtual smear rows (raw TESS only)

    @property
    def mask(self) -> np.ndarray:
        """True where data is non-finite."""
        return ~np.isfinite(self.data)

    @property
    def cadenceno(self) -> int:
        return int(self.header["FFIINDEX"])

    @property
    def mid_time(self) -> float:
        """Mid-exposure timestamp (TJD, uncorrected spacecraft time + BARYCORR)."""
        return 0.5 * (float(self.header["TSTART"]) + float(self.header["TSTOP"]))


def _synthesize_ffiindex(hdr: dict) -> int:
    """Synthesize the FFIINDEX cadence number for sectors < 6.

    Uses the public anchor (cadence 4697 at the first sector-1 FFI timestamp)
    communicated by the SPOC team; counterpart of photometry/io.py:55-67.
    """
    time = 0.5 * (hdr["TSTART"] + hdr["TSTOP"])
    timecorr = hdr.get("BARYCORR", 0)
    first_time = 0.5 * (1325.317007851970 + 1325.337841177751) - 3.9072474e-03
    first_cadenceno = 4697
    timedelt = 1800 / 86400
    offset = first_cadenceno - first_time / timedelt
    return int(np.round((time - timecorr) / timedelt + offset))


def read_ffi(path) -> FFIFrame:
    """Read a calibrated TESS FFI (or a plain 2-extension image file).

    Real SPOC FFIs (raw geometry 2078x2136) are cropped to the 2048x2048
    science area with smear rows extracted; files already containing only a
    science-area image (e.g. simulator output) pass through unchanged.
    """
    if isinstance(path, np.ndarray):
        return FFIFrame(data=np.asarray(path, np.float32), uncertainty=None, header={})

    hdus = read_fits(path)
    hdr = dict(hdus[0].header.items())
    img_hdu = hdus[1] if len(hdus) > 1 and hdus[1].data is not None else hdus[0]
    wcs = TanWCS.from_header(img_hdu.header) if "CRPIX1" in img_hdu.header else None

    raw = img_hdu.data
    is_tess = (hdr.get("TELESCOP") == "TESS" and raw is not None
               and raw.shape == TESS_RAW_SHAPE)
    smear = vsmear = None
    if is_tess:
        # The SPOC header's WCS lives on the RAW 2078x2136 grid (science
        # pixels start at column 44); shift it onto the cropped science
        # grid so every downstream consumer (catalog masks, the engine's
        # target_position, stored cube WCS) works in science coordinates.
        # The reference keeps the raw WCS and instead subtracts
        # PIXEL_OFFSET_COLUMN at every data access
        # (BasePhotometry.py:857-860); here the offset is applied ONCE at
        # ingest and PIXEL_OFFSET_COLUMN is only used to label raw-CCD
        # column output (engine.aperture_image).
        if wcs is not None:
            wcs = wcs.shifted(drow=SCIENCE_ROWS.start or 0,
                              dcol=SCIENCE_COLS.start)
        data = np.asarray(raw[SCIENCE_ROWS, SCIENCE_COLS], dtype=np.float32)
        uncert = None
        if len(hdus) > 2 and hdus[2].data is not None:
            uncert = np.asarray(hdus[2].data[SCIENCE_ROWS, SCIENCE_COLS], dtype=np.float32)
        smear = np.asarray(raw[SMEAR_ROWS, SCIENCE_COLS], dtype=np.float32)
        vsmear = np.asarray(raw[VSMEAR_ROWS, SCIENCE_COLS], dtype=np.float32)
        hdr.update(dict(img_hdu.header.items()))
        if "FFIINDEX" not in hdr and hdr.get("EXPOSURE", 0) * 86400 > 1000:
            hdr["FFIINDEX"] = _synthesize_ffiindex(hdr)
    else:
        if img_hdu is hdus[0]:
            data = np.asarray(hdus[0].data, dtype=np.float32)
            uncert = np.asarray(hdus[1].data, dtype=np.float32) if len(hdus) > 1 and hdus[1].data is not None else None
        else:
            hdr.update(dict(img_hdu.header.items()))
            data = np.asarray(img_hdu.data, dtype=np.float32)
            uncert = np.asarray(hdus[2].data, dtype=np.float32) if len(hdus) > 2 and hdus[2].data is not None else None

    return FFIFrame(data=data, uncertainty=uncert, header=hdr, wcs=wcs,
                    is_tess=is_tess, smear=smear, vsmear=vsmear)


@dataclass
class TargetPixelFile:
    """A TESS Target Pixel File: per-cadence postage stamps for one target.

    Mirrors the fields BasePhotometry consumes from SPOC TPFs
    (reference photometry/BasePhotometry.py:326-384).
    """

    starid: int
    sector: int
    camera: int
    ccd: int
    data_rel: int
    cadence: int                      #: seconds (20 or 120)
    time: np.ndarray                  #: (T,) BTJD mid-times
    timecorr: np.ndarray              #: (T,) barycentric correction (days)
    cadenceno: np.ndarray             #: (T,) int32
    quality: np.ndarray               #: (T,) int32
    flux: np.ndarray                  #: (T, h, w) calibrated flux, e-/s
    flux_err: np.ndarray              #: (T, h, w)
    flux_bkg: Optional[np.ndarray]    #: (T, h, w) background, or None
    pos_corr: Optional[np.ndarray]    #: (T, 2) pointing jitter, pixels
    wcs: Optional[TanWCS]             #: WCS of the aperture stamp
    corner_row: int                   #: 0-based CCD row of stamp corner
    corner_col: int                   #: 0-based CCD column of stamp corner
    aperture: Optional[np.ndarray]    #: SPOC aperture bitmap
    header: dict
    pixels_header: dict = field(default_factory=dict)

    @property
    def shape(self):
        return self.flux.shape[1:]

    @property
    def readnoise(self) -> float:
        return float(self.pixels_header.get("READNOIA", 10))

    @property
    def gain(self) -> float:
        return float(self.pixels_header.get("GAINA", 100))

    @property
    def num_frm(self) -> int:
        return int(self.pixels_header.get("NUM_FRM", 60))

    @property
    def n_readout(self) -> int:
        return int(self.pixels_header.get("NREADOUT", 48))


def read_tpf(path) -> TargetPixelFile:
    """Read a TESS Target Pixel File (SPOC layout: PIXELS + APERTURE HDUs)."""
    hdus = read_fits(path)
    by_name = {h.name: h for h in hdus}
    prim = hdus[0].header
    pixels = by_name.get("PIXELS", hdus[1])
    aperture = by_name.get("APERTURE", hdus[2] if len(hdus) > 2 else None)

    tab = pixels.data
    # Drop cadences with undefined timestamps (seen in sector-1 files):
    good = np.isfinite(tab["TIME"])
    every = bool(good.all())
    def col(name, default=None):
        if name in tab:
            return np.asarray(tab[name]) if every else np.asarray(tab[name])[good]
        return default

    ap_hdr = aperture.header if aperture is not None else Header()
    corner_col = int(ap_hdr.get("CRVAL1P", 1)) - 1
    corner_row = int(ap_hdr.get("CRVAL2P", 1)) - 1
    wcs = TanWCS.from_header(ap_hdr) if "CRPIX1" in ap_hdr else None

    timedel = pixels.header.get("TIMEDEL")
    cadence = int(np.round(float(timedel) * 86400)) if timedel else 120

    flux = col("FLUX")
    return TargetPixelFile(
        starid=int(prim.get("TICID", 0)),
        sector=int(prim["SECTOR"]),
        camera=int(prim["CAMERA"]),
        ccd=int(prim["CCD"]),
        data_rel=int(prim.get("DATA_REL", 99)),
        cadence=cadence,
        time=np.asarray(col("TIME"), np.float64),
        timecorr=np.asarray(col("TIMECORR", np.zeros(flux.shape[0], np.float32)), np.float32),
        cadenceno=np.asarray(col("CADENCENO", np.arange(flux.shape[0])), np.int32),
        quality=np.asarray(col("QUALITY", np.zeros(flux.shape[0])), np.int32),
        flux=np.asarray(flux, np.float32),
        flux_err=np.asarray(col("FLUX_ERR"), np.float32),
        flux_bkg=None if col("FLUX_BKG") is None else np.asarray(col("FLUX_BKG"), np.float32),
        pos_corr=None if col("POS_CORR1") is None else np.stack(
            [np.asarray(col("POS_CORR1"), np.float32), np.asarray(col("POS_CORR2"), np.float32)], axis=1),
        wcs=wcs,
        corner_row=corner_row,
        corner_col=corner_col,
        aperture=None if aperture is None else aperture.data,
        header=dict(prim.items()),
        pixels_header=dict(pixels.header.items()),
    )
