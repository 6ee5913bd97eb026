"""
Star catalogs: per-(sector, camera, ccd) SQLite files.

Behavioral counterpart of reference photometry/catalog.py: the same
``settings`` + ``catalog`` schema (catalog.py:179-202) and the same
footprint-query semantics with pole and RA=0 wraparound handling
(catalog.py:22-106).  The TASOC-internal PostgreSQL source
(photometry/tasoc_db.py) is replaced by :func:`make_catalog_from_arrays`,
which builds a catalog from plain arrays — fed by the simulator in tests and
by any external TIC extract in production.

The port's own copy of ``photometry_tpu/catalog.py``, file-compatible
with the JAX package's: catalogs come from :func:`make_catalog` on a local
TIC extract, from the simulator, or prebuilt from a configured URL through
:func:`download_catalogs`.  Reads return columnar numpy arrays.
"""

from __future__ import annotations

import contextlib
import logging
import os
import sqlite3
from dataclasses import dataclass
from typing import Optional

import numpy as np

from .io.settings import load_settings
from .utils.downloads import download_file
from .utils.mathutils import add_proper_motion

logger = logging.getLogger(__name__)

__all__ = ["StarCatalog", "make_catalog", "make_catalog_from_arrays", "catalog_filename",
           "query_footprint", "download_catalogs"]


def catalog_filename(sector: int, camera: int, ccd: int) -> str:
    return f"catalog_sector{sector:03d}_camera{camera:d}_ccd{ccd:d}.sqlite"


def _footprint_to_text(footprint: np.ndarray) -> str:
    return "(" + ",".join("(%.16f,%.16f)" % tuple(p) for p in footprint) + ")"


def _footprint_from_text(s: str) -> np.ndarray:
    a = s[2:-2].split("),(")
    return np.array([b.split(",") for b in a], dtype="float64")


def make_catalog_from_arrays(
        path_or_dir: str, sector: int, camera: int, ccd: int, *,
        starid, ra_j2000, dec_j2000, pm_ra, pm_dec, tmag, teff=None,
        reference_time: Optional[float] = None, epoch: float = 2000.0,
        footprint: Optional[np.ndarray] = None,
        camera_centre=(0.0, 0.0), coord_buffer: float = 0.2,
        ticver: str = "sim", overwrite: bool = False) -> str:
    """Create a catalog SQLite from columnar star data.

    Proper motions are applied to propagate J2000 coordinates to the sector
    ``reference_time`` (counterpart of reference catalog.py:288-298).

    Returns the path of the created file.
    """
    from .io.settings import sector_info
    if reference_time is None:
        reference_time = sector_info(sector).reference_time
    path = path_or_dir
    if os.path.isdir(path_or_dir):
        path = os.path.join(path_or_dir, catalog_filename(sector, camera, ccd))
    if os.path.exists(path):
        if not overwrite:
            return path
        os.remove(path)

    starid = np.asarray(starid, np.int64)
    ra_j2000 = np.asarray(ra_j2000, np.float64)
    dec_j2000 = np.asarray(dec_j2000, np.float64)
    pm_ra = np.asarray(pm_ra, np.float64)
    pm_dec = np.asarray(pm_dec, np.float64)
    tmag = np.asarray(tmag, np.float64)
    teff = np.full(len(starid), np.nan) if teff is None else np.asarray(teff, np.float64)

    ra_now, dec_now = add_proper_motion(ra_j2000, dec_j2000, pm_ra, pm_dec, reference_time,
                                        epoch)

    if footprint is None:
        footprint = np.array([
            [np.min(ra_now), np.min(dec_now)],
            [np.min(ra_now), np.max(dec_now)],
            [np.max(ra_now), np.max(dec_now)],
            [np.max(ra_now), np.min(dec_now)]])

    with contextlib.closing(sqlite3.connect(path)) as conn:
        cur = conn.cursor()
        cur.execute("PRAGMA page_size=4096;")
        cur.execute("""CREATE TABLE settings (
            sector INTEGER NOT NULL,
            camera INTEGER NOT NULL,
            ccd INTEGER NOT NULL,
            ticver TEXT NOT NULL,
            reference_time DOUBLE PRECISION NOT NULL,
            epoch DOUBLE PRECISION NOT NULL,
            coord_buffer DOUBLE PRECISION NOT NULL,
            camera_centre_ra DOUBLE PRECISION NOT NULL,
            camera_centre_dec DOUBLE PRECISION NOT NULL,
            footprint TEXT NOT NULL
        );""")
        cur.execute("""CREATE TABLE catalog (
            starid INTEGER PRIMARY KEY NOT NULL,
            ra DOUBLE PRECISION NOT NULL,
            decl DOUBLE PRECISION NOT NULL,
            ra_J2000 DOUBLE PRECISION NOT NULL,
            decl_J2000 DOUBLE PRECISION NOT NULL,
            pm_ra REAL,
            pm_decl REAL,
            tmag REAL NOT NULL,
            teff REAL
        );""")
        cur.execute("INSERT INTO settings VALUES (?,?,?,?,?,?,?,?,?,?);", (
            sector, camera, ccd, ticver, reference_time, epoch, coord_buffer,
            float(camera_centre[0]), float(camera_centre[1]),
            _footprint_to_text(footprint)))
        cur.executemany("INSERT INTO catalog VALUES (?,?,?,?,?,?,?,?,?);", [
            (int(starid[i]), float(ra_now[i]), float(dec_now[i]),
             float(ra_j2000[i]), float(dec_j2000[i]), float(pm_ra[i]),
             float(pm_dec[i]), float(tmag[i]),
             None if np.isnan(teff[i]) else float(teff[i]))
            for i in range(len(starid))])
        cur.execute("CREATE INDEX catalog_ra_dec_idx ON catalog (ra, decl);")
        cur.execute("CREATE INDEX catalog_tmag_idx ON catalog (tmag);")
        conn.commit()
        cur.execute("PRAGMA journal_mode=DELETE;")
    return path


def query_footprint(cursor, footprint: np.ndarray, columns: str = "*",
                    constraints: Optional[str] = None, buffer_size: float = 5,
                    pixel_scale: float = 21.0) -> list:
    """Footprint query with pole and RA=0 wraparound handling.

    Same semantics as reference catalog.py:22-106: a plain box query in the
    normal case; near a pole, RA is ignored; across RA=0, the query becomes
    ``ra <= a OR ra >= b``.  A footprint whose corners span more than 180
    degrees of RA straddles RA=0 (the WCS returns RA in [0, 360)), whether or
    not a corner lies within the buffer of the line.
    """
    constraints = (" AND " + constraints) if constraints else ""
    buffer_deg = buffer_size * pixel_scale / 3600.0
    radec_min = np.min(footprint, axis=0)
    radec_max = np.max(footprint, axis=0)
    ra_min, ra_max = radec_min[0], radec_max[0]
    dec_min = radec_min[1] - buffer_deg
    dec_max = radec_max[1] + buffer_deg

    query = (f"SELECT {columns} FROM catalog WHERE ra BETWEEN :ra_min AND :ra_max "
             f"AND decl BETWEEN :dec_min AND :dec_max{constraints};")
    straddles = (ra_max - ra_min) > 180.0
    if dec_min < -90 or dec_max > 90:
        cursor.execute(query, {"ra_min": 0, "ra_max": 360,
                               "dec_min": dec_min, "dec_max": dec_max})
    elif straddles or ra_min <= buffer_deg or 360 - ra_max <= buffer_deg:
        corners_ra = np.mod(footprint[:, 0] - buffer_deg, 360)
        ra_hi = np.min(corners_ra[corners_ra > 180])
        corners_ra = np.mod(footprint[:, 0] + buffer_deg, 360)
        ra_lo = np.max(corners_ra[corners_ra < 180])
        cursor.execute(
            f"SELECT {columns} FROM catalog WHERE (ra <= :ra_lo OR ra >= :ra_hi) "
            f"AND decl BETWEEN :dec_min AND :dec_max{constraints};",
            {"ra_lo": ra_lo, "ra_hi": ra_hi, "dec_min": dec_min, "dec_max": dec_max})
    else:
        cursor.execute(query, {"ra_min": ra_min - buffer_deg, "ra_max": ra_max + buffer_deg,
                               "dec_min": dec_min, "dec_max": dec_max})
    return cursor.fetchall()


def download_catalogs(input_folder: str, sector: int, camera=None, ccd=None) -> list:
    """Fetch prebuilt catalog SQLite files that are not present yet.

    Counterpart of reference catalog.py:338-388 (the tasoc.dk fetch): the
    URL template comes from ``PHOTOMETRY_TPU_CATALOG_URL`` or the
    ``[catalog] url`` settings key, with the placeholders ``{sector}``,
    ``{camera}`` and ``{ccd}``.  Without a source, present files are
    returned and missing ones are reported in the log.  Returns the paths of
    the catalogs present afterwards, camera by camera, CCD by CCD.
    """
    cameras = [1, 2, 3, 4] if camera is None else list(np.atleast_1d(camera))
    ccds = [1, 2, 3, 4] if ccd is None else list(np.atleast_1d(ccd))
    url_tpl = (os.environ.get("PHOTOMETRY_TPU_CATALOG_URL")
               or load_settings().get("catalog", "url", fallback="").strip() or None)
    out = []
    for cam in cameras:
        for c in ccds:
            path = os.path.join(input_folder, catalog_filename(sector, cam, c))
            if os.path.exists(path):
                out.append(path)
            elif url_tpl:
                out.append(download_file(url_tpl.format(sector=sector, camera=cam, ccd=c), path))
            else:
                logger.info("No catalog for sector=%d camera=%d ccd=%d and no "
                            "download source configured.", sector, cam, c)
    return out


def make_catalog(input_folder: str, sector: int, camera: int, ccd: int,
                 tic_source: Optional[str] = None, overwrite: bool = False,
                 **kw) -> str:
    """Create the catalog for one (sector, camera, ccd) from a TIC extract.

    ``tic_source`` is an ``.npz`` (or whitespace table) with columns starid,
    ra, dec (J2000), pm_ra, pm_dec, tmag and optionally teff, made offline
    from the public TIC (reference catalog.py:109-336 queries a TASOC-internal
    database instead).
    """
    if tic_source is None:
        raise ValueError(
            "A TIC extract file is required (no TASOC-internal database here). "
            "Provide tic_source=<file.npz> with starid/ra/dec/pm_ra/pm_dec/tmag.")
    if tic_source.endswith(".npz"):
        with np.load(tic_source) as d:
            cols = {k: np.asarray(d[k]) for k in d.files}
    else:
        raw = np.loadtxt(tic_source, ndmin=2)  # single-row extracts stay 2-D
        names = ("starid", "ra", "dec", "pm_ra", "pm_dec", "tmag", "teff")
        cols = {n: raw[:, i] for i, n in enumerate(names[:raw.shape[1]])}
    return make_catalog_from_arrays(
        input_folder, sector, camera, ccd,
        starid=cols["starid"], ra_j2000=cols["ra"], dec_j2000=cols["dec"],
        pm_ra=cols.get("pm_ra", np.zeros(len(cols["starid"]))),
        pm_dec=cols.get("pm_dec", np.zeros(len(cols["starid"]))),
        tmag=cols["tmag"], teff=cols.get("teff"),
        overwrite=overwrite, ticver=kw.pop("ticver", "tic-extract"), **kw)


_COLUMNS = ("starid", "ra", "decl", "ra_J2000", "decl_J2000", "pm_ra", "pm_decl",
            "tmag", "teff")


@dataclass
class CatalogSettings:
    sector: int
    camera: int
    ccd: int
    ticver: str
    reference_time: float
    epoch: float
    coord_buffer: float
    camera_centre_ra: float
    camera_centre_dec: float
    footprint: np.ndarray


class StarCatalog:
    """Read access to one catalog SQLite file, columnar-first."""

    def __init__(self, path: str):
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        self.path = path
        self.conn = sqlite3.connect(f"file:{path}?mode=ro", uri=True)
        self.conn.row_factory = sqlite3.Row
        self.cursor = self.conn.cursor()
        row = self.cursor.execute("SELECT * FROM settings LIMIT 1;").fetchone()
        self.settings = CatalogSettings(
            sector=row["sector"], camera=row["camera"], ccd=row["ccd"],
            ticver=str(row["ticver"]), reference_time=row["reference_time"],
            epoch=row["epoch"], coord_buffer=row["coord_buffer"],
            camera_centre_ra=row["camera_centre_ra"],
            camera_centre_dec=row["camera_centre_dec"],
            footprint=_footprint_from_text(row["footprint"]))

    def close(self):
        self.conn.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def target(self, starid: int) -> dict:
        """Main-target row (counterpart of BasePhotometry.py:408-421)."""
        row = self.cursor.execute(
            "SELECT ra,decl,ra_J2000,decl_J2000,pm_ra,pm_decl,tmag,teff "
            "FROM catalog WHERE starid=?;", [int(starid)]).fetchone()
        if row is None:
            raise RuntimeError(f"Star could not be found in catalog: {starid:d}")
        return dict(row)

    def _rows_to_columns(self, rows) -> dict:
        if not rows:
            return {c: np.array([]) for c in _COLUMNS}
        cols = {}
        for i, c in enumerate(_COLUMNS):
            vals = [r[i] for r in rows]
            if c == "starid":
                cols[c] = np.array(vals, dtype=np.int64)
            else:
                cols[c] = np.array([np.nan if v is None else v for v in vals], dtype=np.float64)
        return cols

    def query_footprint(self, footprint, constraints=None, buffer_size: float = 5,
                        pixel_scale: float = 21.0) -> dict:
        """Columnar footprint query: {column: ndarray}."""
        rows = query_footprint(self.cursor, np.asarray(footprint),
                               columns=",".join(_COLUMNS), constraints=constraints,
                               buffer_size=buffer_size, pixel_scale=pixel_scale)
        return self._rows_to_columns(rows)

    def all_stars(self, faint_limit: Optional[float] = None) -> dict:
        """All catalog stars, optionally brighter than ``faint_limit``."""
        q = "SELECT " + ",".join(_COLUMNS) + " FROM catalog"
        if faint_limit is not None:
            q += f" WHERE tmag < {float(faint_limit)}"
        q += " ORDER BY starid;"
        return self._rows_to_columns(self.cursor.execute(q).fetchall())

    def __len__(self) -> int:
        return int(self.cursor.execute("SELECT COUNT(*) FROM catalog;").fetchone()[0])
