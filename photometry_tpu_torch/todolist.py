"""
TODO-list generation: catalogs + image cubes + TPFs -> todo.sqlite.

The port's own copy of ``photometry_tpu/todolist.py`` (reference
photometry/todolist.py): the same output schema (todolist.py:605-643),
dedup rules (:546-581), per-target method overrides and the ``tmag <= 2 ->
halo`` rule (:583-639), exclusion list (:412-415), CBV areas (:31-63) and
edge distances (:66-108).  Host code: numpy and sqlite, no device.  Stars
are put on silicon by one float64 WCS transform per CCD (3 Newton steps of
the SIP inverse, as the JAX package does).

The cube's header, reference WCS and shape are read through
:func:`open_cube`, the one place this module opens a cube (``io.cube`` needs
``h5py`` for that); a caller without ``h5py`` points it at a store with the
same ``header``, ``reference_wcs()`` and ``shape``.

One divergence from the JAX package: a cube's reference WCS is on the
science grid (``io/tess.read_ffi`` shifts the raw-frame WCS of flight FFIs
once, at ingest), so FFI targets are placed with it as it is.  The JAX
package also subtracts the cube's PIXEL_OFFSET_COLUMN (44 on flight FFIs),
the reference's convention for a raw-grid WCS, which drops the stars of the
first 44 science columns from the todo list.  On cubes without an offset
(the simulator's) both packages write the same rows.
"""

from __future__ import annotations

import contextlib
import logging
import os
import sqlite3
from typing import Optional

import numpy as np

from .catalog import StarCatalog
from .io import discovery
from .io.cube import ImageCube
from .io.settings import data_dir, load_settings
from .utils.mathutils import sphere_distance

logger = logging.getLogger(__name__)

__all__ = ["make_todo", "calc_cbv_area", "edge_distance", "open_cube"]


def open_cube(path: str):
    """The prepared cube at ``path``, as a context manager with ``header``,
    ``reference_wcs()`` and ``shape``."""
    return ImageCube(path)


def calc_cbv_area(ra, dec, settings) -> np.ndarray:
    """CBV area code: camera*100 + ccd*10 + radial zone (todolist.py:31-63)."""
    camera_radius = np.sqrt(12**2 + 12**2)
    dist = sphere_distance(ra, dec, settings.camera_centre_ra, settings.camera_centre_dec)
    base = settings.camera * 100 + settings.ccd * 10
    zone = np.select([dist < 0.25 * camera_radius, dist < 0.5 * camera_radius,
                      dist < 0.75 * camera_radius], [1, 2, 3], default=4)
    return base + zone


def edge_distance(row, column, aperture=None, image_shape=None):
    """Distance (px) to the nearest outer edge or aperture hole."""
    if image_shape is None and aperture is None:
        raise ValueError("Please provide either aperture or image_shape.")
    if image_shape is None:
        image_shape = aperture.shape
    row = np.asarray(row, np.float64)
    column = np.asarray(column, np.float64)
    outer = np.minimum.reduce([column + 0.5, row + 0.5,
                               image_shape[1] - (column + 0.5),
                               image_shape[0] - (row + 0.5)])
    if aperture is not None and np.any(~aperture):
        # Brute-force nearest hole pixel: apertures are small stamps.
        hr, hc = np.where(~aperture)
        d = np.sqrt((row[..., None] - hr[None]) ** 2 + (column[..., None] - hc[None]) ** 2)
        hole_dist = np.clip(d.min(axis=-1) - 0.5, 0, None)
        return np.minimum(hole_dist, outer)
    return outer


def _load_table_file(name: str) -> list:
    """Parse a whitespace table data file (ignoring comments)."""
    path = os.path.join(data_dir(), name)
    rows = []
    if not os.path.exists(path):
        return rows
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            rows.append(line.split())
    return rows


def load_exclude_list() -> set:
    """(starid, sector, datasource, datarel) tuples to exclude."""
    return {(int(r[0]), int(r[1]), r[2], int(r[3]))
            for r in _load_table_file("todolist-exclude.dat")}


def load_methods_table() -> dict:
    """(starid, sector, datasource) -> forced method name."""
    return {(int(r[0]), int(r[1]), r[2]): r[3].strip().lower()
            for r in _load_table_file("todolist-methods.dat")}


def _catalog_file(input_folder: str, sector: int, camera: int, ccd: int) -> str:
    cats = discovery.find_catalog_files(input_folder, sector=sector, camera=camera, ccd=ccd)
    if len(cats) != 1:
        raise FileNotFoundError(
            f"Catalog file not found: SECTOR={sector:d}, CAMERA={camera:d}, CCD={ccd:d}")
    return cats[0]


def _ffi_targets(cube_path: str, input_folder: str, exclude: set,
                 faint_limit: float) -> list:
    """All catalog stars on silicon for one prepared cube (vectorised)."""
    with open_cube(cube_path) as cube:
        hdr = cube.header
        sector = int(hdr["SECTOR"])
        camera = int(hdr["CAMERA"])
        ccd = int(hdr["CCD"])
        cadence = int(hdr.get("CADENCE", 1800))
        datarel = int(hdr.get("DATA_REL", 99))
        wcs = cube.reference_wcs()
        shape = cube.shape

    out = []
    with StarCatalog(_catalog_file(input_folder, sector, camera, ccd)) as cat:
        stars = cat.all_stars(faint_limit=faint_limit)
        if len(stars["starid"]) == 0:
            return out
        x, y = wcs.world_to_pixel(stars["ra"], stars["decl"])
        x = x - 1.0  # 0-based science-area column
        y = y - 1.0
        on_silicon = ((x >= -0.5) & (y >= -0.5)
                      & (x <= shape[1] - 0.5) & (y <= shape[0] - 0.5))
        edge = edge_distance(y, x, image_shape=shape)
        cbv = calc_cbv_area(stars["ra"], stars["decl"], cat.settings)
        for i in np.where(on_silicon)[0]:
            sid = int(stars["starid"][i])
            if (sid, sector, "ffi", datarel) in exclude:
                continue
            out.append((sid, sector, camera, ccd, cadence, "ffi",
                        float(stars["tmag"][i]), int(cbv[i]), float(edge[i])))
    return out


def _tpf_targets(fname: str, input_folder: str, cameras, ccds,
                 find_secondary_targets: bool, exclude: set,
                 faint_limit: float) -> list:
    """Primary + secondary targets of one Target Pixel File."""
    from .io.tess import read_tpf
    tpf = read_tpf(fname)
    if tpf.camera not in cameras or tpf.ccd not in ccds:
        return []
    if (tpf.starid, tpf.sector, "tpf", tpf.data_rel) in exclude:
        return []
    out = []
    observed = (tpf.aperture & 1 != 0) if tpf.aperture is not None \
        else np.ones(tpf.shape, bool)
    with StarCatalog(_catalog_file(input_folder, tpf.sector, tpf.camera, tpf.ccd)) as cat:
        try:
            row = cat.target(tpf.starid)
        except RuntimeError:
            logger.error("Starid %d not in catalog (camera=%d, ccd=%d).",
                         tpf.starid, tpf.camera, tpf.ccd)
            return []
        cbv = int(calc_cbv_area(row["ra"], row["decl"], cat.settings))
        out.append((tpf.starid, tpf.sector, tpf.camera, tpf.ccd, tpf.cadence,
                    "tpf", float(row["tmag"]), cbv, np.nan))
        if find_secondary_targets and tpf.wcs is not None:
            h, w = tpf.shape
            corners_x = np.array([0.5, 0.5, w + 0.5, w + 0.5])
            corners_y = np.array([0.5, h + 0.5, h + 0.5, 0.5])
            ra_c, dec_c = tpf.wcs.pixel_to_world(corners_x, corners_y)
            footprint = np.stack([ra_c, dec_c], axis=1)
            sec = cat.query_footprint(
                footprint, constraints=f"starid != {tpf.starid:d} AND tmag < {faint_limit:f}",
                buffer_size=2)
            if len(sec["starid"]):
                x, y = tpf.wcs.world_to_pixel(sec["ra"], sec["decl"])
                x = x - 1.0
                y = y - 1.0
                inside = ((x >= -0.5) & (y >= -0.5) & (x <= w - 0.5) & (y <= h - 0.5))
                for i in np.where(inside)[0]:
                    # clip: np.round's half-to-even sends the inclusive
                    # x == w-0.5 boundary to index w:
                    ry = min(int(np.round(y[i])), h - 1)
                    rx = min(int(np.round(x[i])), w - 1)
                    if not observed[ry, rx]:
                        continue
                    ed = float(edge_distance(y[i], x[i], aperture=observed))
                    out.append((int(sec["starid"][i]), tpf.sector, tpf.camera,
                                tpf.ccd, tpf.cadence, f"tpf:{tpf.starid}",
                                float(sec["tmag"][i]), cbv, ed))
    return out


def make_todo(input_folder: str, sectors=None, cameras=None, ccds=None,
              overwrite: bool = False, find_secondary_targets: bool = True,
              output_file: Optional[str] = None) -> Optional[str]:
    """Build the todo.sqlite work queue for all prepared data in a folder."""
    cameras = [1, 2, 3, 4] if cameras is None else list(np.atleast_1d(cameras))
    ccds = [1, 2, 3, 4] if ccds is None else list(np.atleast_1d(ccds))
    settings = load_settings()
    faint_limit = settings.getfloat("todolist", "faint_limit", fallback=15.0)

    todo_file = output_file or os.path.join(input_folder, "todo.sqlite")
    if not todo_file.endswith(".sqlite"):
        todo_file += ".sqlite"
    if os.path.exists(todo_file):
        if not overwrite:
            logger.info("TODO file already exists")
            return todo_file
        os.remove(todo_file)

    exclude = load_exclude_list()
    cube_files = discovery.find_cube_files(input_folder, sector=sectors,
                                           camera=cameras if len(cameras) < 4 else None,
                                           ccd=ccds if len(ccds) < 4 else None)
    if sectors is None:
        tpf_files = discovery.find_tpf_files(input_folder)
    else:
        tpf_files = []
        for s in np.atleast_1d(sectors):
            tpf_files += discovery.find_tpf_files(input_folder, sector=int(s))

    rows = []
    for fname in tpf_files:
        rows += _tpf_targets(fname, input_folder, cameras, ccds,
                             find_secondary_targets, exclude, faint_limit)
    # Remove secondary TPF targets that are also a primary somewhere:
    primaries = {(r[0], r[4]) for r in rows if r[5] == "tpf"}
    rows = [r for r in rows if not (r[5].startswith("tpf:") and (r[0], r[4]) in primaries)]

    for cube_path in cube_files:
        rows += _ffi_targets(cube_path, input_folder, exclude, faint_limit)

    if not rows:
        logger.error("No targets found")
        return None

    # Deduplicate on (starid, sector, camera, ccd, datasource, cadence):
    seen = set()
    dedup = []
    for r in rows:
        key = (r[0], r[1], r[2], r[3], r[5], r[4])
        if key not in seen:
            seen.add(key)
            dedup.append(r)
    rows = dedup

    # Among duplicated secondary targets (same starid+cadence in several
    # TPFs), keep the one farthest from the edge:
    if find_secondary_targets:
        best = {}
        for i, r in enumerate(rows):
            if not r[5].startswith("tpf:"):
                continue
            key = (r[0], r[4])
            ed = -np.inf if np.isnan(r[8]) else r[8]
            if key not in best or ed > best[key][0]:
                best[key] = (ed, i)
        keep_idx = {i for _, i in best.values()}
        rows = [r for i, r in enumerate(rows)
                if not r[5].startswith("tpf:") or i in keep_idx]

    methods = load_methods_table()
    rows.sort(key=lambda r: r[6])  # by tmag -> priority

    with contextlib.closing(sqlite3.connect(todo_file)) as conn:
        cur = conn.cursor()
        cur.execute("PRAGMA page_size=4096;")
        cur.execute("PRAGMA foreign_keys=ON;")
        cur.execute("PRAGMA locking_mode=EXCLUSIVE;")
        cur.execute("PRAGMA journal_mode=TRUNCATE;")
        cur.execute("""CREATE TABLE todolist (
            priority INTEGER PRIMARY KEY ASC NOT NULL,
            starid INTEGER NOT NULL,
            sector INTEGER NOT NULL,
            datasource TEXT NOT NULL DEFAULT 'ffi',
            camera INTEGER NOT NULL,
            ccd INTEGER NOT NULL,
            cadence INTEGER NOT NULL,
            method TEXT DEFAULT NULL,
            tmag REAL,
            status INTEGER DEFAULT NULL,
            cbv_area INTEGER NOT NULL
        );""")
        for pri, r in enumerate(rows):
            method = methods.get((r[0], r[1], "ffi" if r[5] == "ffi" else "tpf"))
            if method is None and r[6] <= 2.0 and r[5] == "ffi":
                method = "halo"
            cur.execute(
                "INSERT INTO todolist (priority,starid,sector,camera,ccd,cadence,"
                "datasource,tmag,cbv_area,method) VALUES (?,?,?,?,?,?,?,?,?,?);",
                (pri + 1, r[0], r[1], r[2], r[3], r[4], r[5], r[6], r[7], method))
        conn.commit()
        cur.execute("CREATE UNIQUE INDEX unique_target_idx ON todolist "
                    "(starid, datasource, sector, camera, ccd, cadence);")
        cur.execute("CREATE INDEX status_idx ON todolist (status);")
        cur.execute("CREATE INDEX starid_idx ON todolist (starid);")
        conn.commit()
        cur.execute("ANALYZE;")
        conn.commit()
        conn.isolation_level = None
        cur.execute("VACUUM;")
    logger.info("TODO done: %d tasks.", len(rows))
    return todo_file
