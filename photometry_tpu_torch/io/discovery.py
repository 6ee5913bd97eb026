"""
File discovery for TESS data products.

The port's own copy of ``photometry_tpu/io/discovery.py`` (reference
photometry/io.py:122-340): the SPOC FFI and TPF file names, the
TESS-alert TPF names and the sectorNNN_cameraN_ccdN cube and catalog
names.  Directory walks are cached; :func:`clear_cache` invalidates them.
"""

from __future__ import annotations

import glob
import itertools
import os
import re
from functools import lru_cache
from typing import Optional

__all__ = ["find_ffi_files", "find_tpf_files", "find_cube_files", "find_catalog_files",
           "parse_ffi_filename", "clear_cache"]

_FFI_RE = re.compile(
    r"^tess\d+-s(?P<sector>\d{4})-(?P<camera>\d)-(?P<ccd>\d)-\d{4}-[xsab]_ffic\.fits(\.gz)?$")
_TPF_RE = re.compile(
    r"^tess\d+-s(?P<sector>\d{4})-(?P<starid>\d+)-\d{4}-[xsab]_(?P<fast>fast-)?tp\.fits(\.gz)?$")
_ALERT_RE = re.compile(
    r"^hlsp_tess-data-alerts_tess_phot_(?P<starid>\d+)-s(?P<sector>\d{2})_tess_v\d+_tp\.fits(\.gz)?$")


def clear_cache():
    """Invalidate all cached directory walks."""
    _walk_ffis.cache_clear()
    _walk_tpfs.cache_clear()


def parse_ffi_filename(path: str) -> Optional[dict]:
    """Parse sector/camera/ccd out of an SPOC FFI filename, or None."""
    m = _FFI_RE.match(os.path.basename(path))
    if not m:
        return None
    return {"sector": int(m.group("sector")), "camera": int(m.group("camera")),
            "ccd": int(m.group("ccd"))}


@lru_cache(maxsize=32)
def _walk_ffis(rootdir: str) -> tuple:
    matches = []
    for root, _dirs, files in os.walk(rootdir, followlinks=True):
        for fn in files:
            m = _FFI_RE.match(fn)
            if m:
                matches.append((os.path.join(root, fn), int(m.group("sector")),
                                int(m.group("camera")), int(m.group("ccd"))))
    matches.sort(key=lambda t: os.path.basename(t[0]))
    return tuple(matches)


def find_ffi_files(rootdir, sector=None, camera=None, ccd=None) -> list:
    """Recursively find TESS FFI FITS files, sorted by filename (i.e. time)."""
    out = []
    for path, s, cam, c in _walk_ffis(rootdir):
        if sector is not None and s != sector:
            continue
        if camera is not None and cam != camera:
            continue
        if ccd is not None and c != ccd:
            continue
        out.append(path)
    return out


@lru_cache(maxsize=16)
def _walk_tpfs(rootdir: str) -> tuple:
    found = []
    for root, _dirs, files in os.walk(rootdir, followlinks=True):
        for fn in files:
            m = _TPF_RE.match(fn)
            if m:
                cadence = 20 if m.group("fast") else 120
                found.append((os.path.join(root, fn), int(m.group("starid")),
                              int(m.group("sector")), cadence))
                continue
            m = _ALERT_RE.match(fn)
            if m:
                found.append((os.path.join(root, fn), int(m.group("starid")),
                              int(m.group("sector")), 120))
    found.sort(key=lambda t: os.path.basename(t[0]))
    return tuple(found)


def find_tpf_files(rootdir, starid=None, sector=None, camera=None, ccd=None,
                   cadence=None, findmax=None) -> list:
    """Recursively find TESS Target Pixel Files.

    Filtering by camera/ccd opens files to read headers (slow), matching
    the reference semantics (photometry/io.py:207-281).
    """
    if cadence is not None and cadence not in (120, 20):
        raise ValueError("Invalid cadence. Must be either 20 or 120.")
    files = []
    for path, sid, s, cad in _walk_tpfs(rootdir):
        if starid is not None and sid != starid:
            continue
        if sector is not None and s != sector:
            continue
        if cadence is not None and cad != cadence:
            continue
        files.append(path)

    if camera is not None or ccd is not None:
        from .fits import read_fits
        matches = []
        for fpath in files:
            hdr = read_fits(fpath)[0].header
            if camera is not None and hdr.get("CAMERA") != camera:
                continue
            if ccd is not None and hdr.get("CCD") != ccd:
                continue
            matches.append(fpath)
            if findmax is not None and len(matches) >= findmax:
                break
        files = matches

    if findmax is not None:
        files = files[:findmax]
    return files




def _find_by_pattern(rootdir, template, sector, camera, ccd) -> list:
    sectors = (sector,) if not isinstance(sector, (list, tuple)) else tuple(sector)
    cameras = (1, 2, 3, 4) if camera is None else ((camera,) if not isinstance(camera, (list, tuple)) else tuple(camera))
    ccds = (1, 2, 3, 4) if ccd is None else ((ccd,) if not isinstance(ccd, (list, tuple)) else tuple(ccd))
    out = []
    for s, cam, c in itertools.product(sectors, cameras, ccds):
        s_str = "???" if s is None else f"{s:03d}"
        out += glob.glob(os.path.join(rootdir, template.format(sector=s_str, camera=cam, ccd=c)))
    return sorted(set(out))


def find_cube_files(rootdir, sector=None, camera=None, ccd=None) -> list:
    """Find prepared image-cube (HDF5) files: sectorNNN_cameraN_ccdN.hdf5."""
    return _find_by_pattern(rootdir, "sector{sector}_camera{camera}_ccd{ccd}.hdf5",
                            sector, camera, ccd)


def find_catalog_files(rootdir, sector=None, camera=None, ccd=None) -> list:
    """Find catalog SQLite files: catalog_sectorNNN_cameraN_ccdN.sqlite."""
    return _find_by_pattern(rootdir, "catalog_sector{sector}_camera{camera}_ccd{ccd}.sqlite",
                            sector, camera, ccd)
