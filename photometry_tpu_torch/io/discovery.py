"""
File discovery for prepared sector-CCD products.

The port's own copy of the cube and catalog finders of
``photometry_tpu/io/discovery.py`` (reference photometry/io.py
find_hdf5_files / find_catalog_files): the same sectorNNN_cameraN_ccdN
file names.
"""

from __future__ import annotations

import glob
import itertools
import os

__all__ = ["find_cube_files", "find_catalog_files"]


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
