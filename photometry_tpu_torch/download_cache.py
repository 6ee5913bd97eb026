"""
Pre-populate the caches a fleet of photometry workers shares.

The port's own copy of ``photometry_tpu/download_cache.py`` (reference
photometry/download_cache.py:15-60, which pre-downloads astropy IERS tables
and SPICE kernels so that workers do not race on cache writes).  The shared
asset here is the spacecraft ephemeris table of the barycentric time
correction (``core.timecorr``):

- with a URL configured (``PHOTOMETRY_TPU_EPHEMERIS_URL``, else the
  ``[timecorr] ephemeris_url`` settings key) the table is fetched once into
  the cache with the standard library's ``urllib`` (a ``file://`` URL
  needs no network);
- without one, a validation-grade synthetic ephemeris is written over the
  mission's sectors (``testing``: sectors 1 and 27 only, as the reference's
  ``--testing``).

The cache folder (``PHOTOMETRY_TPU_CACHE``, default ``~/.photometry_tpu``)
and the file name are the JAX package's, so both packages share one cache.
:func:`ephemeris_path` and :func:`load_cached_ephemeris` are defined here
only; the dispatcher's time corrector reads the table through them.
"""

from __future__ import annotations

import logging
import os
import re
import urllib.request
from typing import Optional

import numpy as np

from .core.timecorr import SpacecraftEphemeris
from .io.settings import load_settings, sector_info

logger = logging.getLogger(__name__)

__all__ = ["AU_KM", "cache_dir", "ephemeris_path", "download_cache",
           "load_cached_ephemeris", "horizons_to_ephemeris"]

AU_KM = 149597870.7


def horizons_to_ephemeris(source: str, output: Optional[str] = None,
                          earth_source: Optional[str] = None
                          ) -> SpacecraftEphemeris:
    """Convert a JPL Horizons VECTORS export to the npz ephemeris schema.

    This is the offline provisioning path for real spacecraft ephemerides
    (the reference instead downloads binary SPICE kernels at run time,
    spice.py:104-158): export TESS (``-95``) barycentric state vectors from
    https://ssd.jpl.nasa.gov/horizons/ with center ``500@0`` (solar system
    barycenter), reference plane FRAME/ICRF, any step, and feed the saved
    text file here.  Both Horizons output styles are understood:

    - CSV rows (``CSV_FORMAT=YES``): ``JDTDB, calendar, X, Y, Z, ...``
    - verbose blocks (default): ``JD = A.D. ...`` line followed by
      ``X = ... Y = ... Z = ...``

    Units are detected from the ``Output units`` header (KM or AU).

    Parameters:
        source: path to the Horizons text export.
        output: optional path to write the ``.npz`` table (e.g.
            :func:`ephemeris_path` to drop it straight into the cache).
        earth_source: optional second VECTORS export for the EARTH
            geocentre (target ``399``, center ``500@0``); stored as
            ``pos_earth`` (interpolated onto the spacecraft grid when the
            grids differ) and enables the Einstein clock term of
            ``TimeCorrector.barycentric_correction_full``.

    Returns:
        The parsed :class:`SpacecraftEphemeris`.
    """
    times, pos = _parse_horizons_vectors(source)
    pos_earth = None
    if earth_source:
        et, ep = _parse_horizons_vectors(earth_source)
        if len(et) == len(times) and np.allclose(et, times):
            pos_earth = ep
        else:
            pos_earth = np.stack([np.interp(times, et, ep[:, k])
                                  for k in range(3)], axis=1)
    eph = SpacecraftEphemeris(time=times, pos=pos, pos_earth=pos_earth)
    if output:
        eph.save(output)
        logger.info("Wrote %d-sample ephemeris to %s", len(times), output)
    return eph


def _parse_horizons_vectors(source: str):
    """(times [JD TDB], pos [km, (M, 3)]) from one Horizons VECTORS export."""
    with open(source) as fh:
        text = fh.read()
    m = re.search(r"\$\$SOE(.*?)\$\$EOE", text, re.S)
    if not m:
        raise ValueError(f"No $$SOE/$$EOE data block in {source!r} — "
                         "is this a Horizons VECTORS export?")
    header = text[:m.start()]
    scale = 1.0
    mu = re.search(r"Output units\s*:\s*([A-Z-]+)", header)
    if mu and mu.group(1).startswith("AU"):
        scale = AU_KM

    times, pos = [], []
    block = m.group(1).strip().splitlines()
    i = 0
    float_re = r"[-+]?\d+\.?\d*(?:[Ee][-+]?\d+)?"
    while i < len(block):
        line = block[i].strip()
        i += 1
        if not line:
            continue
        if "," in line:
            # CSV row: JDTDB, calendar date, X, Y, Z[, VX, VY, VZ][, ...]
            parts = [p.strip() for p in line.split(",")]
            times.append(float(parts[0]))
            pos.append([float(parts[2]), float(parts[3]), float(parts[4])])
        else:
            # Verbose: "2458324.5 = A.D. 2018-Jul-25 00:00 TDB" then X/Y/Z:
            mjd = re.match(rf"({float_re})\s*=", line)
            if not mjd:
                continue
            jd = float(mjd.group(1))
            xyz = {}
            while i < len(block) and len(xyz) < 3:
                for name, val in re.findall(
                        rf"\b(X|Y|Z)\s*=\s*({float_re})", block[i]):
                    xyz[name] = float(val)
                i += 1
            if len(xyz) == 3:
                times.append(jd)
                pos.append([xyz["X"], xyz["Y"], xyz["Z"]])
    if not times:
        raise ValueError(f"No state vectors parsed from {source!r}")
    return (np.asarray(times, np.float64),
            np.asarray(pos, np.float64) * scale)


def cache_dir() -> str:
    """The workers' shared cache folder, made if absent."""
    d = os.environ.get("PHOTOMETRY_TPU_CACHE",
                       os.path.join(os.path.expanduser("~"), ".photometry_tpu"))
    os.makedirs(d, exist_ok=True)
    return d


def ephemeris_path() -> str:
    """The cached spacecraft ephemeris file."""
    return os.path.join(cache_dir(), "spacecraft_ephemeris.npz")


def download_cache(testing: bool = False, jd_start: Optional[float] = None,
                   jd_end: Optional[float] = None) -> str:
    """Ensure the shared ephemeris cache exists; returns its path."""
    path = ephemeris_path()
    if os.path.exists(path):
        logger.info("Ephemeris cache already present: %s", path)
        return path

    # Production URL: environment variable wins, else the [timecorr]
    # ephemeris_url settings key (counterpart of the reference's kernel
    # download base URL, spice.py:122-124).
    url = os.environ.get("PHOTOMETRY_TPU_EPHEMERIS_URL")
    if not url:
        url = load_settings().get("timecorr", "ephemeris_url",
                                  fallback="").strip() or None
    if url:
        tmp = path + ".part"
        logger.info("Downloading ephemeris from %s", url)
        urllib.request.urlretrieve(url, tmp)
        os.replace(tmp, path)
        return path

    # Offline: synthesize a validation-grade ephemeris covering the mission
    # (or, in testing mode, just sectors 1 + 27 like the reference):
    if jd_start is None or jd_end is None:
        table = sector_info()
        if testing:
            times = [table[1].reference_time, table[27].reference_time]
            jd_start = min(times) - 20
            jd_end = max(times) + 20
        else:
            refs = [s.reference_time for s in table.values()]
            jd_start = min(refs) - 30
            jd_end = max(refs) + 30
    logger.info("Generating synthetic ephemeris JD %.1f..%.1f", jd_start, jd_end)
    eph = SpacecraftEphemeris.synthetic(jd_start, jd_end, step_days=0.25)
    eph.save(path)
    return path


def load_cached_ephemeris() -> SpacecraftEphemeris:
    """The cached ephemeris, provisioned by :func:`download_cache` if absent."""
    path = ephemeris_path()
    if not os.path.exists(path):
        path = download_cache()
    return SpacecraftEphemeris.load(path)
