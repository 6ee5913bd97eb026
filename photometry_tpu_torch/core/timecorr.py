"""
Barycentric time correction from a spacecraft ephemeris table (host float64).

Port of the host classes of ``photometry_tpu/core/timecorr.py`` (reference
photometry/spice.py barycorr): they are numpy already, but that module
imports JAX.  ``timecorr = (r_sc(t) . n_hat(ra, dec)) / c`` (Rømer delay),
with the spacecraft position interpolated linearly from the table;
:meth:`TimeCorrector.barycentric_correction_full` adds the Shapiro and
Einstein terms, and the rest of the reference's TESS_SPICE interface
(``position_velocity``, ``time_coverage``, ``sclk2jd``) is there too.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

__all__ = ["SpacecraftEphemeris", "TimeCorrector"]

C_KM_PER_DAY = 299792.458 * 86400.0  #: speed of light [km/day]
GM_SUN_C3_DAYS = 4.92549094764e-6 / 86400.0  #: GM_sun/c^3 [days] (Shapiro scale)


@dataclass
class SpacecraftEphemeris:
    """Barycentric spacecraft positions sampled on a time grid."""

    time: np.ndarray   #: (M,) JD (TDB)
    pos: np.ndarray    #: (M, 3) km, ICRS axes, relative to the SSB
    pos_earth: Optional[np.ndarray] = None  #: (M, 3) km Earth geocentre wrt SSB

    @classmethod
    def load(cls, path: str) -> "SpacecraftEphemeris":
        with np.load(path) as d:
            pe = np.asarray(d["pos_earth"], np.float64) if "pos_earth" in d else None
            return cls(time=np.asarray(d["time"], np.float64),
                       pos=np.asarray(d["pos"], np.float64), pos_earth=pe)

    def save(self, path: str):
        extra = {} if self.pos_earth is None else {"pos_earth": self.pos_earth}
        np.savez_compressed(path, time=self.time, pos=self.pos, **extra)

    @classmethod
    def synthetic(cls, jd_start: float, jd_end: float, step_days: float = 0.25
                  ) -> "SpacecraftEphemeris":
        """Analytic Earth + TESS-like orbit ephemeris (validation grade; see
        photometry_tpu.core.timecorr.SpacecraftEphemeris.synthetic)."""
        from .ephem_analytic import earth_barycentric, tess_geocentric
        t = np.arange(jd_start, jd_end + step_days, step_days)
        earth = earth_barycentric(t)
        return cls(time=t, pos=earth + tess_geocentric(t), pos_earth=earth)


class TimeCorrector:
    """Batched barycentric (Rømer) time corrections, host float64."""

    def __init__(self, ephemeris: SpacecraftEphemeris):
        self.eph = ephemeris
        self._t = np.asarray(ephemeris.time, np.float64)
        self._p = np.asarray(ephemeris.pos, np.float64)

    def position(self, jd) -> np.ndarray:
        """Interpolated spacecraft position(s) [km] at JD (TDB)."""
        return self._interp(np.atleast_1d(np.asarray(jd, np.float64)))

    def _interp(self, jd, table=None):
        """Rows of ``table`` (the spacecraft positions by default) at JD, linearly."""
        p = self._p if table is None else table
        i = np.clip(np.searchsorted(self._t, jd, side="right") - 1, 0, self._t.shape[0] - 2)
        t0 = self._t[i]
        t1 = self._t[i + 1]
        w = np.clip((jd - t0) / np.maximum(t1 - t0, 1e-30), 0.0, 1.0)
        return p[i] * (1 - w)[..., None] + p[i + 1] * w[..., None]

    def _interp_earth(self, jd):
        return self._interp(jd, self.eph.pos_earth)

    def barycentric_correction(self, time_nocorr, ra, dec, btjd: bool = True):
        """timecorr [days]: (T,) for scalar ra/dec, else (N, T), such that
        ``time_bary = time_nocorr + timecorr``."""
        t = np.asarray(time_nocorr, np.float64)
        jd = t + 2457000.0 if btjd else t
        pos = self._interp(jd)                       # (T, 3)
        ra_r = np.deg2rad(np.atleast_1d(np.asarray(ra, np.float64)))
        dec_r = np.deg2rad(np.atleast_1d(np.asarray(dec, np.float64)))
        n_hat = np.stack([np.cos(dec_r) * np.cos(ra_r),
                          np.cos(dec_r) * np.sin(ra_r),
                          np.sin(dec_r)], axis=1)    # (N, 3)
        corr = (n_hat @ pos.T) / C_KM_PER_DAY        # (N, T)
        if np.ndim(ra) == 0:
            return corr[0]
        return corr

    def apply(self, time_nocorr, ra, dec, btjd: bool = True):
        """(corrected_time, timecorr) for one target (BasePhotometry.py:443-453)."""
        corr = self.barycentric_correction(time_nocorr, ra, dec, btjd=btjd)
        return np.asarray(time_nocorr, np.float64) + corr, corr

    # --- the reference's TESS_SPICE interface (photometry/spice.py) ---------

    def position_velocity(self, jd) -> tuple:
        """(pos [km], vel [km/s]) at JD (TDB) (TESS_SPICE.position_velocity,
        spice.py:281-309), the velocity by central difference (dt = 60 s)."""
        jd = np.atleast_1d(np.asarray(jd, np.float64))
        dt = 60.0 / 86400.0
        pos = self._interp(jd)
        vel = (self._interp(jd + dt) - self._interp(jd - dt)) / (2 * dt * 86400.0)
        return pos, vel

    def time_coverage(self) -> tuple:
        """(jd_first, jd_last) of the loaded ephemeris (TESS_SPICE.time_coverage,
        spice.py:434-471)."""
        return float(self._t[0]), float(self._t[-1])

    def sclk2jd(self, sclk, epoch_jd: float = 2457000.0, rate: float = 86400.0):
        """Spacecraft-clock seconds -> JD (TDB) by the linear clock model
        ``epoch_jd + sclk / rate`` (the reference converts with the CSPICE
        SCLK kernel, spice.py:328-346)."""
        return epoch_jd + np.asarray(sclk, np.float64) / rate

    def barycentric_correction_full(self, time_nocorr, ra, dec, btjd: bool = True):
        """Rømer + Shapiro + Einstein correction [days] (TESS_SPICE.barycorr2's
        delay sum, spice.py:386-431).

        The Shapiro term is -(2 GM_sun/c^3) ln(1 - cos psi) with the Sun at
        the solar-system barycentre; the Einstein (clock) term is the
        topocentric dot(r_sc/geo, v_earth/SSB) / c^2 (spice.py:424-428) and
        needs ``SpacecraftEphemeris.pos_earth``; without it the term is left
        out.
        """
        t = np.asarray(time_nocorr, np.float64)
        jd = t + 2457000.0 if btjd else t
        pos = self._interp(jd)                                    # (T, 3)
        ra_r = np.deg2rad(np.atleast_1d(np.asarray(ra, np.float64)))
        dec_r = np.deg2rad(np.atleast_1d(np.asarray(dec, np.float64)))
        n_hat = np.stack([np.cos(dec_r) * np.cos(ra_r),
                          np.cos(dec_r) * np.sin(ra_r),
                          np.sin(dec_r)], axis=1)                 # (N, 3)
        romer = (n_hat @ pos.T) / C_KM_PER_DAY                    # (N, T)
        r = np.linalg.norm(pos, axis=1)                           # (T,) sc->SSB(~Sun)
        cos_psi = -(n_hat @ pos.T) / np.maximum(r, 1e-30)         # sc->Sun vs sc->target
        shapiro = -2.0 * GM_SUN_C3_DAYS * np.log(np.maximum(1.0 - cos_psi, 1e-12))
        corr = romer + shapiro
        if self.eph.pos_earth is not None:
            earth = self._interp_earth(jd)                        # (T, 3) km
            geo = pos - earth                                     # sc wrt geocentre
            dt = 60.0 / 86400.0
            v_earth = (self._interp_earth(jd + dt)
                       - self._interp_earth(jd - dt)) / (2 * dt * 86400.0)
            c_kms = 299792.458
            einstein_s = np.sum(geo * v_earth, axis=1) / c_kms**2  # (T,) s
            corr = corr + einstein_s[None, :] / 86400.0
        if np.ndim(ra) == 0:
            return corr[0]
        return corr
