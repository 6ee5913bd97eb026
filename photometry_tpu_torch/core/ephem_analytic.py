"""
Analytic solar-system geometry for offline ephemeris generation/validation.

The reference obtains TESS positions from CSPICE kernels downloaded at
runtime (photometry/spice.py:122-166); this image has no network and no
CSPICE, so the framework ships an *analytic* model good enough to validate
the barycentric-correction pipeline at the ~0.1-second level against the
~500-second Rømer term:

- Earth heliocentric position from the standard low-precision solar
  coordinates (Meeus, Astronomical Algorithms ch. 25 truncation; ~0.01 deg
  in longitude -> ~25,000 km transverse, ~0.08 light-seconds).
- The Sun's offset from the solar-system barycentre from Keplerian mean
  elements of Jupiter/Saturn/Uranus/Neptune (JPL "approximate positions"
  tables).  This term is up to ~0.01 AU = 2.5 light-seconds and was
  MISSING from the pre-round-5 synthetic ephemeris — it dominates the
  absolute error budget of any heliocentric-only model.
- A realistic TESS HEO: 13.7-day 2:1 lunar-resonance ellipse
  (perigee ~17 R_E, apogee ~59 R_E, e ~ 0.55, i ~ 37 deg).  The true TESS
  orbit needs flight data (JPL Horizons; tools/make_ephemeris.py converts
  VECTORS exports) — this analytic stand-in has the right scale (~1.3
  light-seconds at apogee) and period.

All positions are equatorial ICRS-axis km relative to the SSB, matching
the SpacecraftEphemeris table convention (core/timecorr.py).
"""

from __future__ import annotations

import numpy as np

__all__ = ["earth_barycentric", "sun_barycentric", "tess_geocentric",
           "tess_barycentric"]

AU_KM = 149597870.7
_OBLIQUITY_DEG = 23.4392911  #: mean obliquity at J2000

#: Keplerian mean elements at J2000 + rates per Julian century (JPL
#: approximate-positions table, valid 1800-2050):
#: (a [AU], e, I [deg], L [deg], long.peri [deg], long.node [deg]),
#: rates for (L,) only — the slow elements move too little to matter at
#: our accuracy over the TESS mission span.  mass_ratio = M_sun/M_planet.
_GIANTS = {
    "jupiter": dict(a=5.20288700, e=0.04838624, i=1.30439695,
                    L0=34.39644051, Ldot=3034.74612775,
                    peri=14.72847983, node=100.47390909,
                    mass_ratio=1047.348644),
    "saturn": dict(a=9.53667594, e=0.05386179, i=2.48599187,
                   L0=49.95424423, Ldot=1222.49362201,
                   peri=92.59887831, node=113.66242448,
                   mass_ratio=3497.9018),
    "uranus": dict(a=19.18916464, e=0.04725744, i=0.77263783,
                   L0=313.23810451, Ldot=428.48202785,
                   peri=170.95427630, node=74.01692503,
                   mass_ratio=22902.98),
    "neptune": dict(a=30.06992276, e=0.00859048, i=1.77004347,
                    L0=-55.12002969, Ldot=218.45945325,
                    peri=44.96476227, node=131.78422574,
                    mass_ratio=19412.26),
}


def _solve_kepler(M, e, iters: int = 8):
    """Eccentric anomaly by Newton iteration (vectorised, e < 0.7)."""
    E = M + e * np.sin(M)
    for _ in range(iters):
        E = E - (E - e * np.sin(E) - M) / (1.0 - e * np.cos(E))
    return E


def _ecl_to_eq(v):
    """Rotate ecliptic-frame vectors (..., 3) to equatorial (ICRS axes)."""
    eps = np.deg2rad(_OBLIQUITY_DEG)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return np.stack([x,
                     y * np.cos(eps) - z * np.sin(eps),
                     y * np.sin(eps) + z * np.cos(eps)], axis=-1)


def _planet_heliocentric(jd, el) -> np.ndarray:
    """Heliocentric equatorial position [km] from mean Kepler elements."""
    T = (np.asarray(jd, np.float64) - 2451545.0) / 36525.0
    L = np.deg2rad(el["L0"] + el["Ldot"] * T)
    peri = np.deg2rad(el["peri"])
    node = np.deg2rad(el["node"])
    inc = np.deg2rad(el["i"])
    M = np.mod(L - peri, 2 * np.pi)
    E = _solve_kepler(M, el["e"])
    a, e = el["a"], el["e"]
    xp = a * (np.cos(E) - e)
    yp = a * np.sqrt(1 - e * e) * np.sin(E)
    omega = peri - node  # argument of perihelion
    co, so = np.cos(omega), np.sin(omega)
    cn, sn = np.cos(node), np.sin(node)
    ci, si = np.cos(inc), np.sin(inc)
    x = (co * cn - so * sn * ci) * xp + (-so * cn - co * sn * ci) * yp
    y = (co * sn + so * cn * ci) * xp + (-so * sn + co * cn * ci) * yp
    z = (so * si) * xp + (co * si) * yp
    return _ecl_to_eq(np.stack([x, y, z], axis=-1) * AU_KM)


def sun_barycentric(jd) -> np.ndarray:
    """Sun's position [km, equatorial] relative to the SSB.

    r_sun = -sum(m_i r_i,helio) / (M_sun + sum m_i); the four giant
    planets carry >99% of the offset (up to ~0.01 AU).
    """
    jd = np.atleast_1d(np.asarray(jd, np.float64))
    num = np.zeros((len(jd), 3))
    inv_masses = 0.0
    for el in _GIANTS.values():
        num += _planet_heliocentric(jd, el) / el["mass_ratio"]
        inv_masses += 1.0 / el["mass_ratio"]
    return -num / (1.0 + inv_masses)


def _earth_heliocentric(jd) -> np.ndarray:
    """Earth heliocentric equatorial position [km] (low-precision solar
    coordinates; ~0.01 deg)."""
    d = np.atleast_1d(np.asarray(jd, np.float64)) - 2451545.0
    g = np.deg2rad(np.mod(357.529 + 0.98560028 * d, 360.0))
    L = np.deg2rad(np.mod(280.459 + 0.98564736 * d, 360.0))
    lam = L + np.deg2rad(1.915) * np.sin(g) + np.deg2rad(0.020) * np.sin(2 * g)
    r = (1.00014 - 0.01671 * np.cos(g) - 0.00014 * np.cos(2 * g)) * AU_KM
    sun_from_earth = np.stack([r * np.cos(lam), r * np.sin(lam),
                               np.zeros_like(r)], axis=-1)
    return _ecl_to_eq(-sun_from_earth)


def earth_barycentric(jd) -> np.ndarray:
    """Earth geocentre [km, equatorial] relative to the SSB."""
    return sun_barycentric(jd) + _earth_heliocentric(jd)


def tess_geocentric(jd, perigee_km: float = 108000.0,
                    apogee_km: float = 376000.0, period_days: float = 13.7,
                    incl_deg: float = 37.0, node_deg: float = 40.0,
                    peri_epoch_jd: float = 2458325.0) -> np.ndarray:
    """Analytic TESS-like HEO geocentric position [km, equatorial].

    2:1 lunar-resonance ellipse with the published orbit scale (perigee
    ~17 R_E, apogee ~59 R_E, P = 13.7 d, i ~ 37 deg).  A stand-in for the
    flight orbit — replace with a Horizons export for absolute work
    (tools/make_ephemeris.py).
    """
    jd = np.atleast_1d(np.asarray(jd, np.float64))
    a = 0.5 * (perigee_km + apogee_km)
    e = (apogee_km - perigee_km) / (apogee_km + perigee_km)
    M = 2 * np.pi * np.mod(jd - peri_epoch_jd, period_days) / period_days
    E = _solve_kepler(M, e)
    xp = a * (np.cos(E) - e)
    yp = a * np.sqrt(1 - e * e) * np.sin(E)
    inc = np.deg2rad(incl_deg)
    node = np.deg2rad(node_deg)
    ci, si = np.cos(inc), np.sin(inc)
    cn, sn = np.cos(node), np.sin(node)
    x = cn * xp - sn * ci * yp
    y = sn * xp + cn * ci * yp
    z = si * yp
    return _ecl_to_eq(np.stack([x, y, z], axis=-1))


def tess_barycentric(jd, **orbit_kw) -> np.ndarray:
    """TESS position [km, equatorial] relative to the SSB."""
    return earth_barycentric(jd) + tess_geocentric(jd, **orbit_kw)
