"""
Numeric utilities: the metrics path on torch tensors, and host helpers.

Port of ``photometry_tpu/utils/mathutils.py``.  The torch functions take a
batch along the leading dimensions and reduce along the last one (the JAX
package ``vmap``s the 1-D forms).  The host helpers at the end
(``sphere_distance``, ``add_proper_motion``, ... reference
photometry/utilities.py) are numpy in float64: the todo list, the catalog
and the simulator call them on the host, never on a device.

Medians and quantiles follow ``jnp.nanmedian`` / ``jnp.nanquantile``
exactly (sort with NaNs last, then the same index and weight arithmetic):
``torch.nanmedian`` returns the lower middle value where numpy and JAX
average the two, and ``torch.quantile`` refuses large inputs.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["MAD_TO_SIGMA", "TESS_ZEROPOINT", "mag2flux", "nanmedian",
           "nanquantile", "nanmin", "nanmax", "rms_timescale", "ptp_metric",
           "polyfit_detrend", "moving_median_central", "flux2mag", "add_proper_motion",
           "sphere_distance", "radec_to_cartesian", "cartesian_to_radec",
           "integrated_gaussian", "nanmad", "find_nearest", "np_moving_median_central"]

#: 1 / norm.ppf(3/4) — converts a median absolute deviation to a sigma.
MAD_TO_SIGMA = 1.482602218505602

#: Default TESS magnitude zero-point (TASOC DR5, sectors 1-5).
TESS_ZEROPOINT = 20.451


def mag2flux(mag, zp: float = TESS_ZEROPOINT):
    """Approximate conversion from TESS magnitude to flux (e-/s), host numpy."""
    return np.clip(10.0 ** (-0.4 * (np.asarray(mag, np.float64) - zp)), 0.0, None)


def _sorted_counts(x: torch.Tensor, dim: int):
    """x sorted along ``dim`` with NaNs last, and the count of non-NaNs."""
    xs = torch.sort(x, dim=dim).values          # torch sorts NaN after +inf
    cnt = (~torch.isnan(x)).sum(dim=dim, keepdim=True)
    return xs, cnt


def nanmedian(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """NaN-ignoring median along ``dim``, equal to ``jnp.nanmedian``.

    The mean of the two middle values (``method='midpoint'``); NaN where
    every value is NaN.
    """
    xs, cnt = _sorted_counts(x, dim)
    lo = torch.clamp(torch.div(cnt - 1, 2, rounding_mode="floor"), min=0)
    hi = torch.clamp(torch.minimum(torch.div(cnt, 2, rounding_mode="floor"), cnt - 1), min=0)
    a = torch.take_along_dim(xs, lo, dim=dim)
    b = torch.take_along_dim(xs, hi, dim=dim)
    return ((a + b) * 0.5).squeeze(dim)


def nanquantile(x: torch.Tensor, q: float, dim: int = -1) -> torch.Tensor:
    """NaN-ignoring linear-interpolated quantile, equal to ``jnp.nanquantile``.

    Uses JAX's arithmetic (``low * (1 - w) + high * w`` with the rank in
    the input's float type), which ``torch.nanquantile``'s ``lerp`` does not
    reproduce to the last bit.
    """
    xs, cnt = _sorted_counts(x, dim)
    rank = q * (cnt.to(x.dtype) - 1)
    low = torch.floor(rank)
    high = torch.ceil(rank)
    hw = rank - low
    lw = 1 - hw
    top = cnt - 1
    lo_i = torch.clamp(torch.minimum(low.long(), top), min=0)
    hi_i = torch.clamp(torch.minimum(high.long(), top), min=0)
    a = torch.take_along_dim(xs, lo_i, dim=dim)
    b = torch.take_along_dim(xs, hi_i, dim=dim)
    return (a * lw + b * hw).squeeze(dim)


def nanmin(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Min ignoring NaNs; NaN where every value is NaN (``jnp.nanmin``)."""
    nan = torch.isnan(x)
    out = torch.where(nan, torch.inf, x).amin(dim=dim)
    return torch.where(nan.all(dim=dim), torch.nan, out)


def nanmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Max ignoring NaNs; NaN where every value is NaN (``jnp.nanmax``)."""
    nan = torch.isnan(x)
    out = torch.where(nan, -torch.inf, x).amax(dim=dim)
    return torch.where(nan.all(dim=dim), torch.nan, out)


def moving_median_central(x: torch.Tensor, width: int, dim: int = 0) -> torch.Tensor:
    """Centred moving median along ``dim`` with shrinking edge windows.

    The edge semantics of the reference's bottleneck ``move_median_central``
    (photometry/utilities.py:52-62): at position k the window is
    ``x[max(0, k - w//2) : k + w//2 + 1]``, over the points available; a
    gather of all windows and :func:`nanmedian` over the window axis.
    """
    x = torch.movedim(x, dim, -1)
    n = x.shape[-1]
    half = width // 2
    pos = torch.arange(n, device=x.device)[:, None] + (torch.arange(width, device=x.device)
                                                       - half)[None, :]
    valid = (pos >= 0) & (pos < n)
    windows = x[..., torch.clamp(pos, 0, n - 1)]                     # (..., n, width)
    out = nanmedian(torch.where(valid, windows, torch.nan), dim=-1)
    return torch.movedim(out, -1, dim)


def rms_timescale(time: torch.Tensor, flux: torch.Tensor,
                  timescale: float = 3600 / 86400, max_bins: int = 1024) -> torch.Tensor:
    """Robust RMS of ``flux`` (..., T) binned to ``timescale`` (days).

    ``time`` (T,) is shared by every row (the engine's light curves share
    one cadence grid).  The binned sums are one matmul against the (T,
    max_bins) one-hot bin table instead of the reference's ``segment_sum``:
    its summation order is fixed, where ``index_add_`` on CUDA adds in
    whatever order its atomics land.  Against the JAX package the binned
    means differ by float32 summation order only (a few ulp).  All-NaN flux
    gives NaN; the reference's host-path ValueError for an invalid time
    vector is not reproduced (its traced path returns NaN as well).
    """
    tmin = nanmin(time)
    tmax = nanmax(time)
    span = tmax - tmin
    nbins = torch.clamp(torch.ceil(span / timescale).to(torch.int32) + 1, max=max_bins)
    tfin = torch.isfinite(time)
    good = torch.isfinite(flux) & tfin
    idx = torch.clamp(((time - tmin) / timescale).to(torch.int32), 0, max_bins - 1)
    idx = torch.where(tfin, idx, max_bins - 1).long()
    onehot = torch.zeros(time.shape[0], max_bins, dtype=flux.dtype, device=flux.device)
    onehot[torch.arange(time.shape[0], device=flux.device), idx] = 1.0
    sums = torch.where(good, flux, 0.0) @ onehot
    cnts = good.to(flux.dtype) @ onehot
    bin_ids = torch.arange(max_bins, device=flux.device)
    valid = (cnts > 0) & (bin_ids < nbins)
    means = torch.where(valid, sums / torch.clamp(cnts, min=1.0), torch.nan)
    med = nanmedian(torch.where(valid, means, torch.nan))
    mad = nanmedian(torch.where(valid, torch.abs(means - med[..., None]), torch.nan))
    return torch.where(good.any(dim=-1), MAD_TO_SIGMA * mad, torch.nan)


def ptp_metric(flux: torch.Tensor) -> torch.Tensor:
    """Median point-to-point scatter: nanmedian(|diff(flux)|) along the last dim."""
    return nanmedian(torch.abs(torch.diff(flux, dim=-1)))


def polyfit_detrend(time: torch.Tensor, flux: torch.Tensor, flux_err: torch.Tensor,
                    order: int = 3) -> torch.Tensor:
    """Weighted polynomial trend of each row of ``flux`` (..., T).

    ``np.polyfit(t - tmin, flux, 3, w=1/flux_err)`` + ``np.polyval`` via
    weighted normal equations on a Vandermonde basis, as the reference
    (BasePhotometry.py:1373-1388 through mathutils.polyfit_detrend).
    """
    good = torch.isfinite(time) & torch.isfinite(flux) & torch.isfinite(flux_err)
    tmin = nanmin(torch.where(good, time, torch.nan))[..., None]
    t = torch.where(good, time - tmin, 0.0)
    w = torch.where(good, 1.0 / torch.clamp(flux_err, min=1e-30), 0.0)
    powers = torch.arange(order, -1, -1, device=flux.device)
    A = t[..., None] ** powers
    Aw = A * w[..., None]
    bw = torch.where(good, flux, 0.0) * w
    eye = torch.eye(order + 1, dtype=flux.dtype, device=flux.device)
    ATA = Aw.transpose(-1, -2) @ Aw + 1e-12 * eye
    ATb = (Aw.transpose(-1, -2) @ bw[..., None])[..., 0]
    coeffs = torch.linalg.solve(ATA, ATb)
    detrend = (((time - tmin)[..., None] ** powers) @ coeffs[..., None])[..., 0]
    n_good = good.sum(dim=-1, keepdim=True)
    return torch.where(n_good > (order + 1), detrend, 0.0)


# ---------------------------------------------------------------------------
# Host helpers (numpy, float64)
# ---------------------------------------------------------------------------

def flux2mag(flux, zp: float = TESS_ZEROPOINT):
    """Inverse of :func:`mag2flux`."""
    return -2.5 * np.log10(np.asarray(flux, np.float64)) + zp


def add_proper_motion(ra, dec, pm_ra, pm_dec, bjd, epoch=2000.0):
    """Project (ra, dec) [deg] with proper motions [mas/yr] to epoch ``bjd`` [JD].

    ``pm_ra`` is the catalog mu_alpha* (projected); the unprojection uses the
    mean declination between the two epochs (photometry/utilities.py:65-97).
    """
    ra = np.asarray(ra, np.float64)
    dec = np.asarray(dec, np.float64)
    dt_years = (np.asarray(bjd, np.float64) - 2451544.5) / 365.25 + 2000.0 - epoch
    dec_rate = np.asarray(pm_dec, np.float64) / 3.6e6  # deg/yr
    dec_new = dec + dt_years * dec_rate
    ra_rate = np.asarray(pm_ra, np.float64) / np.cos(np.deg2rad(dec + dt_years * dec_rate / 2.0)) / 3.6e6
    return ra + dt_years * ra_rate, dec_new


def sphere_distance(ra1, dec1, ra2, dec2):
    """Great-circle distance in degrees (Vincenty formula, stable at poles)."""
    ra1, ra2 = np.deg2rad(np.asarray(ra1, np.float64)), np.deg2rad(np.asarray(ra2, np.float64))
    dec1, dec2 = np.deg2rad(np.asarray(dec1, np.float64)), np.deg2rad(np.asarray(dec2, np.float64))
    dra = ra2 - ra1
    num = np.sqrt((np.cos(dec2) * np.sin(dra)) ** 2
                  + (np.cos(dec1) * np.sin(dec2) - np.sin(dec1) * np.cos(dec2) * np.cos(dra)) ** 2)
    den = np.sin(dec1) * np.sin(dec2) + np.cos(dec1) * np.cos(dec2) * np.cos(dra)
    return np.rad2deg(np.arctan2(num, den))


def radec_to_cartesian(radec):
    """(N, 2) array of (ra, dec) in degrees -> (N, 3) unit vectors."""
    radec = np.atleast_2d(np.asarray(radec, np.float64))
    phi = np.deg2rad(radec[:, 0])
    theta = np.pi / 2 - np.deg2rad(radec[:, 1])
    return np.stack([np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi), np.cos(theta)],
                    axis=1)


def cartesian_to_radec(xyz):
    """(N, 3) unit vectors -> (N, 2) array of (ra, dec) in degrees, ra in [0, 360)."""
    xyz = np.atleast_2d(np.asarray(xyz, np.float64))
    dec = np.pi / 2 - np.arccos(np.clip(xyz[:, 2], -1.0, 1.0))
    ra = np.arctan2(xyz[:, 1], xyz[:, 0])
    ra = np.where(ra < 0, ra + 2 * np.pi, ra)
    return np.rad2deg(np.stack([ra, dec], axis=1))


def integrated_gaussian(x, y, flux, x_0, y_0, sigma=1.0):
    """Symmetric 2-D Gaussian integrated over unit pixels centred at (x, y)."""
    from scipy.special import erf
    denom = np.sqrt(2.0) * sigma
    ex = erf((x - x_0 + 0.5) / denom) - erf((x - x_0 - 0.5) / denom)
    ey = erf((y - y_0 + 0.5) / denom) - erf((y - y_0 - 0.5) / denom)
    return flux / 4.0 * ex * ey


def nanmad(x, axis=None, scale_to_sigma: bool = False):
    """Median absolute deviation, ignoring NaNs; optionally scaled to sigma."""
    x = np.asarray(x)
    med = np.nanmedian(x, axis=axis, keepdims=axis is not None)
    mad = np.nanmedian(np.abs(x - med), axis=axis)
    return mad * MAD_TO_SIGMA if scale_to_sigma else mad


def find_nearest(array, value):
    """Index of the element of ``array`` closest to ``value`` (NaN-safe)."""
    array = np.asarray(array)
    return int(np.argmin(np.where(np.isnan(array), np.inf, np.abs(array - value))))


def np_moving_median_central(x, width: int, axis: int = 0) -> np.ndarray:
    """Host version of :func:`moving_median_central`: centred moving median
    with shrinking edge windows."""
    x = np.moveaxis(np.asarray(x, dtype=float), axis, 0)
    n = x.shape[0]
    half = width // 2
    out = np.empty_like(x)
    for k in range(n):
        lo, hi = max(0, k - half), min(n, k + half + 1)
        out[k] = np.nanmedian(x[lo:hi], axis=0)
    return np.moveaxis(out, 0, axis)
