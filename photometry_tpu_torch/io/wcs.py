"""
World Coordinate System: gnomonic (TAN) projection with SIP distortion.

Port of ``photometry_tpu/io/wcs.py`` with the same two faces:

- the host :class:`TanWCS` object in numpy float64 (header round trip,
  ``pixel_to_world``, ``world_to_pixel``, ``rowcol_of_radec``, ``copy``);
- :func:`tan_pixel_to_world` / :func:`tan_world_to_pixel` on torch tensors,
  replacing the reference's ``xp=jnp`` branch, for batched transforms on a
  device in the tensors' own dtype.

Both faces run the same formulas through a small array namespace (numpy or
the torch shim below).  :func:`fit_tan_wcs` fits a TAN WCS to matched
points, in numpy float64.

Pixel convention: FITS 1-based (x = column+1, y = row+1), matching the headers.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

__all__ = ["TanWCS", "fit_tan_wcs", "tan_pixel_to_world", "tan_world_to_pixel"]

_D2R = np.pi / 180.0


class _TorchNS:
    """The numpy names the transforms use, on torch tensors."""

    arctan2 = staticmethod(torch.atan2)
    arctan = staticmethod(torch.atan)
    sin = staticmethod(torch.sin)
    cos = staticmethod(torch.cos)
    sqrt = staticmethod(torch.sqrt)
    rad2deg = staticmethod(torch.rad2deg)
    deg2rad = staticmethod(torch.deg2rad)
    atleast_1d = staticmethod(torch.atleast_1d)
    zeros_like = staticmethod(torch.zeros_like)

    @staticmethod
    def asarray(x, like=None):
        if isinstance(x, torch.Tensor):
            return x
        if like is not None:
            return torch.as_tensor(np.asarray(x), dtype=like.dtype, device=like.device)
        return torch.as_tensor(x)

    @staticmethod
    def inv(a):
        return torch.linalg.inv(a)


class _NumpyNS:
    arctan2 = staticmethod(np.arctan2)
    arctan = staticmethod(np.arctan)
    sin = staticmethod(np.sin)
    cos = staticmethod(np.cos)
    sqrt = staticmethod(np.sqrt)
    rad2deg = staticmethod(np.rad2deg)
    deg2rad = staticmethod(np.deg2rad)
    atleast_1d = staticmethod(np.atleast_1d)
    zeros_like = staticmethod(np.zeros_like)

    @staticmethod
    def asarray(x, like=None):
        return np.asarray(x)

    @staticmethod
    def inv(a):
        return np.linalg.inv(np.asarray(a))


def _params(xp, like, *arrays):
    """Coefficient arrays in the namespace (and, for torch, dtype/device) of ``like``."""
    return [None if a is None else xp.asarray(a, like=like) for a in arrays]


def _sip_eval(u, v, coeffs, powers, xp):
    """Evaluate a SIP polynomial sum(c_k * u^p_k * v^q_k) for packed coeffs."""
    if coeffs is None or len(coeffs) == 0:
        return xp.zeros_like(u)
    p = powers[:, 0][:, None]
    q = powers[:, 1][:, None]
    uu = u[None, :] ** p
    vv = v[None, :] ** q
    return (coeffs[:, None] * uu * vv).sum(0)


def _pixel_to_world(x, y, crpix, crval, cd, sip_a, sip_a_pow, sip_b, sip_b_pow, xp):
    x = xp.atleast_1d(x)
    y = xp.atleast_1d(y)
    u = x - crpix[0]
    v = y - crpix[1]
    if sip_a is not None:
        du = _sip_eval(u, v, sip_a, sip_a_pow, xp)
        dv = _sip_eval(u, v, sip_b, sip_b_pow, xp)
        u, v = u + du, v + dv
    xi = (cd[0, 0] * u + cd[0, 1] * v) * _D2R
    eta = (cd[1, 0] * u + cd[1, 1] * v) * _D2R
    ra0 = crval[0] * _D2R
    dec0 = crval[1] * _D2R
    denom = xp.cos(dec0) - eta * xp.sin(dec0)
    ra = ra0 + xp.arctan2(xi, denom)
    dec = xp.arctan((xp.sin(dec0) + eta * xp.cos(dec0)) / xp.sqrt(xi**2 + denom**2))
    ra = xp.rad2deg(ra) % 360.0
    return ra, xp.rad2deg(dec)


def _tan_project(ra, dec, crval, xp):
    """(ra, dec) deg -> gnomonic plane coords (xi, eta) in degrees."""
    ra = xp.deg2rad(xp.atleast_1d(ra))
    dec = xp.deg2rad(xp.atleast_1d(dec))
    ra0 = crval[0] * _D2R
    dec0 = crval[1] * _D2R
    cosc = xp.sin(dec0) * xp.sin(dec) + xp.cos(dec0) * xp.cos(dec) * xp.cos(ra - ra0)
    xi = xp.cos(dec) * xp.sin(ra - ra0) / cosc
    eta = (xp.cos(dec0) * xp.sin(dec) - xp.sin(dec0) * xp.cos(dec) * xp.cos(ra - ra0)) / cosc
    return xp.rad2deg(xi), xp.rad2deg(eta)


def _world_to_pixel(ra, dec, crpix, crval, cd, sip_a, sip_a_pow, sip_b, sip_b_pow,
                    newton_iters, xp):
    xi, eta = _tan_project(ra, dec, crval, xp)
    inv = xp.inv(cd)
    up = inv[0, 0] * xi + inv[0, 1] * eta
    vp = inv[1, 0] * xi + inv[1, 1] * eta
    if sip_a is not None:
        u, v = up, vp
        for _ in range(newton_iters):
            fu = u + _sip_eval(u, v, sip_a, sip_a_pow, xp) - up
            fv = v + _sip_eval(u, v, sip_b, sip_b_pow, xp) - vp
            u = u - fu
            v = v - fv
        up, vp = u, v
    return up + crpix[0], vp + crpix[1]


def tan_pixel_to_world(x: torch.Tensor, y: torch.Tensor, crpix, crval, cd,
                       sip_a=None, sip_a_pow=None, sip_b=None, sip_b_pow=None):
    """(x, y) 1-based pixel tensors -> (ra, dec) degrees, in ``x``'s dtype and device."""
    xp = _TorchNS
    crpix, crval, cd, sip_a, sip_b = _params(xp, x, crpix, crval, cd, sip_a, sip_b)
    sip_a_pow, sip_b_pow = [None if p is None else torch.as_tensor(np.asarray(p), device=x.device)
                            for p in (sip_a_pow, sip_b_pow)]
    return _pixel_to_world(x, y, crpix, crval, cd, sip_a, sip_a_pow, sip_b, sip_b_pow, xp)


def tan_world_to_pixel(ra: torch.Tensor, dec: torch.Tensor, crpix, crval, cd,
                       sip_a=None, sip_a_pow=None, sip_b=None, sip_b_pow=None,
                       newton_iters: int = 3):
    """(ra, dec) degree tensors -> (x, y) 1-based pixels, in ``ra``'s dtype and device.

    SIP inversion uses fixed-count Newton iterations on the forward
    polynomial, as the reference does.
    """
    xp = _TorchNS
    crpix, crval, cd, sip_a, sip_b = _params(xp, ra, crpix, crval, cd, sip_a, sip_b)
    sip_a_pow, sip_b_pow = [None if p is None else torch.as_tensor(np.asarray(p), device=ra.device)
                            for p in (sip_a_pow, sip_b_pow)]
    return _world_to_pixel(ra, dec, crpix, crval, cd, sip_a, sip_a_pow, sip_b, sip_b_pow,
                           newton_iters, xp)


@dataclass
class TanWCS:
    """A TAN(+SIP) world coordinate system (host, numpy float64)."""

    crpix: np.ndarray                 #: (2,) reference pixel, 1-based (x, y)
    crval: np.ndarray                 #: (2,) reference (ra, dec) in degrees
    cd: np.ndarray                    #: (2,2) CD matrix, degrees/pixel
    sip_a: Optional[np.ndarray] = None      #: packed A coefficients
    sip_a_pow: Optional[np.ndarray] = None  #: (n,2) powers (p,q) for A
    sip_b: Optional[np.ndarray] = None
    sip_b_pow: Optional[np.ndarray] = None
    sip_order: int = 0

    def __post_init__(self):
        self.crpix = np.asarray(self.crpix, dtype=np.float64)
        self.crval = np.asarray(self.crval, dtype=np.float64)
        self.cd = np.asarray(self.cd, dtype=np.float64)

    @classmethod
    def from_any(cls, other) -> "TanWCS":
        """Copy of any object with the TanWCS fields (e.g. the JAX package's)."""
        return cls(**{f.name: getattr(other, f.name) for f in dataclasses.fields(cls)}).copy()

    # -- transforms ----------------------------------------------------------
    def pixel_to_world(self, x, y):
        return _pixel_to_world(np.asarray(x, np.float64), np.asarray(y, np.float64),
                               self.crpix, self.crval, self.cd, self.sip_a,
                               self.sip_a_pow, self.sip_b, self.sip_b_pow, _NumpyNS)

    def world_to_pixel(self, ra, dec):
        return _world_to_pixel(np.asarray(ra, np.float64), np.asarray(dec, np.float64),
                               self.crpix, self.crval, self.cd, self.sip_a,
                               self.sip_a_pow, self.sip_b, self.sip_b_pow, 3, _NumpyNS)

    def radec_of_rowcol(self, row, col):
        """Convenience: 0-based (row, col) -> (ra, dec)."""
        return self.pixel_to_world(np.asarray(col) + 1.0, np.asarray(row) + 1.0)

    def rowcol_of_radec(self, ra, dec):
        """Convenience: (ra, dec) -> 0-based (row, col)."""
        x, y = self.world_to_pixel(ra, dec)
        return y - 1.0, x - 1.0

    @property
    def pixel_scale(self) -> float:
        """Approximate pixel scale in arcsec/pixel."""
        return float(np.sqrt(np.abs(np.linalg.det(self.cd))) * 3600.0)

    def shifted(self, drow: float = 0.0, dcol: float = 0.0) -> "TanWCS":
        """The same sky solution on a cropped/translated pixel grid where
        new (row, col) = old (row, col) - (drow, dcol).

        A pure CRPIX shift: SIP u/v are CRPIX-relative, so the distortion
        coefficients carry over unchanged.  Converts the raw-frame WCS of
        flight FFIs (columns 1..2136 incl. overscan) into the science-area
        frame (io/tess.read_ffi).
        """
        return dataclasses.replace(
            self, crpix=self.crpix - np.array([dcol, drow], np.float64))

    # -- header round-trip -----------------------------------------------------
    @classmethod
    def from_header(cls, hdr) -> "TanWCS":
        """Parse from a FITS header (mapping-like; io.fits.Header or dict)."""
        get = hdr.get if hasattr(hdr, "get") else hdr.__getitem__
        crpix = np.array([float(get("CRPIX1", 0.0)), float(get("CRPIX2", 0.0))])
        crval = np.array([float(get("CRVAL1", 0.0)), float(get("CRVAL2", 0.0))])
        if get("CD1_1", None) is not None:
            cd = np.array([[float(get("CD1_1")), float(get("CD1_2", 0.0) or 0.0)],
                           [float(get("CD2_1", 0.0) or 0.0), float(get("CD2_2"))]])
        else:
            cdelt = np.array([float(get("CDELT1", 1.0)), float(get("CDELT2", 1.0))])
            pc = np.array([[float(get("PC1_1", 1.0)), float(get("PC1_2", 0.0))],
                           [float(get("PC2_1", 0.0)), float(get("PC2_2", 1.0))]])
            cd = pc * cdelt[:, None]
        sip_a = sip_a_pow = sip_b = sip_b_pow = None
        order = int(get("A_ORDER", 0) or 0)
        if order:
            a_c, a_p, b_c, b_p = [], [], [], []
            for p in range(order + 1):
                for q in range(order + 1 - p):
                    if p + q < 1:
                        continue
                    av = get(f"A_{p}_{q}", None)
                    bv = get(f"B_{p}_{q}", None)
                    if av:
                        a_c.append(float(av))
                        a_p.append((p, q))
                    if bv:
                        b_c.append(float(bv))
                        b_p.append((p, q))
            if a_c:
                sip_a, sip_a_pow = np.array(a_c), np.array(a_p, dtype=np.int32)
            if b_c:
                sip_b, sip_b_pow = np.array(b_c), np.array(b_p, dtype=np.int32)
            # One-sided SIP keeps a zero polynomial on the other axis, with
            # the reference's placeholder powers:
            if sip_a is None or sip_b is None:
                if sip_a is None:
                    sip_a, sip_a_pow = np.zeros(1), np.array([[1, 1]], np.int32)
                if sip_b is None:
                    sip_b, sip_b_pow = np.zeros(1), np.array([[1, 1]], np.int32)
        return cls(crpix=crpix, crval=crval, cd=cd, sip_a=sip_a, sip_a_pow=sip_a_pow,
                   sip_b=sip_b, sip_b_pow=sip_b_pow, sip_order=order)

    def to_header(self, hdr=None):
        """Write WCS keywords into a header (io.fits.Header or dict)."""
        if hdr is None:
            from .fits import Header
            hdr = Header()
        setter = hdr.set if hasattr(hdr, "set") else hdr.__setitem__
        suffix = "-SIP" if self.sip_a is not None else ""
        setter("CTYPE1", "RA---TAN" + suffix)
        setter("CTYPE2", "DEC--TAN" + suffix)
        setter("CRPIX1", float(self.crpix[0]))
        setter("CRPIX2", float(self.crpix[1]))
        setter("CRVAL1", float(self.crval[0]))
        setter("CRVAL2", float(self.crval[1]))
        setter("CD1_1", float(self.cd[0, 0]))
        setter("CD1_2", float(self.cd[0, 1]))
        setter("CD2_1", float(self.cd[1, 0]))
        setter("CD2_2", float(self.cd[1, 1]))
        if self.sip_a is not None:
            order = int(self.sip_order or max(self.sip_a_pow.sum(axis=1).max(),
                                              self.sip_b_pow.sum(axis=1).max()))
            setter("A_ORDER", order)
            setter("B_ORDER", order)
            for c, (p, q) in zip(self.sip_a, self.sip_a_pow):
                setter(f"A_{p}_{q}", float(c))
            for c, (p, q) in zip(self.sip_b, self.sip_b_pow):
                setter(f"B_{p}_{q}", float(c))
        return hdr

    def copy(self) -> "TanWCS":
        def cp(a):
            return None if a is None else np.array(a, copy=True)
        return TanWCS(cp(self.crpix), cp(self.crval), cp(self.cd), cp(self.sip_a),
                      cp(self.sip_a_pow), cp(self.sip_b), cp(self.sip_b_pow),
                      self.sip_order)


def fit_tan_wcs(x, y, ra, dec, crpix=None) -> TanWCS:
    """Fit a linear TAN WCS to matched (pixel, sky) points (>= 4).

    Counterpart of astropy's ``fit_wcs_from_points``.  A gnomonic projection
    composed with an affine pixel map sends homogeneous pixel coordinates
    to sky directions linearly, ``u ∝ M @ (x, y, 1)`` with ``M = R_crval @ K``
    and K's last row (0, 0, 1): M comes from a direct linear transform, the
    tangent point from the third row of ``M^-1``, then the exact affine
    (CD and a CRPIX shift) about it by least squares.  Exact on noise-free
    TAN data.
    """
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    ra = np.asarray(ra, np.float64)
    dec = np.asarray(dec, np.float64)
    if x.size < 4:
        raise ValueError("Need at least 4 points to fit a TAN WCS "
                         "(the 9-parameter DLT is underdetermined below 4: "
                         "3 points return an arbitrary nullspace vector)")
    if crpix is None:
        crpix = np.array([np.mean(x), np.mean(y)])
    crpix = np.asarray(crpix, np.float64)

    # Normalised homogeneous pixel coordinates (conditioning):
    sx = max(np.std(x), 1.0)
    sy = max(np.std(y), 1.0)
    hx = (x - crpix[0]) / sx
    hy = (y - crpix[1]) / sy
    H = np.stack([hx, hy, np.ones_like(hx)], axis=1)          # (N, 3)
    rr, dd = np.deg2rad(ra), np.deg2rad(dec)
    V = np.stack([np.cos(dd) * np.cos(rr), np.cos(dd) * np.sin(rr), np.sin(dd)], axis=1)

    # DLT: v x (M h) = 0, one row block per component pair.
    n = len(x)
    C = np.zeros((3 * n, 9))
    for k in range(3):
        i, j = (k + 1) % 3, (k + 2) % 3
        C[k::3, 3 * j:3 * j + 3] = V[:, i:i + 1] * H
        C[k::3, 3 * i:3 * i + 3] = -V[:, j:j + 1] * H
    _, _, vt = np.linalg.svd(C, full_matrices=False)
    M = vt[-1].reshape(3, 3)
    if np.sum(np.einsum("nk,nk->n", V, H @ M.T)) < 0:      # M h along v, not -v
        M = -M

    # Tangent point = direction of the third row of M^-1:
    p = np.linalg.inv(M)[2]
    p /= np.linalg.norm(p)
    if np.dot(p, V.mean(axis=0)) < 0:
        p = -p
    crval = np.array([np.rad2deg(np.arctan2(p[1], p[0])) % 360.0,
                      np.rad2deg(np.arcsin(np.clip(p[2], -1, 1)))])

    # Exact affine about the recovered tangent point:
    xi, eta = _tan_project(ra, dec, crval, _NumpyNS)
    A = np.stack([x - crpix[0], y - crpix[1], np.ones_like(x)], axis=1)
    cx, *_ = np.linalg.lstsq(A, np.asarray(xi), rcond=None)
    cy, *_ = np.linalg.lstsq(A, np.asarray(eta), rcond=None)
    cd = np.array([[cx[0], cx[1]], [cy[0], cy[1]]])
    # Fold the constant terms into CRPIX (xi = CD (p - crpix_new)):
    shift = np.linalg.solve(cd, np.array([cx[2], cy[2]]))
    return TanWCS(crpix=crpix - shift, crval=crval, cd=cd)
