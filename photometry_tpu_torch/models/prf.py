"""
TESS Pixel Response Function (PRF) model, on torch tensors.

Port of ``photometry_tpu/models/prf.py`` (reference photometry/psf.py): the
MATLAB ``*-characterized-prf.mat`` loader with its inverse-distance
combination of sub-PRFs, the box-filtered pixel-integrated table, the
analytic integrated-Gaussian PRF, and the renders the PSF fit uses.

The table build runs on the host in numpy and is identical to the JAX
package's (the same SVD of the same float32 table).  Evaluation runs on
``self.device``:

- the analytic Gaussian with ``torch.special.erf``;
- a grid-separable table (integer oversample) as K SVD terms, each axis a
  Catmull-Rom interpolation of the zero-padded factor table by plain
  indexing, ``vals[i] = sum_j wb[j] Fz[clip(b) - b_lo + i*os + j]``.  The
  JAX package folds the table by phase and selects rows with one-hot
  matmuls only because gathers serialize on a TPU (its prf.py:257-265); on
  the card a gather is the natural form;
- any other table with ``ops.spline.bicubic_eval``.

Every render takes leading batch dimensions: parameters (..., S, 3) give
images (..., h, w), so a batch of PSF instances is one call.
"""

from __future__ import annotations

import glob
import os
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..ops.spline import CRM, bicubic_eval

__all__ = ["PRF", "prf_from_jax"]


class PRF:
    """Pixel Response Function for one stamp on one camera/CCD."""

    def __init__(self, iprf: np.ndarray, oversample: float, center_x: float,
                 center_y: float, info: Optional[dict] = None, device="cuda"):
        """Low-level constructor; use :meth:`from_mat`, :meth:`gaussian` or
        :func:`prf_from_jax`.

        Parameters:
            iprf: 2-D table of the pixel-integrated PRF (fraction of flux in
                a 1x1 pixel whose centre is offset (dx, dy) from the star).
            oversample: table samples per pixel.
            center_x, center_y: table indices of zero offset.
            device: where the tables live and renders run.
        """
        self.iprf = np.asarray(iprf, np.float32)
        self.oversample = float(oversample)
        self.center_x = float(center_x)
        self.center_y = float(center_y)
        self.info = info or {}
        self.device = resolve_device(device)
        self._iprf_dev = torch.as_tensor(self.iprf, device=self.device)

    # ------------------------------------------------------------------ build
    @staticmethod
    def _integrate_prf_grid(prf: np.ndarray, prf_x: np.ndarray, prf_y: np.ndarray):
        """Box-filter the oversampled PRF into the pixel-integrated table."""
        from scipy.ndimage import uniform_filter
        dx = float(np.median(np.diff(prf_x)))
        dy = float(np.median(np.diff(prf_y)))
        if abs(dx - dy) > 1e-6 * max(abs(dx), abs(dy)):
            # one oversample scales both axes downstream:
            raise ValueError(
                f"Anisotropic PRF sample grid (dx={dx:g}, dy={dy:g}) is not "
                "supported: the evaluation kernels assume one oversample "
                "factor for both axes.")
        nx = max(int(round(1.0 / dx)), 1)
        ny = max(int(round(1.0 / dy)), 1)
        # sum over a 1x1 pixel window = mean * window_size; times sample area:
        iprf = uniform_filter(prf, size=(ny, nx), mode="constant") * (nx * ny) * dx * dy
        cx = float(np.argmin(np.abs(prf_x)))
        cy = float(np.argmin(np.abs(prf_y)))
        return iprf, 1.0 / dx, cx, cy

    @classmethod
    def from_mat(cls, path_or_dir: str, sector: int, camera: int, ccd: int,
                 stamp, device="cuda") -> "PRF":
        """Load a calibrated TESS PRF from MATLAB files.

        ``path_or_dir`` may be a directory laid out like the reference's
        ``data/psf`` (subdirs ``start_s0001`` / ``start_s0004``) or a direct
        path to one ``.mat`` file.
        """
        from scipy.io import loadmat
        if sector < 1:
            raise ValueError("Sector number must be greater than zero")
        if camera not in (1, 2, 3, 4) or ccd not in (1, 2, 3, 4):
            raise ValueError("Camera and CCD must be 1-4.")
        if os.path.isdir(path_or_dir):
            subdir = "start_s0004" if sector >= 4 else "start_s0001"
            pattern = os.path.join(path_or_dir, subdir,
                                   f"tess*-{camera:d}-{ccd:d}-characterized-prf.mat")
            files = glob.glob(pattern)
            if not files:
                raise FileNotFoundError(f"No PRF file matching {pattern}")
            path = files[0]
        else:
            path = path_or_dir

        mat = loadmat(path)["prfStruct"]
        prf_x = np.asarray(mat["prfColumn"][0][0], np.float64).ravel()
        prf_y = np.asarray(mat["prfRow"][0][0], np.float64).ravel()
        dx = float(np.median(np.diff(prf_x)))
        dy = float(np.median(np.diff(prf_y)))

        ref_column = 0.5 * (stamp[3] + stamp[2])
        ref_row = 0.5 * (stamp[1] + stamp[0])
        minimum_prf_weight = 1e-6
        prf = np.zeros((len(prf_y), len(prf_x)), np.float64)
        for i in range(len(mat["values"][0])):
            sub = np.asarray(mat["values"][0][i], np.float64)
            crval1p = float(np.squeeze(mat["ccdColumn"][0][i]))
            crval2p = float(np.squeeze(mat["ccdRow"][0][i]))
            w = max(np.hypot(ref_column - crval1p, ref_row - crval2p), minimum_prf_weight)
            prf += sub / w
        prf /= np.nansum(prf) * dx * dy

        iprf, oversample, cx, cy = cls._integrate_prf_grid(prf, prf_x, prf_y)
        return cls(iprf, oversample, cx, cy,
                   info={"file": path, "sector": sector, "camera": camera,
                         "ccd": ccd, "ref_column": ref_column, "ref_row": ref_row},
                   device=device)

    @classmethod
    def gaussian(cls, sigma: float = 1.1, oversample: int = 9,
                 radius: float = 8.0, device="cuda") -> "PRF":
        """Analytic integrated-Gaussian PRF (exact, no box-filter needed)."""
        from scipy.special import erf
        n = int(radius * oversample)
        offs = np.arange(-n, n + 1) / oversample
        d = np.sqrt(2) * sigma
        ex = erf((offs + 0.5) / d) - erf((offs - 0.5) / d)
        iprf = 0.25 * ex[:, None] * ex[None, :]
        return cls(iprf, oversample, n, n, info={"sigma": sigma}, device=device)

    @classmethod
    def write_mat(cls, path: str, prf_grids: list, ccd_columns, ccd_rows,
                  oversample: int = 9, radius: float = 8.0):
        """Write a TESS-layout .mat PRF file: a 1xN struct array, one element
        per sub-PRF position, which is what :meth:`from_mat` reads."""
        from scipy.io import savemat
        n = int(radius * oversample)
        coords = (np.arange(-n, n + 1) / oversample).reshape(-1, 1)
        dt = [("prfColumn", "O"), ("prfRow", "O"), ("values", "O"),
              ("ccdColumn", "O"), ("ccdRow", "O")]
        arr = np.zeros((1, len(prf_grids)), dtype=dt)
        for i, g in enumerate(prf_grids):
            arr[0, i] = (coords, coords, np.asarray(g, np.float64),
                         float(ccd_columns[i]), float(ccd_rows[i]))
        savemat(path, {"prfStruct": arr})

    # --------------------------------------------------------------- evaluate
    def _f32(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def pixel_fraction(self, drow, dcol) -> torch.Tensor:
        """Fraction of a star's flux landing in a pixel offset (drow, dcol),
        for broadcastable shapes (reference psf.py:143-146)."""
        sigma = self.info.get("sigma")
        if sigma is not None:
            d = np.float32(np.sqrt(2.0) * sigma)
            dy, dx = self._f32(drow), self._f32(dcol)
            erf = torch.special.erf
            return 0.25 * (erf((dy + 0.5) / d) - erf((dy - 0.5) / d)) * (
                erf((dx + 0.5) / d) - erf((dx - 0.5) / d))
        y = self._f32(drow) * self.oversample + self.center_y
        x = self._f32(dcol) * self.oversample + self.center_x
        H, W = self.iprf.shape
        inside = (y >= 0) & (y <= H - 1) & (x >= 0) & (x <= W - 1)
        val = bicubic_eval(self._iprf_dev, torch.clamp(y, 0, H - 1), torch.clamp(x, 0, W - 1))
        return torch.where(inside, val, torch.zeros((), device=self.device))

    def pixel_fraction_grads(self, drow, dcol):
        """(q, dq/ddrow, dq/ddcol) of the analytic-Gaussian PRF, closed form."""
        sigma = self.info.get("sigma")
        if sigma is None:
            raise NotImplementedError("analytic grads need a Gaussian PRF")
        d = np.float32(np.sqrt(2.0) * sigma)
        c = np.float32(2.0 / (np.sqrt(np.pi)) / (np.sqrt(2.0) * sigma))
        dy, dx = self._f32(drow), self._f32(dcol)
        erf = torch.special.erf
        ey = erf((dy + 0.5) / d) - erf((dy - 0.5) / d)
        ex = erf((dx + 0.5) / d) - erf((dx - 0.5) / d)
        gy = c * (torch.exp(-((dy + 0.5) / d) ** 2) - torch.exp(-((dy - 0.5) / d) ** 2))
        gx = c * (torch.exp(-((dx + 0.5) / d) ** 2) - torch.exp(-((dx - 0.5) / d) ** 2))
        return 0.25 * ey * ex, 0.25 * gy * ex, 0.25 * ey * gx

    def _svd_factors(self):
        """Cached separable factorisation iprf ~ sum_k U[:, k] V[:, k]^T, as
        host float32 arrays (L0, K): the K <= 24 singular terms above
        1e-5 of the largest."""
        if not hasattr(self, "_svd_cache"):
            u, s, vt = np.linalg.svd(self.iprf, full_matrices=False)
            k = min(max(int(np.sum(s > 1e-5 * s[0])), 1), 24)
            self._svd_cache = ((u[:, :k] * s[:k]).astype(np.float32),
                               vt[:k].T.astype(np.float32))
        return self._svd_cache

    def _axis_folded_table(self, F, n: int):
        """``(b_lo, b_hi, Fz)``: the zero-padded factor table of one axis
        for ``n`` queries, ``Fz[m - b_lo] = F[m]``, (Lz, K) float32 on host.

        The base row ``b`` of a query is clamped to ``[b_lo, b_hi]``, which
        covers every row ``b + i*os + j`` reachable while any query is in
        the table's domain; fully out-of-domain rows are zeroed by the
        validity mask.  The JAX package folds this table by phase for its
        one-hot matmuls; here (and in ``ops/csrc/psf_warm_fit.cu``) it is
        indexed directly.  Cached per (factor, n).
        """
        cache = self.__dict__.setdefault("_axis_cache", {})
        key = (id(F), n)
        hit = cache.get(key)
        if hit is None or hit[0] is not F:
            os_ = int(round(self.oversample))
            Fh = np.asarray(F, np.float32)
            L0, K = Fh.shape
            b_lo = -(n - 1) * os_ - 1
            b_hi = L0 - 2
            # the same row budget as the JAX package's fold (Lm * os + 3):
            Lm = ((b_hi - b_lo) + (n - 1) * os_ + 4 + os_ - 1) // os_ + 1
            Fz = np.zeros((Lm * os_ + 3, K), np.float32)
            Fz[-b_lo:-b_lo + L0] = Fh
            hit = cache[key] = (F, (b_lo, b_hi, Fz))
        return hit[1]

    def _axis_table_dev(self, F, n: int):
        b_lo, b_hi, Fz = self._axis_folded_table(F, n)
        cache = self.__dict__.setdefault("_axis_dev_cache", {})
        key = (id(Fz), n)
        if key not in cache:
            cache[key] = (Fz, torch.as_tensor(Fz, device=self.device))
        return b_lo, b_hi, cache[key][1]

    def _axis_values(self, F, center: float, coord, n: int, with_grad: bool = False):
        """Catmull-Rom interpolation of the (L0, K) factor table at the
        queries ``y_i = (i - coord) * os + center``, ``i < n``.

        ``coord`` has any shape (...); returns vals (..., n, K) and, with
        ``with_grad``, d(vals)/d(coord) from the derivative basis weights
        times the ``-os`` chain factor (Catmull-Rom is C^1).
        """
        os_ = int(round(self.oversample))
        L0 = F.shape[0]
        b_lo, b_hi, Fz = self._axis_table_dev(F, n)
        coord = self._f32(coord)
        y0 = (0.0 - coord) * os_ + center
        fl = torch.floor(y0)
        b = fl.to(torch.int64) - 1
        t = y0 - fl
        idx = torch.clamp(b, b_lo, b_hi) - b_lo                       # (...)
        rows = (idx[..., None, None] + os_ * torch.arange(n, device=self.device)[:, None]
                + torch.arange(4, device=self.device))                 # (..., n, 4)
        taps = Fz[rows]                                                # (..., n, 4, K)
        crm = torch.as_tensor(CRM, device=self.device)
        one = torch.ones_like(t)
        wb = torch.stack([one, t, t * t, t * t * t], dim=-1) @ crm      # (..., 4)
        vals = torch.einsum("...j,...njk->...nk", wb, taps)
        y_i = y0[..., None] + os_ * torch.arange(n, device=self.device, dtype=torch.float32)
        valid = ((y_i >= 0) & (y_i <= L0 - 1))[..., None]             # (..., n, 1)
        zero = torch.zeros((), device=self.device)
        vals = torch.where(valid, vals, zero)
        if not with_grad:
            return vals
        dwb = torch.stack([torch.zeros_like(t), one, 2 * t, 3 * t * t], dim=-1) @ crm
        dvals = torch.einsum("...j,...njk->...nk", dwb, taps) * np.float32(-os_)
        return vals, torch.where(valid, dvals, zero)

    def _cutoff_mask(self, rows, cols, shape, cutoff_radius):
        """(..., h, w) bool: pixel within ``cutoff_radius`` of the star."""
        h, w = shape
        rr = torch.arange(h, dtype=torch.float32, device=self.device)[:, None] - rows[..., None, None]
        cc = torch.arange(w, dtype=torch.float32, device=self.device)[None, :] - cols[..., None, None]
        return rr * rr + cc * cc < cutoff_radius ** 2

    def render_separable_with_grads(self, rows, cols, shape, cutoff_radius):
        """Per-star unit-flux table renders and their position derivatives.

        ``rows``/``cols`` (..., S) -> ``(q, q_row, q_col)``, each (..., S, h, w),
        closed form from the Catmull-Rom derivative weights.
        """
        U, V = self._svd_factors()
        h, w = shape
        rows, cols = self._f32(rows), self._f32(cols)
        u, du = self._axis_values(U, self.center_y, rows, h, with_grad=True)
        v, dv = self._axis_values(V, self.center_x, cols, w, with_grad=True)
        q = torch.einsum("...hk,...wk->...hw", u, v)
        qr = torch.einsum("...hk,...wk->...hw", du, v)
        qc = torch.einsum("...hk,...wk->...hw", u, dv)
        if cutoff_radius is not None:
            cut = self._cutoff_mask(rows, cols, shape, cutoff_radius)
            zero = torch.zeros((), device=self.device)
            q, qr, qc = (torch.where(cut, x, zero) for x in (q, qr, qc))
        return q, qr, qc

    def _render_separable(self, params, shape, cutoff_radius):
        """(..., S, 3) stars -> (..., h, w) via the SVD-separable table render."""
        U, V = self._svd_factors()
        h, w = shape
        u = self._axis_values(U, self.center_y, params[..., 0], h)      # (..., S, h, K)
        v = self._axis_values(V, self.center_x, params[..., 1], w)
        img = torch.einsum("...hk,...wk->...hw", u, v)
        if cutoff_radius is not None:
            cut = self._cutoff_mask(params[..., 0], params[..., 1], shape, cutoff_radius)
            img = torch.where(cut, img, torch.zeros((), device=self.device))
        return torch.sum(img * params[..., 2, None, None], dim=-3)

    @property
    def _grid_separable(self) -> bool:
        return (self.info.get("sigma") is None
                and abs(self.oversample - round(self.oversample)) < 1e-9)

    @property
    def has_analytic_grads(self) -> bool:
        """True when :meth:`pixel_fraction_grads` has a closed form (the
        analytic-Gaussian PRF); table PRFs differentiate otherwise."""
        return self.info.get("sigma") is not None

    def _pixel_offsets(self, rows, cols, shape):
        h, w = shape
        rr = torch.arange(h, dtype=torch.float32, device=self.device)[:, None, None]
        cc = torch.arange(w, dtype=torch.float32, device=self.device)[None, :, None]
        return rr - rows[..., None, None, :], cc - cols[..., None, None, :]   # (..., h, w, S)

    def integrate_to_image(self, params, shape, cutoff_radius: Optional[float] = 5.0):
        """Render stars onto a pixel grid.

        Parameters:
            params: (..., S, 3) (row, column, flux) per star.
            shape: (h, w) of the output image.
            cutoff_radius: zero contribution beyond this distance (pixels).

        Returns:
            (..., h, w) model images.
        """
        params = self._f32(params)
        if params.ndim == 1:
            params = params[None]
        if self._grid_separable:
            return self._render_separable(params, shape, cutoff_radius)
        drow, dcol = self._pixel_offsets(params[..., 0], params[..., 1], shape)
        frac = self.pixel_fraction(drow, dcol)
        if cutoff_radius is not None:
            frac = torch.where(drow ** 2 + dcol ** 2 < cutoff_radius ** 2, frac,
                               torch.zeros((), device=self.device))
        return torch.sum(frac * params[..., None, None, :, 2], dim=-1)

    def render_batch(self, params_batch, shape, cutoff_radius: Optional[float] = 5.0):
        """(B, S, 3) star parameters -> (B, h, w) model images."""
        return self.integrate_to_image(params_batch, shape, cutoff_radius)

    def design_matrix(self, rows, cols, shape, cutoff_radius: Optional[float] = 5.0):
        """Unit-flux PRF per star, flattened: (h*w, S) — the linPSF 'A' matrix."""
        return self.design_matrix_batch(rows, cols, shape, cutoff_radius).T

    def design_matrix_batch(self, rows, cols, shape, cutoff_radius: Optional[float] = 5.0):
        """Unit-flux PRF per star for many frames at once.

        ``rows``/``cols`` (..., S) star positions -> (..., S, h*w): each
        frame's design matrix, transposed (star-major), every element equal
        to :meth:`design_matrix`'s.  The Gaussian route evaluates its erf
        factors per row and per column and multiplies them by broadcasting,
        so it holds no (..., S, h, w) offset grids.
        """
        rows, cols = self._f32(rows), self._f32(cols)
        h, w = shape
        lead = rows.shape
        if self._grid_separable:
            params = torch.stack([rows, cols, torch.ones_like(rows)], dim=-1)[..., None, :]
            img = self._render_separable(params, shape, cutoff_radius)
            return img.reshape(*lead, h * w)
        drow = torch.arange(h, dtype=torch.float32, device=self.device)[:, None] \
            - rows[..., None, None]                                        # (..., S, h, 1)
        dcol = torch.arange(w, dtype=torch.float32, device=self.device)[None, :] \
            - cols[..., None, None]                                        # (..., S, 1, w)
        frac = self.pixel_fraction(drow, dcol)
        if cutoff_radius is not None:
            frac = torch.where(drow ** 2 + dcol ** 2 < cutoff_radius ** 2, frac,
                               torch.zeros((), device=self.device))
        return frac.expand(*lead, h, w).reshape(*lead, h * w)


def prf_from_jax(jax_prf, device) -> PRF:
    """The port's PRF holding the same table as a JAX package ``PRF``
    (``iprf``, ``oversample``, ``center_x``, ``center_y``, ``info``)."""
    return PRF(np.asarray(jax_prf.iprf), jax_prf.oversample, jax_prf.center_x,
               jax_prf.center_y, info=dict(jax_prf.info), device=device)
