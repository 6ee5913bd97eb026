"""Plain reference of nonlinear PSF photometry: one target's stars fitted at
every cadence in float64, from the configuration's own PRF density.

Nothing here imports the program, JAX or scipy; the configuration's
``prf`` block is the only input that says what the PRF is, so a table
written wrong, or read wrong by the program, shows in the check.  The
fit follows the reference pipeline's ``psf_photometry.py`` (TASOC) and
departs from it where stated:

* **the PRF**: the stated density (a sum of axis-aligned Gaussians) sampled
  on the stated grid (``oversample`` points a pixel, ``samples`` an axis)
  and normalised to unit sum times the sample area, as ``psf.py``
  normalises a SPOC table; each pixel takes the exact integral over the
  pixel, at the star's offset, of the samples' interpolating cubic
  B-spline (``psf.py`` wraps the table in a bicubic spline and integrates
  it over each pixel).  No SVD, no Catmull-Rom, no box filter.  A pixel
  whose centre lies ``CUTOFF_RADIUS`` px or more from a star gets none of
  its light (``psf.py``'s cutoff radius);
* **the stars**: at most 5, the nearest catalog stars within 5 px of the
  target and not more than 5 mag fainter than it, the target always among
  them (``psf_photometry.py:117-129``);
* **the fit**: Gaussian_d weights 1 / (|image + background| + the
  read-noise variance) on the pixels whose image is finite, a background
  that is not finite counting as zero (as in FLUX_BKG's sum), then damped Gauss-Newton steps (``LAMBDA`` times the diagonal)
  with the Jacobian by forward-mode autograd, until no star moves by more
  than ``POS_TOL`` px and no flux by more than ``FLUX_TOL`` of itself, at
  most ``MAX_ITERS`` steps; fluxes held at >= 0 (the reference's prior).
  ``psf_photometry.py`` minimises the likelihood by Nelder-Mead, 1,500 and
  500 evaluations;
* **the start**: the first cadence from the catalog's positions and
  fluxes, every cadence from the first cadence's solution
  (``psf_photometry.py`` starts each cadence from the one before);
* **the outputs**: FLUX_RAW, the target's fitted flux plus the residual
  (image less the model of every fitted star) summed over the minimum
  aperture's finite pixels (the MOMF correction, ``psf_photometry.py:
  168-171``); FLUX_RAW_ERR from the covariance inv(J^T W J) at the
  solution (``psf_photometry.py`` leaves it NaN).  Float64 throughout,
  with TF32 off.
"""

import numpy as np
import torch

ZERO_POINT = 20.451              #: Tmag of 1 e-/s
MAX_STARS, FIT_RADIUS, DMAG_LIMIT, CUTOFF_RADIUS = 5, 5.0, -5.0, 5.0
LAMBDA = 1e-3                    #: damping, a share of the normal matrix's diagonal
POS_TOL, FLUX_TOL, MAX_ITERS = 1e-8, 1e-10, 100


class float64_only:
    """TF32 off for matrix products and convolutions while open."""

    def __enter__(self):
        self.was = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.was


def density(prf: dict) -> np.ndarray:
    """The ``prf`` block's density on its grid, normalised: (samples, samples),
    rows the first axis; ``prf["terms"]`` holds (weight, sigma_row,
    sigma_col) in pixels."""
    offs = nodes(prf)
    g = sum(a * np.exp(-0.5 * (offs[:, None] / sr) ** 2 - 0.5 * (offs[None, :] / sc) ** 2)
            for a, sr, sc in prf["terms"])
    return g / (g.sum() / prf["oversample"] ** 2)


def nodes(prf: dict) -> np.ndarray:
    """Offsets in pixels of the grid's samples from the star, one axis."""
    n = prf["samples"]
    return (np.arange(n) - (n - 1) / 2) / prf["oversample"]


def _bspline_integral(t):
    """The integral of the centred cubic B-spline from -inf to ``t``."""
    u = -torch.abs(t)                          # the left half, then mirrored
    left = torch.where(u <= -1.0, (2.0 + u).clamp(min=0.0) ** 4 / 24.0,
                       1.0 / 24.0 + (4 * u - 2 * u ** 3 - 0.75 * u ** 4) / 6.0 + 2.75 / 6.0)
    return torch.where(t <= 0, left, 1.0 - left)


class SplinePRF:
    """The density's interpolating cubic B-spline (coefficients zero past
    the grid's ends) and its exact pixel integrals, on ``device``."""

    def __init__(self, prf: dict, device):
        g = torch.as_tensor(density(prf), dtype=torch.float64, device=device)
        n = g.shape[0]
        A = (torch.diag(torch.full((n,), 4.0, dtype=torch.float64))
             + torch.diag(torch.ones(n - 1, dtype=torch.float64), 1)
             + torch.diag(torch.ones(n - 1, dtype=torch.float64), -1)).to(device) / 6.0
        coef = torch.linalg.solve(A, g)                       # rows
        self.coef = torch.linalg.solve(A, coef.T).T           # then columns
        self.x = torch.as_tensor(nodes(prf), dtype=torch.float64, device=device)
        self.h = 1.0 / prf["oversample"]

    def axis(self, pix, pos):
        """(..., n_pix, samples): each pixel's integral of each B-spline term
        for stars at ``pos`` (...,), pixels ``pix`` (n_pix,) of one axis."""
        lo = (pix[:, None] - 0.5 - pos[..., None, None] - self.x) / self.h
        return self.h * (_bspline_integral(lo + 1.0 / self.h) - _bspline_integral(lo))

    def render(self, p, shape):
        """(..., h, w) image of the stars p (..., 3S) = [rows, cols, fluxes]."""
        h, w = shape
        S = p.shape[-1] // 3
        rows, cols, flux = p[..., :S], p[..., S:2 * S], p[..., 2 * S:]
        pr = torch.arange(h, dtype=torch.float64, device=p.device)
        pc = torch.arange(w, dtype=torch.float64, device=p.device)
        iy, ix = self.axis(pr, rows), self.axis(pc, cols)    # (..., S, h|w, n)
        img = iy @ self.coef @ ix.transpose(-1, -2)            # (..., S, h, w)
        cut = ((pr[:, None] - rows[..., None, None]) ** 2
               + (pc[None, :] - cols[..., None, None]) ** 2) < CUTOFF_RADIUS ** 2
        return (torch.where(cut, img, 0.0) * flux[..., None, None]).sum(dim=-3)


def select_stars(k: int, rows, cols, tmag) -> np.ndarray:
    """Indices of the stars fitted for target ``k`` (catalog arrays), the
    nearest first."""
    dist = np.hypot(rows - rows[k], cols - cols[k])
    idx = np.where((dist < FIT_RADIUS) & (tmag[k] - tmag > DMAG_LIMIT))[0]
    idx = idx[np.argsort(dist[idx], kind="stable")][:MAX_STARS]
    if k not in idx:
        idx = np.concatenate([[k], idx])[:MAX_STARS]
    return idx


def mag2flux(tmag):
    return 10 ** (-0.4 * (np.asarray(tmag, np.float64) - ZERO_POINT))


def _model_and_jacobian(spline, p, shape):
    """Model (..., h*w) and its Jacobian (..., h*w, 3S) at p, column by
    column by forward-mode autograd."""
    h, w = shape
    f = lambda q: spline.render(q, shape).reshape(*q.shape[:-1], h * w)  # noqa: E731
    cols, mdl = [], None
    for k in range(p.shape[-1]):
        tangent = torch.zeros_like(p)
        tangent[..., k] = 1.0
        mdl, col = torch.func.jvp(f, (p,), (tangent,))
        cols.append(col)
    return mdl, torch.stack(cols, dim=-1)


def _gauss_newton(spline, img, wgt, p, shape):
    """Damped Gauss-Newton from p (..., 3S) to convergence; returns the
    solution, the model there, the normal matrix there and the steps taken."""
    S = p.shape[-1] // 3
    for it in range(1, MAX_ITERS + 1):
        mdl, J = _model_and_jacobian(spline, p, shape)
        JtW = J.transpose(-1, -2) * wgt[..., None, :]
        A = JtW @ J
        g = (JtW @ (img - mdl)[..., None])[..., 0]
        # solved on the diagonal's scale: positions and fluxes differ by ~F
        d = torch.diagonal(A, dim1=-2, dim2=-1).clamp(min=1e-300).rsqrt()
        scaled = A * d[..., :, None] * d[..., None, :]
        step = torch.linalg.solve(scaled + LAMBDA * torch.diag_embed(
            torch.diagonal(scaled, dim1=-2, dim2=-1)), (g * d)[..., None])[..., 0] * d
        new = p + step
        new = torch.cat([new[..., :2 * S], new[..., 2 * S:].clamp(min=0.0)], dim=-1)
        step = (new - p).abs()
        p = new
        if (step[..., :2 * S].max() <= POS_TOL
                and bool((step[..., 2 * S:] <= FLUX_TOL * p[..., 2 * S:].abs().clamp(min=1.0))
                         .all())):
            break
    mdl, J = _model_and_jacobian(spline, p, shape)
    JtW = J.transpose(-1, -2) * wgt[..., None, :]
    return p, mdl, JtW @ J, it


def fit(spline, images, backgrounds, var_const, rows0, cols0, flux0, target, mini):
    """The fit of B targets' stamps at T cadences.

    images, backgrounds: (B, T, h, w) tensors (float64 on the spline's
    device); rows0, cols0, flux0: (B, S) catalog start in stamp coords;
    target: the target's index among the S stars; mini: (B, h, w) bool, the
    minimum aperture.  Returns FLUX_RAW and FLUX_RAW_ERR (B, T) as numpy
    arrays and the most steps either phase took."""
    B, T, h, w = images.shape
    S = rows0.shape[1]
    good = torch.isfinite(images)
    img = torch.where(good, images, 0.0).reshape(B, T, h * w)
    bkg = torch.where(torch.isfinite(backgrounds), backgrounds, 0.0)
    var = torch.where(good, (images + bkg).abs() + var_const, 1.0)
    wgt = torch.where(good, 1.0 / var.clamp(min=1e-9), 0.0).reshape(B, T, h * w)
    dev = images.device
    p0 = torch.as_tensor(np.concatenate([rows0, cols0, flux0], axis=1), dtype=torch.float64,
                         device=dev)
    first, _, _, it1 = _gauss_newton(spline, img[:, 0], wgt[:, 0], p0, (h, w))
    p, mdl, A, it2 = _gauss_newton(spline, img, wgt, first[:, None].expand(B, T, 3 * S)
                                   .contiguous(), (h, w))
    keep = (torch.as_tensor(mini, device=dev)[:, None] & good).reshape(B, T, h * w)
    resid = torch.where(keep, img - mdl, 0.0).sum(dim=-1)
    k = 2 * S + target
    flux = p[..., k] + resid
    cov = torch.linalg.inv(A)
    err = torch.sqrt(cov[..., k, k].clamp(min=0.0))
    return flux.cpu().numpy(), err.cpu().numpy(), max(it1, it2)


def minimum_aperture(shape, row: float, col: float) -> np.ndarray:
    """The pixels within one of the target's position on both axes
    (``photometry.py:31-41``)."""
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    return (np.abs(xx - col) <= 1) & (np.abs(yy - row) <= 1)
