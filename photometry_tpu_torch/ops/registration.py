"""
Image registration: ECC alignment by Gauss-Newton, on torch tensors.

Port of ``photometry_tpu/ops/registration.py`` (reference
image_motion.py:236, OpenCV's ``findTransformECC``): both images are
zero-mean / unit-norm normalised over the warped support and the warp
parameters are iterated to maximise their inner product (Evangelidis &
Psarakis 2008, the update OpenCV implements).  Motion models
``translation`` (dx, dy), ``euclidian`` (dx, dy, theta) and ``affine``
(the row-major 2x3 matrix), with the reference's conventions.

What the JAX package ``vmap``s over frames is a frame dimension written
out here: :func:`ecc_align_batch` registers (F, H, W) frames against one
reference, every sum reducing over each frame's own pixels.  Its
``lax.scan`` is a Python loop of the same fixed length, with no early exit
and nothing read back to the host inside it.  Arithmetic is float32, as
the JAX package computes; sampling is the JAX package's ``_bilinear``
(clamped coordinates, four gathered neighbours), not ``grid_sample``,
whose border handling differs.
"""

from __future__ import annotations

import torch

from .filters import scharr
from .smallsolve import solve_spd_small

__all__ = ["N_PARAMS", "prepare_flux", "warp_params_to_matrix", "ecc_align",
           "ecc_align_batch", "ecc_frame_bytes"]

N_PARAMS = {"unchanged": 0, "translation": 2, "euclidian": 3, "affine": 6}


def _frames(x, what: str) -> torch.Tensor:
    """``x`` as float32, which must be a tensor: its device is where the work runs."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{what} must be a torch.Tensor on the device to run on, "
                        f"not {type(x).__name__}")
    return x.to(torch.float32)


def _nan_extreme(x: torch.Tensor, largest: bool) -> torch.Tensor:
    """nanmax / nanmin over the last two dims, keepdim (NaN where all NaN)."""
    nan = torch.isnan(x)
    fill = -torch.inf if largest else torch.inf
    y = torch.where(nan, fill, x)
    y = y.amax(dim=(-2, -1), keepdim=True) if largest else y.amin(dim=(-2, -1), keepdim=True)
    return torch.where(nan.all(dim=-1, keepdim=True).all(dim=-2, keepdim=True), torch.nan, y)


def prepare_flux(flux) -> torch.Tensor:
    """Log-scale, normalise and Scharr-filter (..., H, W) frames for alignment.

    Reference image_motion.py:74-110: registration runs on the gradient of
    the log-image, which tames bright stars.  Each frame is normalised by
    its own finite extremes; NaN gradients become 0.  Runs on ``flux``'s
    device (a tensor).
    """
    flux = _frames(flux, "flux")
    flux = torch.log10(flux - _nan_extreme(flux, False) + 1.0)
    fmax = _nan_extreme(flux, True)
    fmin = _nan_extreme(flux, False)
    ran = torch.clamp(torch.abs(fmax - fmin), min=1e-30)
    flux1 = -1.0 + 2.0 * (flux - fmin) / ran
    return torch.nan_to_num(scharr(flux1))


def warp_params_to_matrix(params: torch.Tensor, mode: str) -> torch.Tensor:
    """Kernel parameters (..., P) -> (..., 2, 3) warp matrices (reference conventions)."""
    if mode == "translation":
        dx, dy = params[..., 0], params[..., 1]
        one, zero = torch.ones_like(dx), torch.zeros_like(dx)
        rows = [[one, zero, dx], [zero, one, dy]]
    elif mode == "euclidian":
        dx, dy, th = params[..., 0], params[..., 1], params[..., 2]
        c, s = torch.cos(th), torch.sin(th)
        rows = [[c, -s, dx], [s, c, dy]]
    elif mode == "affine":
        return params.reshape(params.shape[:-1] + (2, 3))
    else:
        raise ValueError(f"Invalid warpmode: {mode}")
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _bilinear(src: torch.Tensor, x: torch.Tensor, y: torch.Tensor, H: int, W: int):
    """Bilinear samples at pixel coordinates x, y (F, H*W), clamped to
    [0, W-1.001] x [0, H-1.001], of the frames ``src`` (F*H*W, C) stored
    channels-last (each pixel's C values adjacent, so one row gather fetches
    them all); returns (F, H*W, C)."""
    shape = x.shape + (src.shape[1],)
    x = torch.clamp(x, 0.0, W - 1.001)
    y = torch.clamp(y, 0.0, H - 1.001)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    idx = y0.to(torch.int64).mul_(W).add_(x0.to(torch.int64))
    idx += torch.arange(shape[0], device=x.device)[:, None] * (H * W)
    idx = idx.reshape(-1)
    tx = x.sub_(x0)[..., None]
    ty = y.sub_(y0)[..., None]
    del x0, y0
    sx, sy = 1 - tx, 1 - ty

    def at(i):
        return torch.index_select(src, 0, i).reshape(shape)

    # v00 (1-tx)(1-ty) + v01 tx (1-ty) + v10 (1-tx) ty + v11 tx ty, summed
    # left to right as the JAX package writes it, one neighbour at a time:
    out = at(idx) * sx * sy
    out += at(idx + 1) * tx * sy
    out += at(idx + W) * sx * ty
    out += at(idx + (W + 1)) * tx * ty
    return out


def _jacobian(mode: str, p, dwx, dwy, xx, yy) -> torch.Tensor:
    """Columns dW/dp of the (F, H*W) warped gradients, as (F, P, H*W):
    ``dwy * jy + dwx * jx`` with the warp's coordinate Jacobians (jx, jy)
    at the original grid (the JAX package's ``jac_columns``); the zero and
    unit entries are written out, which changes no value."""
    if mode == "translation":
        cols = [dwx, dwy]
    elif mode == "euclidian":
        c, s = torch.cos(p[:, 2:3]), torch.sin(p[:, 2:3])
        cols = [dwx, dwy, dwy * (c * xx - s * yy) + dwx * (-s * xx - c * yy)]
    else:  # affine: [a00, a01, dx, a10, a11, dy]
        cols = [dwx * xx, dwx * yy, dwx, dwy * xx, dwy * yy, dwy]
    return torch.stack(cols, dim=1)


def _gram(Jp: torch.Tensor) -> torch.Tensor:
    """(F, P, P) products Jp Jp^T of (F, P, N) columns, each entry one
    product-and-sum over the pixels: a (P x N) @ (N x P) matmul with N in
    the millions leaves the card's matmul kernels nearly no parallelism."""
    nf, P = Jp.shape[:2]
    G = torch.empty(nf, P, P, dtype=Jp.dtype, device=Jp.device)
    for i in range(P):
        for j in range(i + 1):
            G[:, i, j] = G[:, j, i] = (Jp[:, i] * Jp[:, j]).sum(dim=1)
    return G


def _proj(Jp: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(F, P) products Jp v of (F, P, N) columns with (F, N) images."""
    return torch.stack([(Jp[:, i] * v).sum(dim=1) for i in range(Jp.shape[1])], dim=1)


def ecc_frame_bytes(H: int, W: int, mode: str) -> int:
    """Device bytes one frame of :func:`ecc_align_batch` holds at its peak,
    with a margin: the frame, its channels-last copy with both gradients,
    and one step's temporaries (warped coordinates, int64 gather indices,
    gathered neighbours, masks, zero-meaned images, the Jacobian before and
    after projection), 26 + 2P float32 planes.  A translation batch of
    2048^2 frames peaked at 28.3 planes per frame on an H100."""
    return (26 + 2 * N_PARAMS[mode]) * 4 * H * W


def ecc_align_batch(ref, imgs, mode: str = "euclidian", n_iters: int = 50, mask=None):
    """Warp parameters aligning each of the (F, H, W) frames ``imgs`` to ``ref``.

    ``ref`` (H, W) and ``imgs`` are preprocessed (:func:`prepare_flux`);
    ``mask`` (H, W) or (F, H, W) is an optional validity mask of the frames.
    ``imgs`` is a tensor, and the work runs on its device; ``ref`` and
    ``mask`` go there.  Returns ``(params (F, P), cc (F,))``: the warp
    parameters and the last step's correlation coefficient.  Every frame
    runs all ``n_iters`` steps.
    """
    imgs = _frames(imgs, "imgs")
    dev = imgs.device
    ref = torch.as_tensor(ref, device=dev).to(torch.float32)
    nf, H, W = imgs.shape
    npx = H * W
    if mode not in ("translation", "euclidian", "affine"):
        raise ValueError(f"Invalid warpmode: {mode}")
    P = N_PARAMS[mode]
    yy, xx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")
    xx, yy = xx.reshape(1, npx), yy.reshape(1, npx)
    valid = (torch.ones(H, W, dtype=torch.float32, device=dev) if mask is None
             else torch.as_tensor(mask, device=dev).to(torch.float32))
    valid = valid.expand(nf, H, W).clone()
    # avoid border effects of the warp sampling:
    valid[:, :2, :] = 0
    valid[:, -2:, :] = 0
    valid[:, :, :2] = 0
    valid[:, :, -2:] = 0
    valid = valid.reshape(nf, npx)
    refv = ref.reshape(1, npx)

    if mode == "affine":
        # affine params are the full 2x3 matrix: identity start, not zeros
        p = torch.tensor([1.0, 0.0, 0.0, 0.0, 1.0, 0.0], device=dev).repeat(nf, 1)
    else:
        p = torch.zeros(nf, P, dtype=torch.float32, device=dev)
    # Image gradients (d/drow, d/dcol), sampled at the warped coordinates:
    gy, gx = torch.gradient(imgs, dim=(1, 2))
    src = torch.stack([imgs, gx, gy], dim=-1).reshape(nf * npx, 3)
    del gx, gy
    eye = 1e-6 * torch.eye(P, dtype=torch.float32, device=dev)
    cc = torch.zeros(nf, dtype=torch.float32, device=dev)

    for _ in range(n_iters):
        M = warp_params_to_matrix(p, mode)
        wx = M[:, 0, 0, None] * xx + M[:, 0, 1, None] * yy + M[:, 0, 2, None]
        wy = M[:, 1, 0, None] * xx + M[:, 1, 1, None] * yy + M[:, 1, 2, None]
        w, dwx, dwy = _bilinear(src, wx, wy, H, W).unbind(2)
        J = _jacobian(mode, p, dwx, dwy, xx, yy)
        del dwx, dwy
        # The support follows the warp: pixels warped outside the image are
        # excluded, as OpenCV excludes them by warping the input mask.
        inb = (wx >= 0.0) & (wx <= W - 1.001) & (wy >= 0.0) & (wy <= H - 1.001)
        del wx, wy
        wmask = valid * inb.to(torch.float32)
        # Full ECC update in the zero-mean subspace of the support; the
        # template is renormalised per frame because the support follows
        # each frame's warp.
        nsum = wmask.sum(dim=1)
        n = torch.clamp(nsum, min=1)
        wmean = (w * wmask).sum(dim=1) / n
        w0 = (w - wmean[:, None]) * wmask
        del w
        gmean = (refv * wmask).sum(dim=1) / torch.clamp(nsum, min=1)
        g0 = (refv - gmean[:, None]) * wmask
        g0 = g0 / torch.clamp(torch.sqrt((g0 * g0).sum(dim=1)), min=1e-30)[:, None]
        colmean = (J * wmask[:, None]).sum(dim=2) / n[:, None]
        Jp = (J - colmean[:, :, None]) * wmask[:, None]
        del J
        JtJ = _gram(Jp) + eye
        Jtw, Jtg = _proj(Jp, w0), _proj(Jp, g0)
        v = solve_spd_small(JtJ, Jtw)
        wnorm2 = (w0 * w0).sum(dim=1)
        gw = (g0 * w0).sum(dim=1)
        num = wnorm2 - (Jtw * v).sum(dim=1)
        den = gw - (Jtg * v).sum(dim=1)
        lam = num / torch.where(torch.abs(den) > 1e-20, den, 1e-20)
        err = lam[:, None] * g0 - w0
        dp = solve_spd_small(JtJ, _proj(Jp, err))
        cc = gw / torch.clamp(torch.sqrt(wnorm2), min=1e-30)
        p = p + dp
    return p, cc


def ecc_align(ref, img, mode: str = "euclidian", n_iters: int = 50, mask=None):
    """Warp parameters aligning one preprocessed frame ``img`` (H, W) to ``ref``.

    The JAX package's signature, with ``img`` a tensor on the device to run
    on; returns ``(params (P,), cc)``.
    """
    img = _frames(img, "img")
    params, cc = ecc_align_batch(ref, img[None], mode=mode, n_iters=n_iters,
                                 mask=None if mask is None else torch.as_tensor(mask)[None])
    return params[0], cc[0]
