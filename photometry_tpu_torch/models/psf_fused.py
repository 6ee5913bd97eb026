"""
Fused warm-start LM PSF fit: the port of ``photometry_tpu/models/psf_pallas.py``.

Per instance (one target at one cadence): the Gaussian_d weights, then
``n_iters`` damped Gauss-Newton steps over S stars rendered through the
K-term SVD-separable Catmull-Rom table (``models.prf``), each a 3S x 3S
normal equation solved by Cholesky with the reference's flux and position
clips, then a final render for the main target's flux variance (Cholesky
inverse column norms) and the MOMF residual-aperture sum.

- On a CUDA tensor :func:`fused_warm_fit` launches the hand-written Hopper
  kernel ``ops/csrc/psf_warm_fit.cu`` (:func:`fused_warm_fit_cuda`); see
  the note in that source for its layout (one warp per instance, the
  normal equations on the tensor cores in 3xTF32).
- On a CPU tensor it runs :func:`fused_warm_fit_plain`: the plain torch
  fitter ``psf_fit.make_psf_fitter`` over the batch, the same math the JAX
  package holds its kernel against.  ``chip_smoke.py`` holds the kernel
  against it on the card.

A CUDA tensor always goes to the kernel or raises; nothing falls back.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..ops._kernels import PSF_WARM_FIT, KernelError
from .psf_common import CUTOFF_RADIUS

__all__ = ["fused_ok", "fused_warm_fit", "fused_warm_fit_plain", "fused_warm_fit_cuda", "KMAX",
           "MAX_WARPS", "warps_per_block"]

KMAX = 4        #: SVD terms the kernel takes; larger tables use the plain fitter
MAX_WARPS = 8   #: instances (warps) per block of the kernel, at most


def warps_per_block(B: int, n_sms: int) -> int:
    """Instances per block: up to ``MAX_WARPS``, but few enough that a
    small batch (the first-cadence fits, one instance per target) still
    spreads over twice the SMs in blocks."""
    return max(1, min(MAX_WARPS, B // (2 * n_sms)))


def fused_ok(prf, shape, S: int, lhood_stat: str) -> bool:
    """Can this configuration run the fused kernel?"""
    if lhood_stat != "Gaussian_d" or S > 8:
        return False
    if not prf._grid_separable:
        return False
    U, V = prf._svd_factors()
    if U.shape[1] > KMAX:
        return False
    h, w = shape
    return h <= 32 and w <= 32


def fused_warm_fit(images, backgrounds, var_const, p0, valid, miniw, onehot,
                   prf, shape, S: int, n_iters: int) -> dict:
    """Warm-start LM fit of B independent stamps.

    images/backgrounds: (B, h, w) float32; p0: (B, 3S) packed as
    [rows, cols, fluxes]; valid: (B, S) bool; miniw: (B, h, w) bool (MOMF
    aperture, ANDed with the finite pixels here); onehot: (B, S) float32
    selecting each instance's main target.  Gaussian_d weights only.

    Returns params (B, 3S), flux_ap (B,) and fluxvar_target (B,), float32.
    """
    if images.is_cuda:
        return fused_warm_fit_cuda(images, backgrounds, var_const, p0, valid, miniw, onehot,
                                   prf, shape, S, n_iters)
    return fused_warm_fit_plain(images, backgrounds, var_const, p0, valid, miniw, onehot,
                                prf, shape, S, n_iters)


def fused_warm_fit_plain(images, backgrounds, var_const, p0, valid, miniw, onehot,
                         prf, shape, S: int, n_iters: int) -> dict:
    """The kernel's function by the plain torch fitter, on any device."""
    from .psf_fit import make_psf_fitter
    fit = make_psf_fitter(prf, shape, S, "Gaussian_d", n_iters=n_iters)
    p, mdl, flux_var = fit(images, backgrounds, var_const, p0, valid)
    keep = miniw.to(torch.bool) & torch.isfinite(images)
    resid = torch.where(keep, torch.nan_to_num(images) - mdl, torch.zeros((), device=p.device))
    return {"params": p,
            "flux_ap": resid.sum(dim=(-2, -1)),
            "fluxvar_target": torch.sum(flux_var * onehot, dim=-1)}


def _kernel_tables(prf, h: int, w: int):
    """Padded (Lz, K) factor tables of both axes on the card, with their
    clamp bounds: ``prf._axis_folded_table`` uploaded once per PRF."""
    U, V = prf._svd_factors()
    out = []
    for F, n in ((U, h), (V, w)):
        b_lo, b_hi, Fz = prf._axis_table_dev(F, n)
        out.append((b_lo, b_hi, F.shape[0], Fz))
    return out


def fused_warm_fit_cuda(images, backgrounds, var_const, p0, valid, miniw, onehot,
                        prf, shape, S: int, n_iters: int) -> dict:
    """The fit by the CUDA kernel ``ops/csrc/psf_warm_fit.cu``."""
    B, h, w = images.shape
    if (h, w) != tuple(shape):
        raise ValueError(f"images are {(h, w)}, shape is {tuple(shape)}")
    if not fused_ok(prf, shape, S, "Gaussian_d"):
        raise KernelError(f"psf_warm_fit does not take this configuration (S={S}, {shape})")
    (bu_lo, bu_hi, L0u, Fu), (bv_lo, bv_hi, L0v, Fv) = _kernel_tables(prf, h, w)
    dev = images.device
    if Fu.device != dev:
        raise ValueError(f"PRF tables are on {Fu.device}, images on {dev}")
    f32 = dict(device=dev, dtype=torch.float32)
    images = images.to(**f32).contiguous()
    backgrounds = backgrounds.to(**f32).contiguous()
    if backgrounds.shape != images.shape:
        raise ValueError(f"backgrounds are {tuple(backgrounds.shape)}, images {(B, h, w)}")
    p0 = p0.to(**f32).contiguous()
    valid = valid.to(device=dev, dtype=torch.uint8).contiguous()
    miniw = miniw.to(device=dev, dtype=torch.uint8).contiguous()
    onehot = onehot.to(**f32).contiguous()
    for name, t, want in (("p0", p0, (B, 3 * S)), ("valid", valid, (B, S)),
                          ("miniw", miniw, (B, h, w)), ("onehot", onehot, (B, S))):
        if tuple(t.shape) != want:
            raise ValueError(f"{name} is {tuple(t.shape)}, expected {want}")
    K = Fu.shape[1]
    params = torch.empty(B, 3 * S, **f32)
    flux_ap = torch.empty(B, **f32)
    fluxvar = torch.empty(B, **f32)
    if B == 0:
        return {"params": params, "flux_ap": flux_ap, "fluxvar_target": fluxvar}
    lib = PSF_WARM_FIT.lib()
    F = ctypes.c_float
    err = lib.psf_warm_fit(
        images.data_ptr(), backgrounds.data_ptr(), miniw.data_ptr(), p0.data_ptr(),
        valid.data_ptr(), onehot.data_ptr(), Fu.data_ptr(), Fv.data_ptr(),
        params.data_ptr(), flux_ap.data_ptr(), fluxvar.data_ptr(),
        ctypes.c_int64(B), h, w, S, K, int(round(prf.oversample)),
        bu_lo, bu_hi, L0u, Fu.shape[0], F(prf.center_y),
        bv_lo, bv_hi, L0v, Fv.shape[0], F(prf.center_x),
        n_iters, F(np.float32(var_const)), F(CUTOFF_RADIUS),
        warps_per_block(B, torch.cuda.get_device_properties(dev).multi_processor_count),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise KernelError(f"psf_warm_fit launch failed: CUDA error {err}")
    PSF_WARM_FIT.launches += 1
    return {"params": params, "flux_ap": flux_ap, "fluxvar_target": fluxvar}
