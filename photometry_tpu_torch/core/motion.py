"""
Image-motion (pointing jitter) model.

Port of ``photometry_tpu/core/motion.py`` (reference image_motion.py):
``load_series`` and ``jitter_batch`` for every warp mode —
``unchanged/translation/euclidian/affine`` kernel series interpolated in
time, or ``wcs`` mode where each frame carries its own WCS and the jitter
is the WCS-to-WCS pixel displacement.  Kernel warps are applied in float32
like the reference's device program; WCS displacements stay host float64.

Kernels are estimated by ECC registration against the reference image
(``calc_kernel``, ``calc_kernels_batch``; ``ops/registration.py``), the
prepare stage's stage 6.  Estimation runs on the card unless the caller
asks for the CPU (``device=``); frames go there in sub-batches bounded by
bytes.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..io.fits import Header
from ..io.wcs import TanWCS
from ..ops.registration import N_PARAMS, ecc_align, ecc_align_batch, ecc_frame_bytes, prepare_flux

__all__ = ["MotionModel", "ecc_sub_batch"]

#: Device bytes the frames of one registration sub-batch may hold (H100: 80 GB);
#: ``chip_ecc_budget.py`` times registration and its peak memory against it.
ECC_BUDGET_BYTES = 8e9


def ecc_sub_batch(H: int, W: int, mode: str) -> int:
    """Frames of (H, W) per device sub-batch of registration: as many as
    ``ECC_BUDGET_BYTES`` of their state hold (``ecc_frame_bytes``), at
    least one."""
    return max(1, int(ECC_BUDGET_BYTES // ecc_frame_bytes(H, W, mode)))


def _apply_kernel_batch(params: torch.Tensor, mode: str, cols: torch.Tensor,
                        rows: torch.Tensor) -> torch.Tensor:
    """Displacements (T, N, 2) of (dcol, drow) for kernels (T, P) at positions (N,)."""
    if mode == "translation":
        d = params[:, None, :2]
        return d.expand(params.shape[0], cols.shape[0], 2)
    x = cols[None, :]
    y = rows[None, :]
    if mode == "euclidian":
        dx, dy, th = params[:, 0:1], params[:, 1:2], params[:, 2:3]
        c, s = torch.cos(th), torch.sin(th)
        nx = c * x - s * y + dx
        ny = s * x + c * y + dy
    elif mode == "affine":
        M = params.reshape(-1, 2, 3)
        nx = M[:, 0, 0, None] * x + M[:, 0, 1, None] * y + M[:, 0, 2, None]
        ny = M[:, 1, 0, None] * x + M[:, 1, 1, None] * y + M[:, 1, 2, None]
    else:
        raise ValueError(f"Invalid warpmode: {mode}")
    return torch.stack([nx - x, ny - y], dim=-1)


class MotionModel:
    """Per-sector pointing-jitter model."""

    def __init__(self, warpmode: str = "euclidian", image_ref=None,
                 wcs_ref: Optional[TanWCS] = None):
        """``image_ref`` (H, W), a tensor or array, is the registration
        reference.  Construction computes nothing: the reference is
        preprocessed (:func:`~photometry_tpu_torch.ops.registration.prepare_flux`)
        on the device of the first estimation and kept there as
        ``image_ref``."""
        if warpmode not in ("wcs", "unchanged", "translation", "euclidian", "affine"):
            raise ValueError("Invalid warpmode")
        self.warpmode = warpmode
        self.n_params = N_PARAMS.get(warpmode, 1)
        self._ref_raw = image_ref
        self._ref_dev = None
        self.image_ref = None
        self.wcs_ref = wcs_ref
        self.series_times: Optional[np.ndarray] = None
        self.series_kernels = None
        self._wcs_series = None

    # ------------------------------------------------------------- estimation
    def _reference(self, device) -> torch.Tensor:
        """The preprocessed reference on ``device`` (prepared there once)."""
        if self._ref_raw is None:
            raise RuntimeError("Reference image not defined")
        dev = resolve_device(device)
        if self.image_ref is None or self._ref_dev != dev:
            self.image_ref = prepare_flux(torch.as_tensor(self._ref_raw).to(dev))
            self._ref_dev = dev
        return self.image_ref

    def calc_kernel(self, image, n_iters: int = 50, device="cuda") -> np.ndarray:
        """Warp parameters (P,) float64 of one (H, W) frame against the
        reference image, registered on ``device``."""
        if self.warpmode == "unchanged":
            return np.zeros(0)
        ref = self._reference(device)
        img = prepare_flux(torch.as_tensor(image).to(ref.device))
        params, _cc = ecc_align(ref, img, mode=self.warpmode, n_iters=n_iters)
        return params.cpu().numpy().astype(np.float64)

    def calc_kernels_batch(self, images, n_iters: int = 50, device="cuda") -> np.ndarray:
        """Warp parameters (T, P) float64 of a (T, H, W) stack on ``device``,
        in sub-batches of :func:`ecc_sub_batch` frames."""
        if self.warpmode == "unchanged":
            return np.zeros((len(images), 0))
        ref = self._reference(device)
        nt, H, W = images.shape
        step = ecc_sub_batch(H, W, self.warpmode)
        out = np.empty((nt, self.n_params), np.float64)
        for t0 in range(0, nt, step):
            frames = prepare_flux(torch.as_tensor(images[t0:t0 + step]).to(ref.device))
            params, _cc = ecc_align_batch(ref, frames, mode=self.warpmode, n_iters=n_iters)
            out[t0:t0 + step] = params.cpu().numpy()
        return out

    # ------------------------------------------------------------ time series
    def load_series(self, times, kernels):
        """Load a kernel time-series for interpolation.

        For ``wcs`` mode, ``kernels`` is a sequence of TanWCS objects or
        serialized header strings (empty strings are dropped, matching
        reference image_motion.py:283-312).
        """
        times = np.asarray(times, np.float64)
        if self.warpmode == "wcs":
            series = []
            good = np.ones(len(times), bool)
            for k, kern in enumerate(kernels):
                if isinstance(kern, (str, bytes)):
                    s = kern.decode() if isinstance(kern, bytes) else kern
                    if not s.strip():
                        good[k] = False
                        series.append(None)
                        continue
                    series.append(TanWCS.from_header(Header.from_bytes(s.encode("ascii"))))
                elif all(hasattr(kern, a) for a in ("crpix", "crval", "cd")):
                    series.append(TanWCS.from_any(kern))
                else:
                    raise ValueError("Invalid WCS kernel")
            self.series_times = times[good]
            self._wcs_series = [s for s, g in zip(series, good) if g]
            if len(self.series_times) == 0:
                raise ValueError("No valid WCS kernels in series")
        else:
            kernels = np.atleast_2d(np.asarray(kernels, np.float64))
            if kernels.shape != (len(times), self.n_params):
                raise ValueError(
                    f"Wrong shape of kernels. Anticipated ({len(times)},{self.n_params}), "
                    f"but got {kernels.shape}")
            indx = np.isfinite(times) & np.all(np.isfinite(kernels), axis=1)
            self.series_times = times[indx]
            self.series_kernels = kernels[indx]
            if len(self.series_times) == 0:
                raise ValueError("No valid (finite) kernels in series")

    # ------------------------------------------------------------- evaluation
    def jitter_batch(self, eval_times, cols, rows) -> np.ndarray:
        """Jitter (dcol, drow) for every (time, star) pair, (T, N, 2) float64.

        Out-of-range timestamps clamp to the first/last kernel.
        """
        eval_times = np.atleast_1d(np.asarray(eval_times, np.float64))
        cols = np.atleast_1d(np.asarray(cols, np.float64))
        rows = np.atleast_1d(np.asarray(rows, np.float64))
        if self.warpmode == "wcs":
            return self._jitter_wcs(eval_times, cols, rows)
        if self.warpmode == "unchanged":
            return np.zeros((len(eval_times), len(cols), 2))
        if self.series_times is None:
            raise ValueError("Interpolator is not defined.")
        k0, k1, w = self._interp_index(eval_times)
        sk = self.series_kernels
        params = sk[k0] * (1 - w[:, None]) + sk[k1] * w[:, None]
        out = _apply_kernel_batch(torch.as_tensor(params, dtype=torch.float32), self.warpmode,
                                  torch.as_tensor(cols, dtype=torch.float32),
                                  torch.as_tensor(rows, dtype=torch.float32))
        return out.numpy().astype(np.float64)

    def jitter(self, time, column, row) -> np.ndarray:
        """Jitter (dcol, drow) of one star at every time, (T, 2) float64
        (reference image_motion.py:403-421): :meth:`jitter_batch` with N = 1."""
        return self.jitter_batch(time, [column], [row])[:, 0, :]

    def _interp_index(self, eval_times):
        """Bracketing series indices and linear weight of each time, clamped
        to the first/last kernel (a one-kernel series is constant)."""
        st = self.series_times
        if len(st) == 1:
            k = np.zeros(len(eval_times), np.int64)
            return k, k, np.zeros(len(eval_times))
        k = np.clip(np.searchsorted(st, eval_times, side="right") - 1, 0, len(st) - 2)
        t0, t1 = st[k], st[k + 1]
        return k, k + 1, np.clip((eval_times - t0) / np.maximum(t1 - t0, 1e-30), 0.0, 1.0)

    def _wcs_displacements(self, cols, rows) -> np.ndarray:
        """(K, N, 2) displacement of each star in each WCS frame vs reference."""
        if self.wcs_ref is None:
            raise RuntimeError("Reference WCS not defined")
        ra, dec = self.wcs_ref.pixel_to_world(cols + 1.0, rows + 1.0)
        disp = np.empty((len(self._wcs_series), len(cols), 2))
        for i, w in enumerate(self._wcs_series):
            x, y = w.world_to_pixel(ra, dec)
            disp[i, :, 0] = x - 1.0 - cols
            disp[i, :, 1] = y - 1.0 - rows
        return disp

    def _jitter_wcs(self, eval_times, cols, rows) -> np.ndarray:
        disp = self._wcs_displacements(cols, rows)   # (K, N, 2)
        k0, k1, w = self._interp_index(eval_times)
        return disp[k0] * (1 - w[:, None, None]) + disp[k1] * w[:, None, None]
