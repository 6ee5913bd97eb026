"""
Per-pixel flags of the prepare stage: manual excludes and "Background Shenanigans".

Port of ``photometry_tpu/core/pixelflags.py`` (reference
photometry/pixel_flags.py):

- :func:`manual_exclude_mask` (host numpy) encodes the curated event list
  (the Mars register overflow in S1 camera 1 CCD 4, the S1 Earth-shine
  window, all-zero images) keyed on header values (pixel_flags.py:14-58).
- :func:`shenanigans_residual` is the 15 x 15 median-filtered residual of
  every frame against the sum image (pixel_flags.py:61-79), for a chunk
  of frames on their device: the median kernel on a card, its plain
  version on the CPU.  The stage thresholds it at 40 e-/s
  (prepare.py:514-622).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.filters import median_filter2d_chunked

__all__ = ["manual_exclude_mask", "shenanigans_residual"]


def manual_exclude_mask(data: np.ndarray, header: dict, is_tess: bool = True) -> np.ndarray:
    """Boolean mask of manually excluded pixels for one FFI."""
    mask = np.zeros(data.shape, bool)
    if is_tess:
        time = 0.5 * (header["TSTART"] + header["TSTOP"])
        cadenceno = header.get("FFIINDEX", np.inf)
    else:
        time = np.nan
        cadenceno = np.inf

    camera = header.get("CAMERA")
    ccd = header.get("CCD")

    # Mars floods output channel D of camera 1 CCD 4 early in Sector 1:
    if is_tess and camera == 1 and ccd == 4 and (
            cadenceno <= 4724 or header.get("TSTART", np.inf) <= 1325.881282301840):
        mask[:, 1536:] = True

    # Excessive Earth-shine window in Sector 1 (camera 1, all CCDs):
    elif is_tess and camera == 1 and (
            11354 <= cadenceno <= 11366 or 1464.0158778 <= time <= 1464.265871):
        mask[:, :] = True

    # Whole image zero (e.g. Sector 6 DR8 camera 2 ccd 1):
    if is_tess and np.all(data == 0):
        mask[:, :] = True

    return mask


def shenanigans_residual(img: torch.Tensor, sumimage=None, size: int = 15,
                         plain: bool = False) -> torch.Tensor:
    """Median-filtered residual of (H, W) or (F, H, W) frames against ``sumimage``.

    NaNs (of the frames or of the sum image) become 0 before the filter.
    ``plain`` runs the plain median on any device (for comparisons on the card).
    """
    img = img.to(torch.float32)
    if sumimage is not None:
        img = img - torch.as_tensor(sumimage, dtype=torch.float32, device=img.device)
    return median_filter2d_chunked(img, size=size, plain=plain)
