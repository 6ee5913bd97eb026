"""Plain reference of what the prepare stage writes into its store.

Nothing here imports the program or JAX.  It works from the benchmark's
own frames (the CAL and UNCERT planes it wrote) and the sky it drew.
The numbers:

* ``sky_gap``: the stored backgrounds against the sky the benchmark drew
  (the glow times each frame's drift, the drift smoothed as the stage
  smooths): per frame the median over pixels of |background - sky| / sky,
  the largest over frames (``sky_nonfinite`` counts the pixels whose
  background is not finite).  The per-frame fit is not worked out again: its answer is held
  to the truth;
* ``smooth_gap``: the stored backgrounds of a sample of pixels against a
  centred moving nanmean of the raw ones (stage 1's, before the smoothing)
  over ``window`` frames, the window shrinking at the ends, in float64;
* ``images_gap``: the stored images and errors against CAL minus the
  stored backgrounds, and UNCERT, NaN where a pixel's flags hold a bit of
  ``exclude_bits``, in float64;
* ``resid_gap`` and ``shenanigans_mismatch``: the stage's residuals (the
  scratch stack it drops) against the reference's, and the pixels whose
  BackgroundShenanigans bit differs from the reference's: each frame's
  residual (NaN as 0, minus the float32 sum image of the frames whose
  quality holds no bit of ``bad_quality``) 15x15 median filtered with the
  edge sample repeated, the robust mean of the medians of 25-frame blocks
  in the order of ``numpy.random.default_rng(0).permutation(T)``, and
  |residual - mean| above the threshold.
"""

import numpy as np
import torch

SHENANIGANS = 4                 #: the pixel flag of Background Shenanigans
BLOCK = 25


def gap(got: torch.Tensor, want: torch.Tensor, scale: float) -> float:
    """Largest |got - want| over the finite pixels as a share of ``scale``; a
    NaN where the other side is finite is a gap of 1e300."""
    got, want = got.double(), want.double()
    if not torch.equal(torch.isfinite(got), torch.isfinite(want)):
        return 1e300
    ok = torch.isfinite(want)
    return float((got[ok] - want[ok]).abs().max()) / max(scale, 1e-30) if ok.any() else 0.0


def _in(x, dtype):
    """The reference's input in float64, first rounded to ``dtype`` when given."""
    return (x if dtype is None else x.to(dtype)).double()


def moving_nanmean(x: torch.Tensor, window: int) -> torch.Tensor:
    T, half = x.shape[0], window // 2
    out = torch.empty_like(x)
    for t in range(T):
        blk = x[max(0, t - half):min(T, t + half + 1)]
        out[t] = torch.nanmean(blk, dim=0)
    return out


def sky_gaps(backgrounds, glow, drift, window, control=None) -> dict:
    """(T, H, W) stored backgrounds against the drawn sky, and the count of
    pixels whose background is not finite; with ``control``, the sky
    rounded to it takes the backgrounds' place."""
    drift = moving_nanmean(torch.as_tensor(np.asarray(drift, np.float64))[:, None],
                           window)[:, 0]
    out = {"sky_gap": 0.0, "sky_nonfinite": 0}
    for t in range(backgrounds.shape[0]):
        sky = glow.double() * float(drift[t])
        got = backgrounds[t] if control is None else sky.to(control)
        rel = ((got.double() - sky).abs() / sky).flatten()
        fin = torch.isfinite(rel)
        out["sky_nonfinite"] += int((~fin).sum())
        out["sky_gap"] = max(out["sky_gap"], float(rel[fin].median()) if fin.any() else 1e300)
    return out


def smooth_gap(raw, smoothed, window, control=None) -> float:
    want = moving_nanmean(_in(raw, None), window)
    got = smoothed if control is None else moving_nanmean(_in(raw, control), window)
    return gap(got, want, float(want[torch.isfinite(want)].abs().median()))


def images_gap(cal, unc, backgrounds, flags, images, errors, exclude_bits, control=None):
    excl = (flags.to(torch.int32) & exclude_bits) != 0
    nan = torch.tensor(float("nan"), dtype=torch.float64, device=cal.device)
    bkg = _in(backgrounds, None)
    want_i = torch.where(excl, nan, _in(cal, None) - bkg)
    want_e = torch.where(excl, nan, _in(unc, None))
    if control is not None:
        images = torch.where(excl, nan, _in(cal, control) - bkg)
        errors = torch.where(excl, nan, _in(unc, control))
    scale = float(want_e[torch.isfinite(want_e)].median())      # the noise of one pixel
    return max(gap(images, want_i, scale), gap(errors, want_e, scale))


def median15(x: torch.Tensor, size: int = 15, rows: int = 128) -> torch.Tensor:
    """Exact size x size median (the (size^2 // 2 + 1)-th smallest) of (H, W)
    float32 frames, numpy ``symmetric`` borders, in row blocks."""
    H, W = x.shape
    half = size // 2

    def reflect(n):
        idx = torch.remainder(torch.arange(-half, n + half, device=x.device), 2 * n)
        return torch.where(idx >= n, 2 * n - 1 - idx, idx)
    padded = x[reflect(H)][:, reflect(W)]
    out = torch.empty_like(x)
    k = size * size // 2 + 1
    for r0 in range(0, H, rows):
        r1 = min(H, r0 + rows)
        win = padded[r0:r1 + 2 * half].unfold(0, size, 1).unfold(1, size, 1)
        out[r0:r1] = win.reshape(r1 - r0, W, size * size).kthvalue(k, dim=-1).values
    return out


def shenanigans(images, quality, bad_quality, threshold, dtype=None) -> tuple:
    """The reference's median-filtered residuals and BackgroundShenanigans
    pixels of (T, H, W) images."""
    T = images.shape[0]
    if dtype is not None:
        images = images.to(dtype).float()
    good = [t for t in range(T) if not int(quality[t]) & bad_quality]
    total = torch.zeros(images.shape[1:], dtype=torch.float64, device=images.device)
    count = torch.zeros(images.shape[1:], dtype=torch.int32, device=images.device)
    for t in good:                                   # in frame order, as the stage sums
        fin = torch.isfinite(images[t])
        total += torch.where(fin, images[t].double(), 0.0)
        count += fin.to(torch.int32)
    sumimage = (total / count).float()
    resid = torch.stack([median15(torch.nan_to_num(torch.nan_to_num(images[t]) - sumimage))
                         for t in range(T)])
    order = np.random.default_rng(0).permutation(T)
    mean = torch.zeros(images.shape[1:], dtype=torch.float64, device=images.device)
    n = 0
    for k in range(0, T, BLOCK):
        blk = resid[torch.as_tensor(np.sort(order[k:k + BLOCK]), device=images.device)]
        srt = torch.sort(blk, dim=0).values
        lo, hi = (srt.shape[0] - 1) // 2, srt.shape[0] // 2
        mean += torch.nan_to_num((srt[lo] + srt[hi]) * 0.5).double()
        n += 1
    mean /= max(n, 1)
    return resid, (resid.double() - mean).abs() > threshold


def shenanigans_check(images, quality, residuals, flags, bad_quality, threshold, scale,
                      control=None) -> tuple:
    """(residual gap, flag mismatches): the stage's median-filtered
    residuals against the reference's, as a share of ``scale``, and the
    pixels whose shenanigans bit differs; with ``control``, the reference
    on images rounded to it takes the stage's place."""
    want_r, want_f = shenanigans(images, quality, bad_quality, threshold)
    if control is None:
        got_r, got_f = residuals, (flags.to(torch.int32) & SHENANIGANS) != 0
    else:
        got_r, got_f = shenanigans(images, quality, bad_quality, threshold, control)
    return gap(got_r, want_r, scale), int((want_f != got_f).sum())
