"""
Statistics of the background fit, on torch tensors.

Port of ``photometry_tpu/ops/stats.py``: sigma clipping and the SExtractor
mode over the last axis (the tiled background component), and the
histogram-KDE mode of every segment at once (the radial component's ring
modes).  Every function reduces over the last axis and batches over the
leading ones; the JAX package ``vmap``s the same code over frames.

- :func:`masked_median` is the exact median by 8-ary bisection in int32
  bit-pattern space (the JAX formulation, plain torch: it is XLA there,
  not a TPU kernel); below 256 samples it is ``jnp.nanmedian``'s
  middle-pair average (:func:`..utils.mathutils.nanmedian`).
- :func:`segment_kde_mode` builds its (segment x bucket) count table with
  :func:`.seghist.segment_histogram`: the CUDA kernel on a card, one
  ``bincount`` on the CPU.  The Gaussian smoothing is ``conv1d`` (the
  kernel is symmetric, so correlation and convolution agree), and
  ``argmax`` takes the first of equal maxima, as ``jnp.argmax`` does.
  :func:`kde_mode` is the same math on one sample.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import device  # noqa: F401  (no TF32 in conv1d)
from ..utils.mathutils import nanmax, nanmedian, nanmin
from .seghist import segment_histogram

__all__ = ["masked_median", "sigma_clip_mask", "sextractor_mode", "kde_mode",
           "segment_kde_mode"]

_INT_MAX = 2 ** 31 - 1
_INT_MIN = -(2 ** 31)


def _f32_to_ordkey(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 with signed-int order == float order (``stats._f32_to_ordkey``).

    Negative floats keep the sign bit and flip the other 31; non-negative
    ones are their own bit pattern.  Exact and total over finite floats
    and +-inf; NaNs are out of contract.
    """
    i = x.to(torch.float32).contiguous().view(torch.int32)
    return torch.where(i < 0, i ^ 0x7FFFFFFF, i)


def _ordkey_to_f32(key: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_f32_to_ordkey` (the mapping is an involution)."""
    return torch.where(key < 0, key ^ 0x7FFFFFFF, key).contiguous().view(torch.float32)


def _avg(a, b):
    """Overflow-safe floor average of two int32 tensors."""
    return (a & b) + ((a ^ b) >> 1)


def _count(flags: torch.Tensor, dim: int, dtype=torch.int32) -> torch.Tensor:
    """Number of True along ``dim`` (summed as bytes: faster than bool -> int64)."""
    return flags.view(torch.uint8).sum(dim=dim, dtype=dtype)


def masked_median(x: torch.Tensor, good: torch.Tensor, iters: int = 33,
                  min_bisect: int = 256) -> torch.Tensor:
    """Exact median of ``x`` over the last axis where ``good``.

    ``np.nanmedian(where(good, x, nan), axis=-1)``: the mean of the two
    middle order statistics for even counts, NaN for empty selections.
    Found by bisection of int32 order keys, seven probes per pass, so the
    value range cannot stall it; float64 input and axes shorter than
    ``min_bisect`` take the sorting median.
    """
    if x.shape[-1] < min_bisect or x.dtype == torch.float64:
        return nanmedian(torch.where(good, x, torch.nan), dim=-1)
    n = good.sum(dim=-1)
    k1 = (n + 1) // 2          # 1-based rank of the lower middle
    k2 = n // 2 + 1            # upper middle (== k1 for odd n)
    key = _f32_to_ordkey(x)
    kmin = torch.where(good, key, _INT_MAX).amin(dim=-1)
    kmax = torch.where(good, key, _INT_MIN).amax(dim=-1)
    # count(key <= lo) < k1 <= count(key <= hi); the -inf key is > INT32_MIN.
    lo, hi = kmin - 1, kmax
    for _ in range(-(-iters // 3) + 1):
        m4 = _avg(lo, hi)
        m2, m6 = _avg(lo, m4), _avg(m4, hi)
        mids = torch.stack([_avg(lo, m2), m2, _avg(m2, m4), m4, _avg(m4, m6), m6,
                            _avg(m6, hi)], dim=-1)                        # (..., 7)
        cnt = torch.stack([_count((key <= mids[..., j, None]) & good, -1)
                           for j in range(7)], dim=-1)
        ge = cnt >= k1[..., None]
        hi = torch.where(ge, mids, hi[..., None]).amin(dim=-1)
        lo = torch.where(ge, lo[..., None], mids).amax(dim=-1)
    v1 = _ordkey_to_f32(hi)
    cnt1 = _count((key <= hi[..., None]) & good, -1)
    knext = torch.where(good & (key > hi[..., None]), key, _INT_MAX).amin(dim=-1)
    v2 = torch.where(cnt1 >= k2, v1, _ordkey_to_f32(knext))
    return torch.where(n > 0, 0.5 * (v1 + v2), torch.nan)


def _moments(x, good):
    n = good.sum(dim=-1, keepdim=True)
    mean = torch.where(good, x, 0.0).sum(dim=-1, keepdim=True) / torch.clamp(n, min=1)
    var = (torch.where(good, (x - mean) ** 2, 0.0).sum(dim=-1, keepdim=True)
           / torch.clamp(n - 1, min=1))
    return n, mean, torch.sqrt(var)


def sigma_clip_mask(x: torch.Tensor, mask=None, sigma: float = 3.0,
                    maxiters: int = 5) -> torch.Tensor:
    """Iterative sigma clipping about the median over the last axis.

    ``mask`` True = already excluded.  Returns True where a value survives.
    """
    good = torch.isfinite(x)
    if mask is not None:
        good = good & ~mask
    for _ in range(maxiters):
        med = masked_median(x, good)[..., None]
        _, _, std = _moments(x, good)
        good = good & (torch.abs(x - med) <= sigma * std)
    return good


def sextractor_mode(x: torch.Tensor, mask=None, sigma: float = 3.0, maxiters: int = 5,
                    min_fraction: float = 0.0) -> torch.Tensor:
    """SExtractor background mode of the last axis after sigma clipping.

    2.5 median - 1.5 mean, or the median where (mean - median) / std > 0.3
    (photutils' SExtractorBackground); NaN where fewer than
    ``min_fraction`` of the values were valid to begin with.
    """
    total = x.shape[-1]
    initial_good = torch.isfinite(x) if mask is None else (torch.isfinite(x) & ~mask)
    good = sigma_clip_mask(x, mask=mask, sigma=sigma, maxiters=maxiters)
    n, mean, std = (v[..., 0] for v in _moments(x, good))
    med = masked_median(x, good)
    mode = 2.5 * med - 1.5 * mean
    skewed = torch.abs(mean - med) / torch.clamp(std, min=1e-30) > 0.3
    mode = torch.where(skewed | (std == 0), med, mode)
    frac0 = initial_good.sum(dim=-1) / total
    return torch.where((n > 0) & (frac0 >= min_fraction), mode, torch.nan)


def _refine_parabolic(hist: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Sub-bucket refinement of an argmax by a parabola through 3 points."""
    nb = hist.shape[-1]
    i0 = torch.clamp(idx, 1, nb - 2)
    ym = torch.take_along_dim(hist, (i0 - 1)[..., None], dim=-1)[..., 0]
    y0 = torch.take_along_dim(hist, i0[..., None], dim=-1)[..., 0]
    yp = torch.take_along_dim(hist, (i0 + 1)[..., None], dim=-1)[..., 0]
    denom = ym - 2 * y0 + yp
    delta = torch.where(torch.abs(denom) > 1e-30, 0.5 * (ym - yp) / denom, 0.0)
    return i0.to(hist.dtype) + torch.clamp(delta, -0.5, 0.5)


def _gauss_kernel(sigma_buckets: float, radius: int) -> np.ndarray:
    """Normalised float32 Gaussian taps, as ``stats._gauss_kernel``."""
    t = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(np.float32(-0.5) * (t / np.float32(max(sigma_buckets, 1e-3))) ** 2)
    return (k / k.sum(dtype=np.float32)).astype(np.float32)


def _kde_modes(values, seg, good, lo, hi, n_segments: int, n_buckets: int,
               smooth_sigma_frac: float, plain: bool):
    """(F, n_segments) smoothed-histogram modes of (F, N) ``values`` over
    each frame's [lo, hi] (F, 1), and the (F, n_segments) sample counts."""
    span = torch.clamp(hi - lo, min=1e-30)
    b = torch.clamp(((values - lo) / span * n_buckets).to(torch.int32), 0, n_buckets - 1)
    hist = segment_histogram(seg, b, good, n_segments, n_buckets, plain=plain)
    radius = max(int(3 * smooth_sigma_frac * n_buckets), 2)
    kern = torch.from_numpy(_gauss_kernel(smooth_sigma_frac * n_buckets, radius)).to(values.device)
    nf = hist.shape[0]
    sm = F.conv1d(hist.reshape(nf * n_segments, 1, n_buckets), kern.view(1, 1, -1),
                  padding=radius).reshape(nf, n_segments, n_buckets)
    pos = _refine_parabolic(sm, torch.argmax(sm, dim=-1))
    return lo + (pos + 0.5) / n_buckets * span, hist.sum(dim=-1)


def kde_mode(x: torch.Tensor, mask=None, n_buckets: int = 512, smooth_sigma_frac: float = 0.01,
             lo=None, hi=None) -> torch.Tensor:
    """Mode of one sample (every element of ``x``) by its smoothed histogram
    with parabolic refinement (``stats.kde_mode``, replacing statsmodels'
    FFT KDE mode, reference backgrounds.py:21-33): :func:`segment_kde_mode`'s
    math with one segment, over [``lo``, ``hi``] (default the good values'
    range).  ``mask`` True excludes a sample.  A 0-d tensor, NaN when no
    sample is good."""
    x = x.reshape(1, -1)
    good = torch.isfinite(x)
    if mask is not None:
        good = good & ~torch.as_tensor(mask, device=x.device).reshape(1, -1)
    vg = torch.where(good, x, torch.nan)
    lo = nanmin(vg, dim=-1)[:, None] if lo is None else torch.full((1, 1), float(lo), device=x.device)
    hi = nanmax(vg, dim=-1)[:, None] if hi is None else torch.full((1, 1), float(hi), device=x.device)
    seg = torch.zeros(x.shape[1], dtype=torch.int32, device=x.device)
    modes, _ = _kde_modes(x, seg, good, lo, hi, 1, n_buckets, smooth_sigma_frac, plain=False)
    return torch.where(good.any(), modes[0, 0], torch.nan)


def segment_kde_mode(values: torch.Tensor, seg_ids: torch.Tensor, n_segments: int, mask=None,
                     n_buckets: int = 512, smooth_sigma_frac: float = 0.01,
                     min_count: int = 1, plain: bool = False) -> torch.Tensor:
    """Histogram-KDE mode of ``values`` within each segment, for every frame.

    ``values`` (F, N) or (N,); ``seg_ids`` (N,) shared by the frames
    (out-of-range ids are excluded); ``mask`` like ``values``, True =
    exclude.  Each frame's histogram spans its own good-value range.
    Returns (F, n_segments) modes, NaN where a segment has fewer than
    ``min_count`` samples.  ``plain`` builds the count table with the
    plain version on any device (for comparisons on the card).
    """
    squeeze = values.ndim == 1
    if squeeze:
        values = values[None]
        mask = None if mask is None else mask[None]
    seg = seg_ids.reshape(-1).to(torch.int32)
    good = torch.isfinite(values) & ((seg >= 0) & (seg < n_segments))[None]
    if mask is not None:
        good = good & ~mask
    vg = torch.where(good, values, torch.nan)
    modes, counts = _kde_modes(values, seg, good, nanmin(vg, dim=-1)[:, None],
                               nanmax(vg, dim=-1)[:, None], n_segments, n_buckets,
                               smooth_sigma_frac, plain)
    out = torch.where(counts >= min_count, modes, torch.nan)
    return out[0] if squeeze else out
