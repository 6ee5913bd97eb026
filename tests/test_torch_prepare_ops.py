"""Port parity of the prepare stage's modules, each against the JAX package.

Inputs are drawn with numpy from fixed seeds and handed to both packages
(JAX on the CPU).  Tolerances, and why:

- exact (rtol 0, atol 0): order keys, the bisection medians, the 15x15
  median filter (also against scipy), the segment histogram against the
  JAX one-hot matmul histogram, moving medians, exclusion masks, header-
  driven host functions;
- float32 summation order: sigma-clipped SExtractor modes rtol 2e-6, ring
  modes rtol 1e-6 (identical buckets; the Gaussian smoothing sums in
  another order), natural splines rtol 1e-6 + atol 1e-6 (a few ulp: XLA
  contracts the jitted cubic into FMAs), the running-sum time
  smoothing atol 5e-4 on values ~100 (float32 running sums up to ~4e3,
  whose ulp is 2.4e-4, added in another order);
- spline zoom: folded float64 matrices vs the JAX float32 recursion and
  vs scipy's float64 zoom, atol 1e-5 on unit-scale meshes (both packages
  sit ~4.4e-6 from scipy on a one-row mesh);
- backgrounds: rtol 1e-4 + atol 0.02 e-/s on skies of 50-200 e-/s: the
  ring modes go through 10**x and the spline, and the tile modes through
  sigma clipping, each a few float32 ulp apart.  ``log10`` itself differs
  by one ulp between XLA and torch in ~30% of pixels, which moves samples
  across histogram bucket edges; with the sub-CCD fallback's 4-px rings
  (a few hundred samples each) that shifts ring modes visibly, so that
  case is bounded by percentiles (ROADMAP Queue C).
"""

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

import jax
import jax.numpy as jnp

from torch_parity import n, t

from photometry_tpu import fixes as jax_fixes
from photometry_tpu.core import pixelflags as jax_pixelflags
from photometry_tpu.io import discovery as jax_discovery
from photometry_tpu.io import tess as jax_tess
from photometry_tpu.ops import background as jax_bg
from photometry_tpu.ops import filters as jax_filters
from photometry_tpu.ops import spline as jax_spline
from photometry_tpu.ops import stats as jax_stats
from photometry_tpu.ops import zoom as jax_zoom
from photometry_tpu.sim.simulator import SimConfig, simulate_sector
from photometry_tpu.utils import mathutils as jax_math
from photometry_tpu_torch import fixes
from photometry_tpu_torch.core import pixelflags
from photometry_tpu_torch.io import discovery, tess
from photometry_tpu_torch.ops import background, filters, median15, seghist, spline, stats, zoom
from photometry_tpu_torch.utils import mathutils

BKG_RTOL, BKG_ATOL = 1e-4, 0.02

# The JAX functions under jit: one compile instead of eager op-by-op
# dispatch (the functions are the same; these tests run on the CPU).
_jax_masked_median = jax.jit(jax_stats.masked_median)
_jax_sigma_clip = jax.jit(jax_stats.sigma_clip_mask)
_jax_sextractor = jax.jit(jax_stats.sextractor_mode, static_argnames=("min_fraction",))
_jax_kde_mode = jax.jit(jax_stats.segment_kde_mode,
                        static_argnames=("n_segments", "min_count", "method"))
_jax_spline = jax.jit(lambda x, y, xq: jax_spline.eval_natural_spline(
    jax_spline.make_natural_spline(x, y), xq))
_jax_spline_m = jax.jit(lambda x, y: jax_spline.natural_cubic_coeffs(x, y))
_jax_moving_median = jax.jit(jax.vmap(jax_math.moving_median_central, in_axes=(0, None)),
                             static_argnums=1)


# -- ops/stats.py -------------------------------------------------------------

def test_order_keys_equal_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1e3, 5000).astype(np.float32)
    x[:6] = [0.0, -0.0, np.inf, -np.inf, 3.4028235e38, -1e-45]
    want = np.asarray(jax_stats._f32_to_ordkey(jnp.asarray(x)))
    got = stats._f32_to_ordkey(t(x))
    np.testing.assert_array_equal(n(got), want)
    np.testing.assert_array_equal(n(stats._ordkey_to_f32(got)).view(np.int32), x.view(np.int32))


@pytest.mark.parametrize("n_samples,scale", [(300, 5.0), (100, 5.0), (4096, 1e30)])
def test_masked_median_matches_jax(n_samples, scale):
    """Bisection (>= 256 samples) and middle-pair sort (< 256), odd and even
    counts, empty rows, and a range that would stall value bisection."""
    rng = np.random.default_rng(n_samples)
    x = (rng.normal(100, 5, (9, n_samples)) * scale / 5).astype(np.float32)
    good = rng.uniform(size=x.shape) > 0.3
    good[0] = False
    good[1, :] = False
    good[1, :2] = True
    want = np.asarray(_jax_masked_median(jnp.asarray(x), jnp.asarray(good)))
    got = n(stats.masked_median(t(x), t(good)))
    np.testing.assert_array_equal(got, want)


def test_sigma_clip_and_sextractor_mode_match_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(100, 5, (4, 5, 4096)).astype(np.float32)
    x[:, :, :40] += rng.uniform(100, 1000, (4, 5, 40)).astype(np.float32)   # stars
    x[0, 0, 7] = np.nan
    mask = rng.uniform(size=x.shape) < 0.2
    mask[1, 1, :3000] = True                                                # < min_fraction
    np.testing.assert_array_equal(
        n(stats.sigma_clip_mask(t(x), mask=t(mask))),
        np.asarray(_jax_sigma_clip(jnp.asarray(x), mask=jnp.asarray(mask))))
    want = np.asarray(_jax_sextractor(jnp.asarray(x), mask=jnp.asarray(mask), min_fraction=0.5))
    got = n(stats.sextractor_mode(t(x), mask=t(mask), min_fraction=0.5))
    assert np.isnan(want[1, 1]) and np.isnan(got[1, 1])
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=0, equal_nan=True)


def _hist_inputs(seed, n_samples, n_frames):
    """The cases of tests/test_ops_stats_filters.py:73 (NaNs, -1 and
    out-of-range segments, masked samples, a length not a multiple of the
    JAX chunk), bucketed as segment_kde_mode buckets them."""
    rng = np.random.default_rng(seed)
    values = rng.normal(60.0, 5.0, (n_frames, n_samples)).astype(np.float32)
    values[:, ::97] = np.nan
    segs = rng.integers(-1, 13, n_samples).astype(np.int32)
    mask = rng.uniform(size=values.shape) < 0.1
    good = np.isfinite(values) & (segs >= 0) & (segs < 12) & ~mask
    lo = np.nanmin(np.where(good, values, np.nan), axis=1, keepdims=True)
    hi = np.nanmax(np.where(good, values, np.nan), axis=1, keepdims=True)
    b = np.clip(((np.nan_to_num(values) - lo) / (hi - lo) * 512).astype(np.int32), 0, 511)
    return values, segs, mask, good, b


def test_segment_histogram_equals_jax_matmul():
    _, segs, _, good, b = _hist_inputs(9, 70000, 3)
    got = n(seghist.segment_histogram(t(segs), t(b), t(good), 12, 512))
    for f in range(3):
        want = np.asarray(jax_stats._segment_histogram_matmul(
            jnp.asarray(segs), jnp.asarray(b[f]), jnp.asarray(good[f]), 12, 512))
        np.testing.assert_array_equal(got[f], want)
    one = n(seghist.segment_histogram(t(segs), t(b[0]), t(good[0]), 12, 512))
    np.testing.assert_array_equal(one, got[0])


def test_segment_histogram_skips_out_of_range():
    seg = np.array([-1, 0, 1, 2, 5, 1], np.int32)
    bucket = np.array([[0, 3, 511, 2, 1, -4], [1, 1, 1, 1, 1, 1]], np.int32)
    good = np.array([[1, 1, 1, 1, 1, 1], [1, 0, 1, 1, 1, 1]], bool)
    got = n(seghist.segment_histogram(t(seg), t(bucket), t(good), 3, 512))
    want = np.zeros((2, 3, 512), np.float32)
    want[0, 0, 3] = want[0, 1, 511] = want[0, 2, 2] = 1
    want[1, 2, 1] = 1
    want[1, 1, 1] = 2
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("frames, n, resident, want", [
    (64, 1 << 20, 264, 4),        # the prepare stage's 64-frame chunk: one wave of 256 blocks
    (32, 1 << 20, 264, 8),        # the partial chunk: more blocks per frame
    (1, 1 << 20, 264, 32),        # one frame: one block per 32,768 samples
    (3, 100_003, 264, 4),
    (1, 13, 264, 1),              # fewer samples than a warp
    (600, 1 << 20, 264, 1),       # more frames than resident blocks: several waves
])
def test_histogram_blocks_per_frame(frames, n, resident, want):
    assert seghist.blocks_per_frame(frames, n, resident) == want


@pytest.mark.parametrize("offsets, frames, n, want", [
    ((0, 0, 0), 64, 1 << 20, 0),            # torch's aligned allocations
    ((4, 4, 1), 4, 65540, 3),               # all three one element in: a 3-sample head
    ((8, 8, 2), 1, 4001, 2),
    ((0, 4, 1), 4, 65540, -1),              # seg and bucket disagree: the scalar loop
    ((4, 4, 0), 4, 65540, -1),              # good disagrees
    ((0, 0, 0), 3, 100_003, -1),            # rows of frames 1, 2 lose the alignment
    ((0, 0, 0), 1, 100_003, 0),             # one frame: a scalar tail only
    ((0, 0, 0), 2, 4, -1),                  # too few samples for 4-wide loads
])
def test_histogram_vector_head(offsets, frames, n, want):
    """The alignment rule of the kernel's 4-wide loads, on byte addresses
    (seg and bucket int32, good one byte a sample)."""
    base = 1 << 20
    ptrs = [base + off for off in offsets]
    assert seghist.vector_head(*ptrs, frames, n) == want


def test_segment_kde_mode_matches_jax():
    values, segs, mask, _, _ = _hist_inputs(9, 70000, 2)
    got = n(stats.segment_kde_mode(t(values), t(segs), 12, mask=t(mask), min_count=8))
    for f in range(2):
        want = np.asarray(_jax_kde_mode(values[f], segs, n_segments=12, mask=mask[f],
                                        min_count=8, method="scatter"))
        np.testing.assert_allclose(got[f], want, rtol=1e-6, atol=0, equal_nan=True)
    empty = np.where(segs == 4, 5, segs).astype(np.int32)
    assert np.isnan(n(stats.segment_kde_mode(t(values[0]), t(empty), 12))[4])


# -- the 15x15 median (ops/median15.py, ops/filters.py) ---------------------------

def _median_case(name):
    rng = np.random.default_rng(3)
    if name == "random_odd":
        return rng.normal(100.0, 30.0, (3, 33, 47)).astype(np.float32)
    if name == "outlier_flat":
        img = rng.normal(100.0, 1.0, (2, 40, 40)).astype(np.float32)
        img[0, 20, 20] = np.inf           # 3.4e38 after nan_to_num
        img[1, 20, 21] = -np.inf
        img[1, :18, :18] = 7.0            # an all-equal region
        img[0, 30, 30] = np.nan
        return img
    return rng.normal(5.0, 2.0, (1, 6, 5)).astype(np.float32)   # narrower than the halo


@pytest.mark.parametrize("case", ["random_odd", "outlier_flat", "tiny"])
def test_median_filter_bit_identical_to_jax_and_scipy(case):
    img = _median_case(case)
    want = np.asarray(jax_filters.median_filter2d_chunked(img, size=15))
    got = n(filters.median_filter2d_chunked(t(img)))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    for f in range(img.shape[0]):
        sc = ndi.median_filter(np.nan_to_num(img[f]), size=15, mode="reflect")
        np.testing.assert_array_equal(got[f], sc)
    # 2-D input, and the symmetric padding against numpy's:
    np.testing.assert_array_equal(n(filters.median_filter2d_chunked(t(img[0]))), got[0])
    ref = np.pad(img[0], 7, mode="symmetric")
    np.testing.assert_array_equal(n(median15._symmetric_pad(t(img[:1]), 7))[0], ref)


def test_median_filter_row_chunks_and_sizes_match_jax():
    rng = np.random.default_rng(5)
    img = rng.standard_normal((100, 64)).astype(np.float32)
    want = np.asarray(jax_filters.median_filter2d_chunked(img, size=5, chunk_rows=32))
    np.testing.assert_array_equal(n(filters.median_filter2d_chunked(t(img), size=5,
                                                                    chunk_rows=32)), want)
    big = rng.normal(0, 1, (2, 70, 90)).astype(np.float32)
    whole = n(median15.median_filter_plain(t(big)))
    rows = n(median15.median_filter_plain(t(big), budget_bytes=15 * 15 * 4 * 104 * 9))
    np.testing.assert_array_equal(rows, whole)


@pytest.mark.parametrize("mode", ["reflect", "nan"])
def test_median_filter2d_matches_jax(mode):
    rng = np.random.default_rng(4)
    img = rng.standard_normal((40, 37)).astype(np.float32)
    img[3, 4] = np.nan
    for size in (3, 5):
        want = np.asarray(jax_filters.median_filter2d(img, size=size, mode=mode))
        np.testing.assert_array_equal(n(filters.median_filter2d(t(img), size=size, mode=mode)),
                                      want)


# A numpy model of the median kernel's selection (ops/csrc/median15.cu): 8
# vertically adjacent windows share the probes of each pass and count them
# per strip row; the passes end when the strip holds <= 16 keys in the
# union of the brackets (one sorted list, walked per output) or when every
# bracket holds <= 12 window keys or one key.  The probes are placed as the
# kernel places them, with float32 fractions and a high-word product, and
# never at -0.0 (the kernel compares values as floats, which tie -0.0 with
# +0.0); a bracket of just -0.0 and +0.0 is finished by counting -0.0 keys.
_MG, _MS, _G, _NP = 16, 12, 8, 8


def _ordkeys(x):
    i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
    return np.where(i < 0, i ^ 0x7fffffff, i)


def _probe(lo, hi, q, n):
    d = (hi - lo) & 0xffffffff
    frac = int(np.float32(q + 1) * (np.float32(4294967296.0) / np.float32(n + 1)))
    m = lo + min(max((d * frac) >> 32, 1), d - 1)
    return (0 if hi > 0 else -2) if m == -1 else m      # never -0.0 (the kernel's float compares)


def _strip_select(strip):
    """The 113th smallest key of the 8 windows (rows g..g+14) of a (22, 15)
    strip, and the number of passes."""
    lo = [int(strip.min()) - 1] * _G
    hi = [int(strip.max())] * _G
    cl, ch = [0] * _G, [225] * _G
    sl, sh = [0] * _G, [strip.size] * _G
    passes = 0
    while True:
        a, b = int(np.argmin(lo)), int(np.argmax(hi))
        LO, HI = lo[a], hi[b]
        if sh[b] - sl[a] <= _MG:
            rows, cols = np.nonzero((strip > LO) & (strip <= HI))
            order = np.argsort(strip[rows, cols], kind="stable")
            keys, rows = strip[rows, cols][order], rows[order]
            out = []
            for g in range(_G):
                sel = keys[(keys > lo[g]) & (rows >= g) & (rows < g + 15)]
                out.append(int(sel[113 - cl[g] - 1]))
            return out, passes
        open_ = [hi[g] - lo[g] > 1 and ch[g] - cl[g] > _MS and (lo[g], hi[g]) != (-2, 0)
                 for g in range(_G)]
        if not any(open_):
            out = []
            for g in range(_G):
                win = strip[g:g + 15].ravel()
                sel = np.sort(win[(win > lo[g]) & (win <= hi[g])])
                if (lo[g], hi[g]) == (-2, 0):          # -0.0 and +0.0: count the -0.0 keys
                    out.append(-1 if 113 - cl[g] <= (win == -1).sum() else 0)
                    continue
                assert hi[g] - lo[g] <= 1 or len(sel) <= _MS
                out.append(hi[g] if hi[g] - lo[g] <= 1 else int(sel[113 - cl[g] - 1]))
            return out, passes
        brackets = list(dict.fromkeys((lo[g], hi[g]) for g in range(_G) if open_[g]))
        nb = len(brackets)
        probes = [_probe(*brackets[j % nb], j // nb, (_NP - 1 - j % nb) // nb + 1)
                  for j in range(_NP)]
        passes += 1
        assert passes <= 32
        le = (strip[:, :, None] <= np.array(probes)).sum(axis=1)          # (22, 8)
        cum = np.vstack([np.zeros(_NP, np.int64), np.cumsum(le, axis=0)])
        for g in range(_G):
            for m, c, s_ in zip(probes, cum[g + 15] - cum[g], cum[-1]):
                if c >= 113:
                    if m < hi[g]:
                        hi[g], ch[g], sh[g] = m, int(c), int(s_)
                elif m > lo[g]:
                    lo[g], cl[g], sl[g] = m, int(c), int(s_)


def _median_model(x):
    """The model over (F, H, W) frames: float32 medians and the passes per strip."""
    F, H, W = x.shape
    keys = np.empty((F, H, W), np.int64)
    passes = []
    ri_all = n(median15.reflect_indices(torch.arange(-7, H + _G + 7), H))
    ci_all = n(median15.reflect_indices(torch.arange(-7, W + 7), W))
    for f in range(F):
        k = _ordkeys(x[f])
        for y0 in range(0, H, _G):
            for xx in range(W):
                got, p = _strip_select(k[np.ix_(ri_all[y0:y0 + 22], ci_all[xx:xx + 15])])
                passes.append(p)
                rows = min(_G, H - y0)
                keys[f, y0:y0 + rows, xx] = got[:rows]
    back = np.where(keys < 0, keys ^ 0x7fffffff, keys) & 0xffffffff
    return back.astype(np.uint32).view(np.float32), np.array(passes)


@pytest.mark.parametrize("case", ["noise", "residual", "few_values", "signed_zeros",
                                  "zeros_only", "gradient", "outliers", "tiny"])
def test_median_kernel_selection_model_matches_plain(case):
    """The kernel's shared-probe selection, modelled in numpy, equals the
    plain median bit for bit on random windows, tie-heavy ones (a few
    distinct values, signed zeros, only -0.0 and +0.0), windows whose
    medians differ (a steep gradient), 3.4e38 outliers and a frame
    narrower than the halo."""
    rng = np.random.default_rng(11)
    x = {"noise": lambda: rng.normal(100, 30, (1, 24, 20)),
         "residual": lambda: rng.normal(0, 15, (1, 24, 20)),
         "few_values": lambda: rng.choice([1.0, 2.0, 3.0], (1, 24, 20)),
         "signed_zeros": lambda: rng.choice([0.0, -0.0, 1.0, -1.0], (1, 17, 19)),
         "zeros_only": lambda: rng.choice([0.0, -0.0], (1, 24, 20)),
         "gradient": lambda: np.arange(24)[None, :, None] * 10.0 + rng.normal(0, 1, (1, 24, 20)),
         "outliers": lambda: np.where(rng.uniform(size=(1, 24, 20)) < 0.05, 3.4028235e38,
                                      rng.normal(100, 30, (1, 24, 20))),
         "tiny": lambda: rng.normal(5, 2, (2, 6, 5))}[case]().astype(np.float32)
    got, passes = _median_model(x)
    want = n(median15.median_filter_plain(t(x)))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    if case in ("noise", "residual"):
        assert passes.mean() < 4.0, passes.mean()


def test_median_dispatch_cpu_uses_plain():
    """On the CPU the wrappers run the plain versions; the kernels' launch
    counts stay put."""
    from photometry_tpu_torch.ops._kernels import MEDIAN15, SEGMENT_HIST
    before = (MEDIAN15.launches, SEGMENT_HIST.launches)
    filters.median_filter2d_chunked(t(_median_case("tiny")))
    seghist.segment_histogram(t(np.zeros(4, np.int32)), t(np.zeros((1, 4), np.int32)),
                              t(np.ones((1, 4), bool)), 1, 8)
    assert (MEDIAN15.launches, SEGMENT_HIST.launches) == before
    with pytest.raises(ValueError):
        median15.median15_cuda(t(_median_case("tiny")))
    with pytest.raises(ValueError):
        seghist.segment_histogram_cuda(t(np.zeros(4, np.int32)), t(np.zeros((1, 4), np.int32)),
                                       t(np.ones((1, 4), bool)), 1, 8)


# -- splines, zoom, moving medians, time smoothing -------------------------------

def test_natural_spline_matches_jax():
    rng = np.random.default_rng(6)
    xk = np.sort(rng.uniform(0, 100, 14)).astype(np.float32)
    yk = rng.normal(0, 1, (3, 14)).astype(np.float32)
    xq = rng.uniform(-5, 105, (20, 30)).astype(np.float32)
    got = n(spline.eval_natural_spline(spline.make_natural_spline(t(xk), t(yk)), t(xq)))
    for f in range(3):
        np.testing.assert_allclose(got[f], np.asarray(_jax_spline(xk, yk[f], xq)),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(n(spline.natural_cubic_coeffs(t(xk), t(yk)))[f],
                                   np.asarray(_jax_spline_m(xk, yk[f])), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mesh_shape,out_shape", [((6, 7), (96, 112)), ((1, 4), (16, 64)),
                                                  ((32, 32), (2048, 2048))])
def test_spline_zoom_matches_jax_and_scipy(mesh_shape, out_shape):
    rng = np.random.default_rng(7)
    mesh = rng.normal(0, 1, mesh_shape).astype(np.float32)
    got = n(zoom.spline_zoom(t(mesh), out_shape))
    np.testing.assert_allclose(got, np.asarray(jax_zoom.spline_zoom(mesh, out_shape)),
                               rtol=0, atol=1e-5)
    if max(out_shape) <= 128:
        want = ndi.zoom(mesh.astype(np.float64), np.divide(out_shape, mesh_shape), order=3,
                        mode="reflect", grid_mode=True)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_moving_median_central_matches_jax():
    rng = np.random.default_rng(8)
    x = rng.normal(0, 1, (4, 21)).astype(np.float32)
    x[1, 3] = np.nan
    x[2, :] = np.nan
    for width in (3, 4):
        want = np.asarray(_jax_moving_median(jnp.asarray(x), width))
        np.testing.assert_array_equal(n(mathutils.moving_median_central(t(x), width, dim=-1)),
                                      want)
    np.testing.assert_array_equal(n(mathutils.moving_median_central(t(x.T), 3)),
                                  n(mathutils.moving_median_central(t(x), 3, dim=-1)).T)


@pytest.mark.parametrize("window", [3, 9])
def test_time_moving_nanmean_matches_jax(window):
    rng = np.random.default_rng(window)
    x = (100 + 10 * rng.standard_normal((37, 8, 9))).astype(np.float32)
    x[3, 5, 5] = np.nan
    x[:, 0, 0] = np.nan
    want = np.asarray(jax_filters.time_moving_nanmean(jnp.asarray(x), window))
    got = n(filters.time_moving_nanmean(t(x), window))
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-4, equal_nan=True)
    blocked = n(filters.time_moving_nanmean_blocked(t(x), window, block=8))
    np.testing.assert_allclose(blocked, jax_filters.time_moving_nanmean_blocked(x, window, 8),
                               rtol=0, atol=5e-4, equal_nan=True)


# -- ops/background.py ------------------------------------------------------------

def _sky(seed, nf=3, H=128, W=128, glow=True):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    r_img = np.hypot(xx + 3000, yy + 1500)
    imgs = []
    for k in range(nf):
        img = 100.0 + 10 * k * xx / W + rng.normal(0, 2.0, (H, W))
        if glow:
            img += 80.0 * np.exp(-(r_img - r_img.min()) / 150.0)
        for _ in range(25):
            r, c = rng.integers(5, H - 5, 2)
            img[r - 1:r + 2, c - 1:c + 2] += 800.0
        imgs.append(img)
    imgs = np.asarray(imgs, np.float32)
    imgs[1, 5:9, 5:9] = np.nan
    imgs[2, 40:44, 60:64] = 9e4                 # above flux_cutoff
    return imgs, r_img


@pytest.mark.parametrize("case", ["tiled", "radial", "subccd_fallback", "masked"])
def test_estimate_background_matches_jax(case):
    imgs, r_img = _sky(10 + len(case))
    mask = None
    kw = {"tile": 32}
    if case == "radial":
        kw.update(radius_image=r_img, radial_cutoff=float(r_img.min()), radial_pixel_step=15)
    elif case == "subccd_fallback":
        kw.update(radius_image=background.radial_coordinates((128, 128), 3, 2, 0), tile=21)
    elif case == "masked":
        imgs[0] = -5.0                           # a fully masked frame
        mask = np.zeros(imgs.shape[1:], bool)
        mask[:, :20] = True
        kw.update(radius_image=r_img, radial_cutoff=float(r_img.min()), radial_pixel_step=15)
    want, want_mask = jax_bg.estimate_background(imgs, mask=mask, **kw)
    got, got_mask = background.estimate_background(t(imgs), None if mask is None else t(mask),
                                                   **kw)
    np.testing.assert_array_equal(n(got_mask), np.asarray(want_mask))
    got, want = n(got), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    if case == "subccd_fallback":
        # One-ulp log10 differences move samples across bucket edges of the
        # 4-px rings (measured: max 0.083, p99 0.019-0.053 e-/s on 100-200):
        d = np.abs(got - want)
        assert np.percentile(d, 99) < 0.1 and d.max() < 0.25, (np.percentile(d, 99), d.max())
    else:
        np.testing.assert_allclose(got, want, rtol=BKG_RTOL, atol=BKG_ATOL, equal_nan=True)


def test_estimate_background_hist_stride_2_matches_jax():
    """The full-CCD rule (histograms of every second row and column), pinned
    on both sides: the JAX package only takes it off the CPU."""
    imgs, r_img = _sky(21)
    r = r_img.astype(np.float32)
    cutoff, step = float(r.min()), 15
    bins = np.arange(cutoff, float(r.max()) + step, step)
    n_rings = len(bins) - 1
    ring = np.clip(((r - np.float32(cutoff)) / np.float32(step)).astype(np.int32), -1,
                   n_rings - 1)
    base = ~np.isfinite(imgs) | (imgs > 8e4) | (imgs < 0)
    want = jax_bg._estimate_background_jit(
        jnp.asarray(imgs), jnp.asarray(base), jnp.asarray(r), jnp.asarray(ring),
        jnp.asarray(bins[1:] - step / 2, jnp.float32), n_rings, 3, 32, 3, True,
        hist_method="scatter", hist_stride=2)
    got, got_mask = background.estimate_background(t(imgs), radius_image=r, radial_cutoff=cutoff,
                                                   radial_pixel_step=step, tile=32,
                                                   hist_stride=2)
    np.testing.assert_array_equal(n(got_mask), base)
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=BKG_RTOL, atol=BKG_ATOL)
    assert background.default_hist_stride((2048, 2048), "cuda") == 2
    assert background.default_hist_stride((2048, 2048), "cpu") == 1
    assert background.default_hist_stride((96, 96), "cuda") == 1


# -- host modules: pixel flags, fixes, FITS ingestion, discovery -------------------------

def test_pixelflags_match_jax():
    rng = np.random.default_rng(12)
    data = rng.normal(100, 5, (64, 2048 // 16)).astype(np.float32)
    headers = [{"TSTART": 1325.5, "TSTOP": 1325.52, "CAMERA": 1, "CCD": 4, "FFIINDEX": 4700},
               {"TSTART": 1464.1, "TSTOP": 1464.12, "CAMERA": 1, "CCD": 2},
               {"TSTART": 1500.0, "TSTOP": 1500.02, "CAMERA": 2, "CCD": 1}]
    for hdr in headers:
        for is_tess in (True, False):
            np.testing.assert_array_equal(
                pixelflags.manual_exclude_mask(data, hdr, is_tess),
                jax_pixelflags.manual_exclude_mask(data, hdr, is_tess))
    assert pixelflags.manual_exclude_mask(np.zeros((4, 4)), headers[2]).all()
    imgs = rng.normal(100, 5, (3, 40, 40)).astype(np.float32)
    imgs[0, 10, 10] = np.nan
    sumimage = rng.normal(100, 1, (40, 40))
    sumimage[5, 5] = np.nan
    want = jax_pixelflags.shenanigans_residual(np.nan_to_num(imgs), sumimage)
    got = n(pixelflags.shenanigans_residual(torch.nan_to_num(t(imgs)), sumimage))
    np.testing.assert_array_equal(got, want)


def test_time_offset_matches_jax():
    tt = np.linspace(1325.0, 1350.0, 11)
    for hdr in ({"DATA_REL": 5, "CAMERA": 2, "CCD": 3},
                {"DATA_REL": 27, "PROCVER": "spoc-4.0.14-20200108", "CAMERA": 1, "CCD": 1},
                {"DATA_REL": 29, "PROCVER": "spoc-4.0.20-20200220", "CAMERA": 4, "CCD": 4},
                {"DATA_REL": 31, "CAMERA": 1, "CCD": 1}):
        for pos in ("start", "mid", "end"):
            got = fixes.time_offset(tt, hdr, datatype="ffi", timepos=pos, return_flag=True)
            want = jax_fixes.time_offset(tt, hdr, datatype="ffi", timepos=pos, return_flag=True)
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1] == want[1]
    with pytest.raises(ValueError):
        fixes.time_offset(tt, {"DATA_REL": 27, "CAMERA": 1, "CCD": 1})


@pytest.fixture(scope="module")
def raw_sector(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("raw_ffis"))
    sim = simulate_sector(SimConfig(shape=(48, 40), n_times=2, n_stars=6, seed=4))
    paths = sim.write_ffis(d, raw_geometry=True, gzip=False)
    tpf = sim.write_tpf(d, int(sim.starid[0]), n_times=30)
    return sim, d, paths, tpf


def test_read_ffi_and_tpf_match_jax(raw_sector):
    _, _, paths, tpf = raw_sector
    got, want = tess.read_ffi(paths[0]), jax_tess.read_ffi(paths[0])
    assert got.is_tess and want.is_tess and got.data.shape == (2048, 2048)
    for k in ("data", "uncertainty", "smear", "vsmear"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    assert got.header == want.header
    np.testing.assert_array_equal(got.wcs.crpix, want.wcs.crpix)
    assert got.wcs.to_header().to_bytes() == want.wcs.to_header().to_bytes()
    a, b = tess.read_tpf(tpf), jax_tess.read_tpf(tpf)
    for k in ("time", "timecorr", "cadenceno", "quality", "flux", "flux_err", "pos_corr"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    assert (a.starid, a.corner_row, a.corner_col, a.cadence) == \
        (b.starid, b.corner_row, b.corner_col, b.cadence)


def test_discovery_matches_jax(raw_sector):
    _, d, _, _ = raw_sector
    discovery.clear_cache()
    jax_discovery.clear_cache()
    assert discovery.find_ffi_files(d) == jax_discovery.find_ffi_files(d)
    assert len(discovery.find_ffi_files(d, sector=1, camera=3, ccd=2)) == 2
    assert discovery.find_ffi_files(d, camera=1) == []
    assert discovery.find_tpf_files(d, camera=3, ccd=2, findmax=5) == \
        jax_discovery.find_tpf_files(d, camera=3, ccd=2, findmax=5)
    name = "tess2018206192942-s0027-1-1-0120-s_ffic.fits.gz"
    assert discovery.parse_ffi_filename(name) == jax_discovery.parse_ffi_filename(name) == \
        {"sector": 27, "camera": 1, "ccd": 1}
    assert discovery.parse_ffi_filename("other.fits") is None
