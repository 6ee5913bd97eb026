"""Port parity: ops/bandext (JAX banded kernel in interpret mode and the JAX
gather extraction vs the port's plain version, on CPU), on float32 and on
bfloat16 cubes.

Tolerance: rtol 1e-4, atol 1e-3 on floats (float32 sums in another order,
as tests/test_bandext.py:41), booleans and counts equal.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from torch_parity import assert_extraction_parity, n, t

from photometry_tpu.core.engine import _extract_flux_batch
from photometry_tpu.ops.bandext import BH, TW, band_extract_flux_batch as jax_band
from photometry_tpu_torch.ops import bandext


def _inputs(T=16, H=128, W=256, N=14, h=17, w=17, seed=0):
    """tests/test_bandext.py:_inputs — NaN pixels, an all-zero frame, NaN
    err and background, shenanigans flags."""
    rng = np.random.default_rng(seed)
    imgs = rng.normal(100, 5, (T, H, W)).astype(np.float32)
    imgs[1, 10, 10] = np.nan
    imgs[3] = 0.0
    errs = (np.sqrt(np.abs(imgs)) + 1.0).astype(np.float32)
    errs[2, 20, 20] = np.nan
    bkgs = rng.normal(20, 1, (T, H, W)).astype(np.float32)
    bkgs[4, 30, 30] = np.nan
    pflags = (rng.uniform(size=(T, H, W)) < 0.01).astype(np.uint8) * 4
    r0s = rng.integers(0, H - h, N).astype(np.int32)
    c0s = rng.integers(0, W - w, N).astype(np.int32)
    masks = rng.uniform(size=(N, h, w)) < 0.4
    masks[:, h // 2, w // 2] = True
    return imgs, errs, bkgs, pflags, masks, r0s, c0s


def _case(name):
    imgs, errs, bkgs, pflags, masks, r0s, c0s = _inputs(T=13 if name == "remainder" else 16)
    windows = None
    if name == "straddling":
        # corners across the band boundary (row 64) and the tile boundary (col 128):
        r0s[:3] = [BH - 8, 10, BH - 1]
        c0s[:3] = [TW - 8, TW - 16, TW - 1]
    if name == "windows":
        windows = np.zeros_like(masks)
        windows[:, 2:15, 3:16] = True
        masks &= windows
        masks[0] = False                   # an empty mask: all outputs NaN
        pflags[:, r0s[1]:r0s[1] + 17, c0s[1]:c0s[1] + 17] = 0
        pflags[5, r0s[1], c0s[1]] = 4      # outside target 1's window: ignored
    return imgs, errs, bkgs, pflags, masks, r0s, c0s, windows


@pytest.mark.parametrize("name", ["base", "remainder", "straddling", "windows"])
def test_port_matches_jax_extraction(name):
    imgs, errs, bkgs, pflags, masks, r0s, c0s, windows = _case(name)
    h, w = masks.shape[1:]
    got = bandext.band_extract_flux_batch(t(imgs), t(errs), t(bkgs), t(pflags), t(masks),
                                          t(r0s), t(c0s), h, w,
                                          windows=None if windows is None else t(windows))
    want_gather = _extract_flux_batch(
        jnp.asarray(imgs), jnp.asarray(errs), jnp.asarray(bkgs), jnp.asarray(pflags),
        jnp.asarray(masks), jnp.asarray(r0s), jnp.asarray(c0s), h, w,
        None if windows is None else jnp.asarray(windows))
    assert_extraction_parity(got, want_gather)
    want_band = jax_band(imgs, errs, bkgs, pflags, masks, r0s, c0s, h, w, t_block=8,
                         interpret=True, windows=windows)
    assert_extraction_parity(got, want_band)
    if name == "windows":
        assert np.isnan(n(got[0])[0]).all()
        assert not n(got[4])[1, 5]


def test_plain_sums_chunking_is_exact(monkeypatch):
    """Target chunks of the plain version do not change any sum."""
    imgs, errs, bkgs, pflags, masks, r0s, c0s = _inputs(T=5, N=9)
    args = [t(a) for a in (imgs, errs, bkgs, pflags, masks, r0s, c0s)]
    whole = bandext.band_sums_plain(*args)
    monkeypatch.setattr(bandext, "_PLAIN_BLOCK", 5 * 17 * 17 * 2)
    chunked = bandext.band_sums_plain(*args)
    np.testing.assert_array_equal(n(chunked), n(whole))


def test_window_bbox():
    mw = np.zeros((3, 6, 7), np.uint8)
    mw[0, 1:4, 2:6] = 2
    mw[1, 5, 0] = 1
    box = n(bandext._window_bbox(t(mw)))
    np.testing.assert_array_equal(box, [[1, 4, 2, 6], [5, 6, 0, 1], [0, 0, 0, 0]])


def _kernel_lists(code, chunk):
    """A numpy model of the band kernel's compaction for one target: its
    bounding box (of the nonzero codes) row-major in chunks of ``chunk``
    pixels, each chunk as (mask pixels, window-only pixels) in box order."""
    nz = np.argwhere(code != 0)
    if not len(nz):
        return []
    (i0, j0), (i1, j1) = nz.min(axis=0), nz.max(axis=0) + 1
    box = [(i, j) for i in range(i0, i1) for j in range(j0, j1)]
    return [([p for p in box[a:a + chunk] if code[p] & 1],
             [p for p in box[a:a + chunk] if code[p] == 2]) for a in range(0, len(box), chunk)]


@pytest.mark.parametrize("hw, chunk", [(17, 2048), (60, 2048), (17, 64)])
def test_kernel_compaction_model_sums_to_plain(hw, chunk):
    """The kernel's pixel lists (mask pixels, then window-only pixels, per
    chunk of the box), summed as the kernel sums them, give the plain sums:
    every mask pixel once, every window-only pixel's flag once, counts
    exact; a 60x60 box takes two chunks of 2,048 and a 17x17 one five of 64."""
    rng = np.random.default_rng(8)
    T, H, W, N = 3, 80, 96, 6
    imgs = rng.normal(100, 5, (T, H, W)).astype(np.float32)
    imgs[1, 10:30, 10:30] = np.nan
    imgs[2, 40:60, 40:60] = 0.0
    errs = (np.sqrt(np.abs(imgs)) + 1.0).astype(np.float32)
    bkgs = rng.normal(20, 1, (T, H, W)).astype(np.float32)
    flags = (rng.uniform(size=(T, H, W)) < 0.1).astype(np.uint8) * 4
    masks = rng.uniform(size=(N, hw, hw)) < 0.4
    masks[0] = False
    masks[1] = True
    windows = np.ones_like(masks)
    windows[2:, :, hw - 5:] = False
    masks &= windows
    r0s = rng.integers(0, H - hw + 1, N).astype(np.int32)
    c0s = rng.integers(0, W - hw + 1, N).astype(np.int32)
    code = masks.astype(np.uint8) | (windows.astype(np.uint8) << 1)
    got = np.zeros((N, 10, T))
    for k in range(N):
        lists = _kernel_lists(code[k], chunk)
        listed = [p for mask, win in lists for p in mask + win]
        assert sorted(listed) == sorted(map(tuple, np.argwhere(code[k] != 0)))
        for mask, win in lists:
            for (i, j) in mask + win:
                pix = (slice(None), r0s[k] + i, c0s[k] + j)
                f = (flags[pix] & 4) != 0
                if code[k, i, j] & 2:
                    got[k, 9] += f
                if not code[k, i, j] & 1:
                    continue
                x, e, b = imgs[pix], errs[pix], bkgs[pix]
                fin = np.isfinite(x)
                got[k, 0] += np.where(fin, x, 0)
                got[k, 1] += fin
                got[k, 2] += x == 0
                wgt = np.where(fin & (x > 0), x, 0)
                got[k, 3] += wgt
                got[k, 4] += wgt * j
                got[k, 5] += wgt * i
                got[k, 6] += np.where(np.isfinite(e), e * e, 0)
                got[k, 7] += np.where(np.isfinite(b), b, 0)
                got[k, 8] += np.isfinite(b)
    want = n(bandext.band_sums_plain(*[t(a) for a in (imgs, errs, bkgs, flags, masks, r0s,
                                                       c0s)], windows=t(windows)))
    np.testing.assert_array_equal(got[:, [1, 2, 8, 9]], want[:, [1, 2, 8, 9]])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def test_frame_order_puts_rows_back():
    rng = np.random.default_rng(9)
    r0s = t(rng.integers(0, 50, 40).astype(np.int32))
    c0s = t(rng.integers(0, 70, 40).astype(np.int32))
    order = bandext._frame_order(r0s, c0s, 80)
    key = n(r0s).astype(np.int64) * 80 + n(c0s)
    assert np.all(np.diff(key[n(order)]) >= 0)
    sums = t(rng.normal(size=(40, 10, 3)).astype(np.float32))
    back = torch.empty_like(sums).index_copy_(0, order, sums[order])
    assert torch.equal(back, sums)


def test_cuda_path_refuses_cpu_tensors():
    imgs, errs, bkgs, pflags, masks, r0s, c0s = _inputs(T=5, N=2)
    with pytest.raises(ValueError, match="CUDA"):
        bandext.band_sums_cuda(*[t(a) for a in (imgs, errs, bkgs, pflags, masks, r0s, c0s)])


def bf16(x):
    """A JAX bfloat16 array -> CPU bfloat16 tensor, bit for bit."""
    return torch.from_numpy(np.array(x).view(np.uint16)).view(torch.bfloat16)


def test_bf16_cubes_match_jax_band_kernel():
    """bfloat16 cubes (tests/test_bandext.py:106's inputs, cast by JAX): the
    port's plain path against the JAX band kernel in interpret mode on the
    same bits (rtol 1e-4, atol 1e-3, booleans equal).  The plain sums widen
    after the gather, so they equal the float32 sums of the widened cube bit
    for bit, and their counts equal numpy's on that cube."""
    imgs, errs, bkgs, pflags, masks, r0s, c0s = _inputs()
    h, w = masks.shape[1:]
    j16 = [jnp.asarray(a, jnp.bfloat16) for a in (imgs, errs, bkgs)]
    t16 = [bf16(a) for a in j16]
    rest = [t(a) for a in (pflags, masks, r0s, c0s)]
    got = bandext.band_extract_flux_batch(*t16, *rest, h, w)
    want = jax_band(*j16, pflags, masks, r0s, c0s, h, w, t_block=8, interpret=True)
    assert_extraction_parity(got, want)
    sums = bandext.band_sums_plain(*t16, *rest)
    assert torch.equal(sums, bandext.band_sums_plain(*[x.float() for x in t16], *rest))
    wide = [n(x.float()) for x in t16]
    rr = r0s[:, None, None] + np.arange(h)[None, :, None]
    cc = c0s[:, None, None] + np.arange(w)[None, None, :]
    stamp = wide[0][:, rr, cc]                                 # (T, N, h, w)
    for q, count in ((1, np.isfinite(stamp)), (2, stamp == 0),
                     (8, np.isfinite(wide[2][:, rr, cc]))):
        np.testing.assert_array_equal(n(sums[:, q]), (count & masks).sum(axis=(2, 3)).T)
