"""Port parity: ops/labeling, ops/filters and models/k2p2 (JAX vs torch on CPU).

Labels and K2P2 masks must be bit-identical; the blur agrees to float32
matmul rounding.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from torch_parity import n, t

from photometry_tpu.models.k2p2 import build_masks_batch as jax_build_masks
from photometry_tpu.core.engine import DEFAULT_K2P2_PARAMS
from photometry_tpu.ops import filters as jf, labeling as jl
from photometry_tpu_torch.models.k2p2 import K2P2Params, build_masks_batch
from photometry_tpu_torch.ops import filters as tf, labeling as tl

H = W = 21
K = 4


def _gauss(img, r, c, amp, s):
    yy, xx = np.mgrid[0:img.shape[0], 0:img.shape[1]].astype(np.float64)
    img += (amp * np.exp(-0.5 * ((yy - r) ** 2 + (xx - c) ** 2) / s ** 2)).astype(img.dtype)


def _corpus(n_random=64, seed=5):
    """Random 1-3 star stamps (as tests/test_tiebreak_corpus.py:_corpus) plus
    the hand-made cases of tests/test_k2p2_details.py: a close pair, a
    saturated bleed column on a bright star, a no-flux stamp and a stamp
    with NaN (uncollected) pixels."""
    rng = np.random.default_rng(seed)
    n_all = n_random + 4
    imgs = np.zeros((n_all, H, W), np.float32)
    cat_col = np.full((n_all, K), 1e9, np.float32)
    cat_row = np.full((n_all, K), 1e9, np.float32)
    cat_tmag = np.full((n_all, K), 30.0, np.float32)
    cat_valid = np.zeros((n_all, K), bool)
    for i in range(n_random):
        n_star = int(rng.integers(1, 4))
        amps = np.sort(rng.uniform(80, 4000, n_star))[::-1]
        for j in range(n_star):
            r, c = rng.uniform(5.0, H - 6.0), rng.uniform(5.0, W - 6.0)
            _gauss(imgs[i], r, c, amps[j], rng.uniform(1.0, 1.6))
            cat_row[i, j], cat_col[i, j] = r, c
            cat_tmag[i, j] = rng.uniform(10.0, 14.0)
            cat_valid[i, j] = True
        imgs[i] += rng.normal(0, 3.0, (H, W)).astype(np.float32)
    i = n_random                                   # close pair
    _gauss(imgs[i], 10.0, 9.0, 3000, 1.2)
    _gauss(imgs[i], 10.3, 11.6, 1500, 1.2)
    imgs[i] += rng.normal(0, 0.5, (H, W)).astype(np.float32)
    cat_row[i, :2], cat_col[i, :2], cat_tmag[i, :2], cat_valid[i, :2] = \
        [10.0, 10.3], [9.0, 11.6], [9.0, 9.8], True
    i += 1                                         # saturated bleed column
    _gauss(imgs[i], 10.0, 10.0, 3e6 / (2 * np.pi * 1.44), 1.2)
    imgs[i, 2:19, 10] = 50000.0
    imgs[i] += rng.normal(0, 0.5, (H, W)).astype(np.float32)
    cat_row[i, 0], cat_col[i, 0], cat_tmag[i, 0], cat_valid[i, 0] = 10.0, 10.0, 4.5, True
    i += 1                                         # no flux at all
    imgs[i] = -np.abs(rng.normal(0, 0.3, (H, W)))
    cat_row[i, 0], cat_col[i, 0], cat_tmag[i, 0], cat_valid[i, 0] = 10.0, 10.0, 14.0, True
    i += 1                                         # uncollected pixels
    _gauss(imgs[i], 8.0, 12.0, 2000, 1.3)
    imgs[i] += rng.normal(0, 2.0, (H, W)).astype(np.float32)
    imgs[i, :, :4] = np.nan
    cat_row[i, 0], cat_col[i, 0], cat_tmag[i, 0], cat_valid[i, 0] = 8.0, 12.0, 11.0, True
    first = np.argmax(cat_valid, axis=1)
    ar = np.arange(n_all)
    return (imgs, cat_col, cat_row, cat_tmag, cat_valid,
            cat_row[ar, first], cat_col[ar, first], cat_tmag[ar, first])


@pytest.fixture(scope="module")
def corpus():
    return _corpus()


@pytest.mark.parametrize("params", [DEFAULT_K2P2_PARAMS,
                                    DEFAULT_K2P2_PARAMS._replace(segmentation=False)],
                         ids=["watershed", "dbscan-only"])
def test_build_masks_batch_bit_identical(corpus, params):
    imgs, cc, cr, ct, cv, tr, tc, tm = corpus
    sid = np.tile(np.arange(1, K + 1, dtype=np.int64), (len(imgs), 1))
    want = jax_build_masks(jnp.asarray(imgs), jnp.asarray(cc), jnp.asarray(cr),
                           jnp.asarray(ct), jnp.asarray(sid), jnp.asarray(cv),
                           jnp.asarray(tr), jnp.asarray(tc), jnp.asarray(tm),
                           params=params)
    got = build_masks_batch(t(imgs), t(cc), t(cr), t(ct), t(sid), t(cv), t(tr), t(tc),
                            t(tm), params=K2P2Params(**params._asdict()))
    for key in ("mask", "found_mask", "no_flux", "in_mask", "edge", "mask_size"):
        np.testing.assert_array_equal(n(got[key]), n(want[key]), err_msg=key)
    np.testing.assert_allclose(n(got["cut"]), n(want["cut"]), rtol=1e-5)
    masks = n(got["mask"])
    assert n(got["found_mask"]).sum() >= len(imgs) - 3   # the corpus is mostly real stars
    assert masks[-2].sum() <= 9 and n(got["no_flux"])[-2]  # no-flux fallback
    if params.segmentation:
        assert masks[-3][2:19, 10].all()                  # bleed column adopted


def _label_inputs(seed=2, n_img=6, shape=(19, 23)):
    rng = np.random.default_rng(seed)
    return rng.uniform(size=shape + (n_img,)) < 0.45


@pytest.mark.parametrize("connectivity", [1, 2])
def test_label_components_equal(connectivity):
    m = _label_inputs()
    want = jl.label_components(jnp.asarray(m), connectivity=connectivity)
    got = tl.label_components(t(m), connectivity=connectivity)
    np.testing.assert_array_equal(n(got), n(want))
    # and without a batch axis:
    np.testing.assert_array_equal(n(tl.label_components(t(m[..., 0]))),
                                  n(jl.label_components(jnp.asarray(m[..., 0]))))


@pytest.mark.parametrize("min_samples", [1, 4])
def test_dbscan_labels_equal(min_samples):
    m = _label_inputs(seed=3)
    want = jl.dbscan_labels(jnp.asarray(m), min_samples=min_samples)
    got = tl.dbscan_labels(t(m), min_samples=min_samples)
    np.testing.assert_array_equal(n(got), n(want))


@pytest.mark.parametrize("connectivity", [1, 2])
def test_watershed_segment_equal(connectivity):
    """Plateaus (quantised elevation) force exact ties, decided by scan order."""
    rng = np.random.default_rng(4)
    elev = np.round(rng.uniform(0, 6, (17, 17, 8))).astype(np.float32)
    mask = rng.uniform(size=elev.shape) < 0.8
    markers = np.zeros(elev.shape, np.int32)
    for b in range(elev.shape[2]):
        pos = rng.integers(0, 17, (3, 2))
        markers[pos[:, 0], pos[:, 1], b] = [1, 2, 3]
    want = jl.watershed_segment(jnp.asarray(elev), jnp.asarray(markers),
                                jnp.asarray(mask), connectivity=connectivity)
    got = tl.watershed_segment(t(elev), t(markers), t(mask), connectivity=connectivity)
    np.testing.assert_array_equal(n(got), n(want))


@pytest.mark.parametrize("shape,sigma", [((21, 21), 0.5), ((17, 33), 1.3), ((5, 9), 3.0)])
def test_gaussian_blur2d(shape, sigma):
    rng = np.random.default_rng(6)
    img = rng.normal(0, 100, shape).astype(np.float32)
    want = n(jf.gaussian_blur2d(jnp.asarray(img), sigma))
    got = n(tf.gaussian_blur2d(t(img[None]), sigma))[0]
    # float32 matmul in another summation order: a few ulp of the row scale
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)
