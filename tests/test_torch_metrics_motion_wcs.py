"""Port parity: core/metrics, core/motion and io/wcs (JAX vs torch on CPU).

Metrics at rtol 1e-4 (float32 reductions in another order; the inputs are
exact here, so no cancellation widens it), WCS to 1e-9 px in float64.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from torch_parity import n, t

from photometry_tpu.core.metrics import compute_metrics_batch as jax_metrics
from photometry_tpu.core.metrics import crowding_metrics_batch as jax_crowding
from photometry_tpu.core.motion import MotionModel as JaxMotion
from photometry_tpu.io.wcs import TanWCS as JaxWCS
from photometry_tpu.quality import TESSQualityFlags
from photometry_tpu_torch.core.metrics import compute_metrics_batch, crowding_metrics_batch
from photometry_tpu_torch.core.motion import MotionModel
from photometry_tpu_torch.io.wcs import TanWCS, tan_pixel_to_world, tan_world_to_pixel
from photometry_tpu_torch.utils.mathutils import nanmedian, nanquantile


def _wcs(sip=True):
    kw = dict(crpix=np.array([1024.5, 1000.2]), crval=np.array([83.6, -27.3]),
              cd=np.array([[-5.8e-3, 1.1e-4], [9.0e-5, 5.8e-3]]))
    if sip:
        kw.update(sip_a=np.array([2e-6, -1e-6, 3e-7]), sip_a_pow=np.array([[2, 0], [1, 1], [0, 2]]),
                  sip_b=np.array([-1e-6, 2e-6]), sip_b_pow=np.array([[2, 0], [0, 2]]), sip_order=2)
    return kw


@pytest.mark.parametrize("sip", [False, True])
def test_wcs_host_and_tensor_transforms(sip):
    jw, tw = JaxWCS(**_wcs(sip)), TanWCS(**_wcs(sip))
    rng = np.random.default_rng(0)
    x, y = rng.uniform(1, 2048, 200), rng.uniform(1, 2048, 200)
    ra_j, dec_j = jw.pixel_to_world(x, y)
    ra_t, dec_t = tw.pixel_to_world(x, y)
    np.testing.assert_allclose(ra_t, ra_j, rtol=0, atol=1e-12)
    np.testing.assert_allclose(dec_t, dec_j, rtol=0, atol=1e-12)
    for a, b in zip(tw.rowcol_of_radec(ra_j, dec_j), jw.rowcol_of_radec(ra_j, dec_j)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)
    # tensor face, float64 on the CPU:
    xx, yy = tan_world_to_pixel(t(ra_j), t(dec_j), tw.crpix, tw.crval, tw.cd, tw.sip_a,
                                tw.sip_a_pow, tw.sip_b, tw.sip_b_pow)
    np.testing.assert_allclose(n(xx), x, rtol=0, atol=1e-6 if sip else 1e-9)
    ra2, dec2 = tan_pixel_to_world(t(x), t(y), tw.crpix, tw.crval, tw.cd, tw.sip_a,
                                   tw.sip_a_pow, tw.sip_b, tw.sip_b_pow)
    np.testing.assert_allclose(n(ra2), ra_j, rtol=0, atol=1e-12)
    # header round trip (through the JAX package's parser too) and copy:
    hdr = tw.to_header()
    back = TanWCS.from_header(hdr)
    np.testing.assert_allclose(back.world_to_pixel(ra_j, dec_j), jw.world_to_pixel(ra_j, dec_j),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(JaxWCS.from_header(hdr).cd, tw.cd)
    c = tw.copy()
    c.crpix[0] += 1
    assert tw.crpix[0] == _wcs()["crpix"][0]


def test_nanmedian_and_nanquantile_match_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(7, 40)).astype(np.float32)
    x[rng.uniform(size=x.shape) < 0.3] = np.nan
    x[0] = np.nan
    x[1, :39] = np.nan
    x[2, 3] = np.inf
    np.testing.assert_array_equal(n(nanmedian(t(x))), np.asarray(jnp.nanmedian(x, axis=1)))
    # XLA:CPU contracts low * (1 - w) + high * w into one FMA, so its
    # interpolated quantile can differ from the two-rounding form by 1 ulp:
    for q in (0.25, 0.75, 0.85):
        np.testing.assert_allclose(n(nanquantile(t(x), q)),
                                   np.asarray(jnp.nanquantile(x, q, axis=1)), rtol=2.4e-7)


def _lightcurves(seed=3, N=6, T=96):
    rng = np.random.default_rng(seed)
    time = (1325.3 + np.arange(T) / 48.0).astype(np.float32)
    flux = (1e4 * (1 + 0.01 * np.sin(time[None, :] * (1 + np.arange(N))[:, None]))
            + rng.normal(0, 30, (N, T))).astype(np.float32)
    flux[0, 5] = np.nan
    flux[1] = np.nan
    ferr = np.full((N, T), 30.0, np.float32)
    quality = np.zeros(T, np.int32)
    quality[10] = TESSQualityFlags.DEFAULT_BITMASK & -TESSQualityFlags.DEFAULT_BITMASK
    cent = np.stack([50 + rng.normal(0, 0.1, (N, T)), 60 + rng.normal(0, 0.1, (N, T))],
                    -1).astype(np.float32)
    return time, flux, ferr, quality, cent


def test_compute_metrics_batch_matches_jax():
    arrs = _lightcurves()
    want = jax_metrics(*[jnp.asarray(a) for a in arrs])
    got = compute_metrics_batch(*[t(a) for a in arrs])
    for k in want:
        np.testing.assert_allclose(n(got[k]), np.asarray(want[k]), rtol=1e-4, equal_nan=True,
                                   err_msg=k)
    assert np.isnan(n(got["mean_flux"])[1])


def test_crowding_metrics_batch_matches_jax():
    rng = np.random.default_rng(4)
    N, K, h, w = 5, 6, 17, 19
    masks = rng.uniform(size=(N, h, w)) < 0.5
    cat_row = rng.uniform(0, h, (N, K)).astype(np.float32)
    cat_col = rng.uniform(0, w, (N, K)).astype(np.float32)
    cat_flux = rng.uniform(10, 1e4, (N, K)).astype(np.float32)
    cat_valid = rng.uniform(size=(N, K)) < 0.8
    is_target = np.zeros((N, K), bool)
    is_target[:, 0] = True
    args = (masks, cat_row, cat_col, cat_flux, cat_valid, is_target,
            cat_row[:, 0], cat_col[:, 0], cat_flux[:, 0])
    want = jax_crowding(*[jnp.asarray(a) for a in args], jnp.float32(1.25))
    got = crowding_metrics_batch(*[t(a) for a in args], 1.25)
    for k in want:
        np.testing.assert_allclose(n(got[k]), np.asarray(want[k]), rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("mode", ["unchanged", "translation", "euclidian", "affine", "wcs"])
def test_motion_jitter_matches_jax(mode):
    rng = np.random.default_rng(5)
    times = np.linspace(1325.0, 1327.0, 12)
    cols, rows = rng.uniform(0, 2048, 9), rng.uniform(0, 2048, 9)
    eval_times = np.linspace(1324.5, 1327.5, 30)       # extrapolates at both ends
    if mode == "wcs":
        ref = _wcs()
        kern_j, kern_t = [], []
        for k in range(len(times)):
            kw = dict(ref, crpix=ref["crpix"] + rng.normal(0, 0.05, 2))
            kern_j.append(JaxWCS(**kw))
            kern_t.append(TanWCS(**kw))
        jm = JaxMotion("wcs", wcs_ref=JaxWCS(**ref))
        tm = MotionModel("wcs", wcs_ref=TanWCS(**ref))
        kern_j[3] = kern_t[3] = ""                       # a missing frame
    else:
        n_par = {"unchanged": 1, "translation": 2, "euclidian": 3, "affine": 6}[mode]
        kern_j = kern_t = rng.normal(0, 0.05, (len(times), n_par))
        if mode == "affine":
            kern_j = kern_t = kern_j + np.array([1, 0, 0, 0, 1, 0])
        jm, tm = JaxMotion(mode), MotionModel(mode)
    if mode != "unchanged":
        jm.load_series(times, kern_j)
        tm.load_series(times, kern_t)
    want = jm.jitter_batch(eval_times, cols, rows)
    got = tm.jitter_batch(eval_times, cols, rows)
    # Kernel warps run in float32 on CCD coordinates up to 2048 px, where
    # one ulp is 1.2e-4 px (and cos/sin differ by an ulp between libraries);
    # the WCS mode is float64:
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9 if mode == "wcs" else 5e-4)


def test_motion_single_kernel_is_constant():
    tm = MotionModel("translation")
    tm.load_series([1325.0], [[0.3, -0.2]])
    got = tm.jitter_batch(np.linspace(1324, 1326, 5), [1.0, 2.0], [3.0, 4.0])
    np.testing.assert_allclose(got, np.broadcast_to(np.float32([0.3, -0.2]), (5, 2, 2)))
    with pytest.raises(RuntimeError, match="Reference image not defined"):
        tm.calc_kernel(np.zeros((4, 4)))      # as the JAX package: no reference image
