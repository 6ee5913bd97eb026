"""The port's device mesh and sharded programs (``parallel/mesh.py``,
``parallel/sharded.py``) on the CPU, case for case with tests/test_parallel.py.

The port's mesh is ``make_mesh(4, 2, ["cpu"] * 8)``: eight entries of the
one CPU device, the counterpart of the JAX suite's 8 virtual host devices.
Each case holds the port's program:

- against the port's single-device path **bit for bit** (the extraction's
  blocks call the same ``band_extract_flux_batch``; the flattened-mesh fits
  the same batch functions), the JAX package's own bar
  (tests/test_parallel.py:86-106);
- against the JAX package's sharded program on the same seeded numpy
  inputs on its 8-device mesh: extraction to rtol 1e-4 / atol 1e-3
  (tests/test_bandext.py:41), time smoothing and sum image to
  tests/test_parallel.py:55-84's rtol 1e-5, the PSF fits to the bounds of
  tests/test_torch_psf.py, linPSF fluxes to tests/test_torch_linpsf.py's
  and the TV-min weights to tests/test_torch_halo.py's.

Also: ``shard_cube`` makes views of a source already on the shard's device
(only a padded last shard is a copy), ``map_time`` joins per-shard results
in time order cut to the true T, and the mesh helpers' errors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import ATOL, RTOL, assert_extraction_parity, n, t

from photometry_tpu.parallel import mesh as jax_mesh
from photometry_tpu.parallel import sharded as jax_sharded

from photometry_tpu_torch.core.engine import extract_flux_core
from photometry_tpu_torch.ops.bandext import band_extract_flux_batch
from photometry_tpu_torch.parallel.mesh import (ShardedCube, make_mesh, map_time,
                                                shard_cube)
from photometry_tpu_torch.parallel.sharded import (extraction_step, pad_to_multiple,
                                                   prepare_step, sharded_band_extract,
                                                   sharded_extract_flux, sharded_halo_weights,
                                                   sharded_linpsf_fit, sharded_psf_fit,
                                                   sharded_sumimage, sharded_time_smooth)

NAMES = ["flux", "flux_err", "flux_bkg", "centroid", "shenanigans"]


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(n_time=4, n_targets=2, devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    return jax_mesh.make_mesh(n_time=4, n_targets=2)


def _extraction_inputs(T=8, H=64, W=64, N=4, h=9, w=9, seed=2):
    rng = np.random.default_rng(seed)
    imgs = rng.normal(100, 5, (T, H, W)).astype(np.float32)
    imgs[1, 10, 10] = np.nan
    errs = (np.sqrt(np.abs(imgs)) + 1.0).astype(np.float32)
    bkgs = rng.normal(20, 1, (T, H, W)).astype(np.float32)
    pflags = (rng.uniform(size=(T, H, W)) < 0.01).astype(np.uint8) * 4
    r0s = rng.integers(0, H - h, N).astype(np.int32)
    c0s = rng.integers(0, W - w, N).astype(np.int32)
    masks = rng.uniform(size=(N, h, w)) < 0.4
    masks[:, h // 2, w // 2] = True
    return imgs, errs, bkgs, pflags, masks, r0s, c0s


def _bits_equal(a, b, what):
    a, b = n(a), n(b)
    assert a.shape == b.shape, what
    if a.dtype == bool:
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), what


def test_mesh_shapes(mesh):
    assert dict(zip(mesh.axis_names, mesh.devices.shape)) == {"time": 4, "targets": 2}
    assert mesh.shape == {"time": 4, "targets": 2} and mesh.size == 8
    assert all(mesh.device(i, j) == torch.device("cpu") for _, i, j in mesh.flat())
    with pytest.raises(ValueError):
        make_mesh(n_time=3, n_targets=2, devices=["cpu"] * 8)
    assert make_mesh(devices=["cpu"] * 3).shape == {"time": 3, "targets": 1}
    assert make_mesh(n_targets=2, devices=["cpu"] * 6).shape == {"time": 3, "targets": 2}


def test_mesh_without_card_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(2, 1)


def test_pad_to_multiple():
    arr = np.arange(10, dtype=np.float32)
    padded, n_ = pad_to_multiple(arr, 0, 4)
    assert n_ == 10 and padded.shape == (12,) and np.isnan(padded[10:]).all()
    same, n2 = pad_to_multiple(arr, 0, 5)
    assert n2 == 10 and same.shape == (10,)
    jp, jn = jax_sharded.pad_to_multiple(arr, 0, 4)
    np.testing.assert_array_equal(padded, jp)
    assert jn == n_


def test_shard_cube_views_and_padding(mesh):
    """A source on the shard's device is shared (views); a T that the time
    axis does not divide is padded with NaN frames (flags 0) in a copied
    last shard; ``n_times`` keeps the true T; ``map_time`` and ``full``
    give back the true cube."""
    x = torch.arange(10 * 3 * 2, dtype=torch.float32).reshape(10, 3, 2)
    cube = shard_cube(x, mesh)
    assert cube.shape == (12, 3, 2) and cube.n_times == 10 and cube.frames == 3
    for i in range(3):
        assert cube.shards[i].data_ptr() == x[3 * i].data_ptr()
    assert cube.shards[3].data_ptr() != x[9].data_ptr()
    assert torch.equal(cube.shards[3][0], x[9]) and torch.isnan(cube.shards[3][1:]).all()
    assert cube.block(1, 1) is cube.shards[1]
    assert torch.equal(cube.full(), x)
    assert torch.equal(map_time(cube, lambda s: s.sum(dim=(1, 2))[None], 1)[0],
                       x.sum(dim=(1, 2)))
    flags = shard_cube(np.ones((10, 3, 2), np.uint8), mesh, fill=0)
    assert flags.dtype == torch.uint8 and flags.shards[3][1:].eq(0).all()
    with pytest.raises(ValueError, match="divide"):
        sharded_time_smooth(x, mesh)


def test_sharded_time_smooth_matches_host(mesh, jmesh):
    rng = np.random.default_rng(0)
    T, H, W = 16, 16, 16
    bkg = rng.normal(100, 3, (T, H, W)).astype(np.float32)
    out = sharded_time_smooth(t(bkg), mesh, window=3)
    assert isinstance(out, ShardedCube)
    got = n(out.full())
    want = np.empty_like(bkg)
    for k in range(T):
        lo, hi = max(0, k - 1), min(T, k + 2)
        want[k] = bkg[lo:hi].mean(axis=0)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    with jmesh:
        jout = np.asarray(jax_sharded.sharded_time_smooth(
            jax.device_put(jnp.asarray(bkg), jax_mesh.cube_sharding(jmesh)), jmesh, window=3))
    np.testing.assert_allclose(got, jout, rtol=1e-5)
    # the split does not change a bit: 2 time shards against 4
    two = sharded_time_smooth(t(bkg), make_mesh(2, 1, ["cpu"] * 2)).full()
    _bits_equal(two, got, "time=2 vs time=4")


def test_sharded_sumimage_matches_numpy(mesh, jmesh):
    rng = np.random.default_rng(1)
    T, H, W = 16, 16, 16
    imgs = rng.normal(50, 2, (T, H, W)).astype(np.float32)
    imgs[3, 4, 5] = np.nan
    quality_good = np.ones(T, bool)
    quality_good[2] = False
    got = n(sharded_sumimage(t(imgs), quality_good, mesh))
    np.testing.assert_allclose(got, np.nanmean(imgs[quality_good], axis=0), rtol=1e-5)
    with jmesh:
        jout = np.asarray(jax_sharded.sharded_sumimage(
            jax.device_put(jnp.asarray(imgs), jax_mesh.cube_sharding(jmesh)),
            jnp.asarray(quality_good), jmesh))
    np.testing.assert_allclose(got, jout, rtol=1e-5)


def test_sharded_extract_matches_single_device_exactly(mesh, jmesh):
    """(4 time x 2 targets) blocks == the single-device extraction, bit for
    bit; the JAX sharded program within the extraction tolerance."""
    imgs, errs, bkgs, pflags, masks, r0s, c0s = _extraction_inputs()
    h, w = masks.shape[1:]
    got = sharded_extract_flux(imgs, errs, bkgs, pflags, masks, r0s, c0s, mesh, h, w)
    single = band_extract_flux_batch(*(t(a) for a in (imgs, errs, bkgs, pflags, masks, r0s,
                                                      c0s)), h, w)
    plain = extract_flux_core(*(t(a) for a in (imgs, errs, bkgs, pflags, masks, r0s, c0s)),
                              h, w)
    for name, a, b, c in zip(NAMES, got, single, plain):
        _bits_equal(a, b, f"sharded {name} != single-device")
        _bits_equal(a, c, f"sharded {name} != extract_flux_core")
    with jmesh:
        want = [np.asarray(o) for o in jax_sharded.sharded_extract_flux(
            imgs, errs, bkgs, pflags, masks, r0s, c0s, jmesh, h, w)]
    assert_extraction_parity(got, want)


def test_sharded_extract_products_are_real(mesh):
    """flux_err/flux_bkg/centroids come from the err/bkg cubes, not proxies."""
    imgs, errs, bkgs, pflags, masks, r0s, c0s = _extraction_inputs(seed=5)
    h, w = masks.shape[1:]
    flux, ferr, fbkg, cent, shen = (n(o) for o in sharded_extract_flux(
        imgs, errs, bkgs, pflags, masks, r0s, c0s, mesh, h, w))
    i = 0
    m = masks[i]
    st_err = errs[:, r0s[i]:r0s[i] + h, c0s[i]:c0s[i] + w]
    want_err = np.sqrt(np.sum(np.where(m[None], st_err, 0.0) ** 2, axis=(1, 2)))
    np.testing.assert_allclose(ferr[i], want_err, rtol=1e-5)
    st_bkg = bkgs[:, r0s[i]:r0s[i] + h, c0s[i]:c0s[i] + w]
    np.testing.assert_allclose(fbkg[i], np.sum(np.where(m[None], st_bkg, 0.0), axis=(1, 2)),
                               rtol=1e-5)
    assert np.all(np.isfinite(cent[i]))
    assert np.all(cent[i, :, 0] >= c0s[i] + 1) and np.all(cent[i, :, 0] <= c0s[i] + w)
    assert np.all(cent[i, :, 1] >= r0s[i] + 1) and np.all(cent[i, :, 1] <= r0s[i] + h)
    assert shen.dtype == bool
    with pytest.raises(ValueError, match="target-axis"):
        sharded_extract_flux(imgs, errs, bkgs, pflags, masks[:3], r0s[:3], c0s[:3], mesh, h, w)


def test_full_steps_run(mesh, jmesh):
    """prepare_step + extraction_step on the mesh: shapes as the JAX test's;
    the sum image and backgrounds against the unsharded path
    (estimate_background -> time_moving_nanmean -> the mean of the good
    frames) and against the JAX package's prepare_step, to rtol 1e-5."""
    from photometry_tpu_torch.ops.background import estimate_background
    from photometry_tpu_torch.ops.filters import time_moving_nanmean
    rng = np.random.default_rng(3)
    T, H, W = 8, 64, 64
    imgs = rng.normal(100, 2, (T, H, W)).astype(np.float32)
    quality = np.zeros(T, np.int32)
    errs = (np.sqrt(np.abs(imgs)) + 1.0).astype(np.float32)
    pflags = np.zeros((T, H, W), np.uint8)
    masks = rng.uniform(size=(4, 9, 9)) < 0.5
    r0s = rng.integers(0, H - 9, 4).astype(np.int32)
    c0s = rng.integers(0, W - 9, 4).astype(np.int32)
    sub, bkg, s = prepare_step(imgs, quality, mesh, tile=16)
    lc, metrics = extraction_step(sub, errs, bkg, pflags, masks, r0s, c0s,
                                  np.linspace(1325.0, 1326.0, T), quality, mesh, 9, 9)
    assert n(lc["flux"]).shape == (4, T) and np.isfinite(n(bkg.full())).all()
    assert n(lc["flux_err"]).shape == (4, T)
    assert n(lc["pos_centroid"]).shape == (4, T, 2)
    assert n(metrics["rms_hour"]).shape == (4,)

    b1 = time_moving_nanmean(estimate_background(t(imgs), tile=16)[0])
    np.testing.assert_allclose(n(bkg.full()), n(b1), rtol=1e-5)
    np.testing.assert_allclose(n(s), n((t(imgs) - b1).mean(dim=0)), rtol=1e-5, atol=1e-4)
    with jmesh:
        jsub, jbkg, js = jax_sharded.prepare_step(imgs, quality, jmesh, tile=16)
        np.testing.assert_allclose(n(bkg.full()), np.asarray(jbkg), rtol=1e-5)
        np.testing.assert_allclose(n(s), np.asarray(js), rtol=1e-5, atol=1e-4)


def test_sharded_band_extract_matches_single(mesh, jmesh):
    """One band extraction per time shard == the single-device band
    extraction bit for bit; the JAX sharded band kernel (interpret mode)
    within the extraction tolerance."""
    rng = np.random.default_rng(9)
    T, H, W = 16, 128, 256
    N, h, w = 10, 17, 17
    imgs = rng.normal(100, 5, (T, H, W)).astype(np.float32)
    imgs[1, 10, 10] = np.nan
    errs = (np.sqrt(np.abs(imgs)) + 1.0).astype(np.float32)
    bkgs = rng.normal(20, 1, (T, H, W)).astype(np.float32)
    pflags = (rng.uniform(size=(T, H, W)) < 0.01).astype(np.uint8) * 4
    r0s = rng.integers(0, H - h, N).astype(np.int32)
    c0s = rng.integers(0, W - w, N).astype(np.int32)
    masks = rng.uniform(size=(N, h, w)) < 0.4
    masks[:, h // 2, w // 2] = True
    got = sharded_band_extract(imgs, errs, bkgs, pflags, masks, r0s, c0s, mesh, h, w)
    want = band_extract_flux_batch(*(t(a) for a in (imgs, errs, bkgs, pflags, masks, r0s,
                                                    c0s)), h, w)
    for name, a, b in zip(NAMES, got, want):
        _bits_equal(a, b, name)
    with jmesh:
        jgot = [np.asarray(o) for o in jax_sharded.sharded_band_extract(
            imgs, errs, bkgs, pflags, masks, r0s, c0s, jmesh, h, w, interpret=True)]
    assert_extraction_parity(got, jgot)


def _psf_problem(N=11, T=4, h=13, w=13, S=2, seed=3):
    from photometry_tpu.models.prf import PRF as JaxPRF
    prf = JaxPRF.gaussian(sigma=1.1)
    rng = np.random.default_rng(seed)
    rows = 6.0 + rng.uniform(-1.5, 1.5, (N, S)).astype(np.float32)
    cols = 6.0 + rng.uniform(-1.5, 1.5, (N, S)).astype(np.float32)
    fx = rng.uniform(3000, 9000, (N, S)).astype(np.float32)
    imgs = np.stack([np.asarray(prf.integrate_to_image(
        np.stack([rows[i], cols[i], fx[i]], 1), (h, w), 5.0)) for i in range(N)])
    imgs = np.repeat(imgs[:, None], T, axis=1)
    imgs += rng.normal(0, 0.5, imgs.shape).astype(np.float32)
    p0 = np.concatenate([rows + 0.2, cols - 0.1, fx * 0.8], 1).astype(np.float32)
    return prf, imgs.astype(np.float32), p0, rows, cols


def test_sharded_psf_fit_matches_single_device(mesh, jmesh):
    """PSF fits over the flattened mesh (11 targets on 8 entries: padded,
    the padding dropped) == the single-device batch fit bit for bit; the
    JAX package's sharded fit to tests/test_torch_psf.py's bounds."""
    from photometry_tpu_torch.models.prf import prf_from_jax
    from photometry_tpu_torch.models.psf_fit import fit_psf_timeseries_batch
    jprf, imgs, p0, _, _ = _psf_problem()
    N, T, h, w = imgs.shape
    S = 2
    prf = prf_from_jax(jprf, "cpu")
    valid = np.ones((N, S), bool)
    bkgs = np.zeros_like(imgs)
    mini = np.ones((N, h, w), bool)
    tidx = np.zeros(N, np.int32)
    single = fit_psf_timeseries_batch(t(imgs), t(bkgs), 1.0, t(p0), t(valid), t(mini),
                                      t(tidx), prf, (h, w), S)
    sharded = sharded_psf_fit(imgs, bkgs, 1.0, p0, valid, mini, tidx, prf, (h, w), S, mesh)
    assert set(sharded) == set(single)
    for k in single:
        assert sharded[k].shape[0] == N
        _bits_equal(sharded[k], single[k], k)
    jout = jax_sharded.sharded_psf_fit(imgs, bkgs, 1.0, p0, valid, mini, tidx, jprf,
                                       (h, w), S, jmesh)
    scale = 1e-4 * np.abs(np.asarray(jout["flux"])).max()
    for k, rtol, atol in (("flux", 1e-4, scale), ("flux_err", 1e-4, scale),
                          ("pos", 1e-4, 1e-4)):
        np.testing.assert_allclose(n(sharded[k]), np.asarray(jout[k]), rtol=rtol, atol=atol,
                                   err_msg=k)


def test_sharded_linpsf_and_halo_weights_match_single_device(mesh, jmesh):
    """linPSF solves and TV-min weights over the flattened mesh == the
    single-device batch bit for bit; against the JAX package's sharded
    programs to tests/test_torch_linpsf.py's and tests/test_torch_halo.py's
    bounds."""
    from photometry_tpu_torch.models.halo import tvmin_weights_batch
    from photometry_tpu_torch.models.linpsf import linpsf_timeseries_batch
    from photometry_tpu_torch.models.prf import prf_from_jax
    jprf, imgs, _, rows, cols = _psf_problem(N=9, seed=4)
    N, T, h, w = imgs.shape
    S = rows.shape[1]
    rng = np.random.default_rng(5)
    rows_t = (rows[:, None] + rng.normal(0, 0.05, (N, T, S))).astype(np.float32)
    cols_t = (cols[:, None] + rng.normal(0, 0.05, (N, T, S))).astype(np.float32)
    valid = np.ones((N, S), bool)
    valid[2, 1] = False
    prf = prf_from_jax(jprf, "cpu")
    single = linpsf_timeseries_batch(t(imgs), t(rows_t), t(cols_t), t(valid), prf, (h, w), S)
    got = sharded_linpsf_fit(imgs, rows_t, cols_t, valid, prf, (h, w), S, mesh)
    for k in single:
        _bits_equal(got[k], single[k], k)
    jout = jax_sharded.sharded_linpsf_fit(imgs, rows_t, cols_t, valid, jprf, (h, w), S, jmesh)
    want = np.asarray(jout["fluxes"])
    np.testing.assert_allclose(n(got["fluxes"]), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())

    P = 20
    fn = (1.0 + 0.01 * rng.normal(size=(N, 24, P))).astype(np.float32)
    good = np.ones(24, bool)
    good[5] = False
    w1, v1 = tvmin_weights_batch(t(fn), t(np.broadcast_to(good, (N, 24))),
                                 torch.ones((N, P), dtype=torch.bool))
    w8, v8 = sharded_halo_weights(fn, good, mesh)
    _bits_equal(w8, w1, "weights")
    _bits_equal(v8, v1, "objective")
    jw, jv = jax_sharded.sharded_halo_weights(fn, good, jmesh)
    np.testing.assert_allclose(n(w8), np.asarray(jw), rtol=5e-4, atol=1e-6)
    np.testing.assert_allclose(n(v8), np.asarray(jv), rtol=RTOL, atol=ATOL)
