"""Port parity of host-resident cubes, ``SectorContext(cache="host")``, on the CPU.

- ``extract_aperture_batch`` on host contexts of both packages (the port's
  read from the cube file, and from ``context_from_jax`` of a JAX host
  context): statuses, masks, stamps and APERTURE images exact, the five
  extraction outputs to rtol 1e-4 / atol 1e-3 (tests/test_bandext.py:41),
  as tests/test_torch_slice.py holds the device path.
- ``_extract_flux_streamed`` with chunks that do not divide T (several
  chunks, one frame a chunk, one chunk longer than T) against the JAX
  package's at the same chunk and against the port's device path; and
  ``extract_aperture_batch`` streaming 5 frames a chunk.
- Port host against port device to rtol 1e-6 (centroids 1e-5), as the JAX
  suite's own tests/test_engine_extras.py:23-39.
- ``open_context(cache="host")`` with the default time corrector,
  mirroring tests/test_cache_catalog_timecorr.py:176-218.
- PSF, linPSF and halo on host contexts of both packages, at the bounds of
  tests/test_torch_psf.py, tests/test_torch_linpsf.py and
  tests/test_torch_halo.py; on the port, host and device contexts agree.
- ``cube_dtype=torch.bfloat16`` with ``cache="host"``: as in the JAX
  package, the attribute is kept and the cubes stay float32, so the
  results are the float32 host context's.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_extraction_parity, t

from photometry_tpu.core import engine as jax_engine
from photometry_tpu.core.engine import SectorContext as JaxSectorContext
from photometry_tpu.models import halo as jax_halo
from photometry_tpu.models import linpsf as jax_linpsf
from photometry_tpu.models import psf_fit as jax_psf_fit
from photometry_tpu.models.prf import PRF as JaxPRF
from photometry_tpu.prepare import prepare_photometry
from photometry_tpu.sim.simulator import SimConfig, simulate_sector

from photometry_tpu_torch.core import dispatcher, engine
from photometry_tpu_torch.core.engine import (SectorContext, context_from_jax,
                                              extract_aperture_batch, extract_flux_core)
from photometry_tpu_torch.models import halo, linpsf, psf_fit
from photometry_tpu_torch.models.prf import prf_from_jax

SIGMA = 1.1
KEYS = ("flux", "flux_err", "flux_background", "pos_centroid", "shenanigans_any")


@pytest.fixture(scope="module")
def sector(tmp_path_factory):
    """tests/test_torch_bf16.py's sector (T = 12): host contexts of both
    packages, the port's read from the file, and its device context."""
    d = str(tmp_path_factory.mktemp("torch_host"))
    sim = simulate_sector(SimConfig(shape=(96, 96), n_times=12, n_stars=18, seed=51,
                                    tmag_range=(8.0, 12.5), psf_sigma=SIGMA))
    sim.write_ffis(d)
    sim.write_catalog(d)
    prepare_photometry(d)
    jh = JaxSectorContext(d, 1, 3, 2, cache="host")
    th = SectorContext(d, 1, 3, 2, cache="host", device="cpu")
    td = SectorContext(d, 1, 3, 2, device="cpu")
    yield sim, d, jh, th, td
    for ctx in (jh, th, td):
        ctx.close()


def _assert_results_match_jax(got, want):
    n_ok = 0
    for g, w in zip(got, want):
        assert g.starid == w.starid
        assert g.status.value == w.status.value, g.starid
        assert g.stamp == w.stamp and g.skip_targets == w.skip_targets, g.starid
        if w.mask is None:
            assert g.mask is None
            continue
        n_ok += 1
        np.testing.assert_array_equal(g.mask, w.mask, err_msg=str(g.starid))
        np.testing.assert_array_equal(g.aperture_image, w.aperture_image)
        assert_extraction_parity([g.lightcurve[k] for k in KEYS],
                                 [w.lightcurve[k] for k in KEYS])
    assert n_ok >= len(got) - 3


def test_host_context_matches_jax(sector):
    sim, d, jh, th, _ = sector
    assert isinstance(jh.images, np.ndarray)
    assert th.cache == "host" and th.device.type == "cpu"
    for name in ("images", "images_err", "backgrounds", "pixelflags"):
        x = getattr(th, name)
        assert x.device.type == "cpu" and x.is_contiguous()
        np.testing.assert_array_equal(x.numpy(), getattr(jh, name), err_msg=name)
    sids = [int(s) for s in sim.starid]
    _assert_results_match_jax(extract_aperture_batch(th, sids),
                              jax_engine.extract_aperture_batch(jh, sids))


def test_context_from_jax_host(sector):
    sim, d, jh, th, _ = sector
    ctx = context_from_jax(jh, "cpu")
    assert ctx.cache == "host" and ctx.images.dtype == torch.float32
    for name in ("images", "pixelflags"):
        assert torch.equal(getattr(ctx, name), getattr(th, name))
    sids = [int(s) for s in sim.starid[:8]]
    for g, w in zip(extract_aperture_batch(ctx, sids), extract_aperture_batch(th, sids)):
        assert g.status == w.status
        for k in KEYS:
            np.testing.assert_array_equal(g.lightcurve.get(k), w.lightcurve.get(k))
    ctx.close()


def _targets(rng, T, H, W, N=9, h=13, w=11):
    masks = rng.uniform(size=(N, h, w)) < 0.5
    windows = np.zeros_like(masks)
    windows[:, 1:, :-2] = True
    r0s = rng.integers(0, H - h + 1, N).astype(np.int32)
    c0s = rng.integers(0, W - w + 1, N).astype(np.int32)
    r0s[0], c0s[-1] = H - h, 0                   # flush with the frame's edges
    return masks, r0s, c0s, windows


@pytest.mark.parametrize("chunk", [5, 1, 12, 128])
def test_streamed_chunks_match_jax_and_device(sector, chunk):
    sim, d, jh, th, td = sector
    T, (H, W) = th.n_times, th.shape
    masks, r0s, c0s, windows = _targets(np.random.default_rng(chunk), T, H, W)
    h, w = masks.shape[1:]
    got = engine._extract_flux_streamed(th, t(masks), t(r0s), t(c0s), h, w, chunk=chunk,
                                        windows=t(windows))
    want = jax_engine._extract_flux_streamed(jh, jnp.asarray(masks), jnp.asarray(r0s),
                                             jnp.asarray(c0s), h, w, chunk=chunk,
                                             windows=jnp.asarray(windows))
    assert got[0].shape == (len(masks), T)
    assert_extraction_parity(got, want)
    # the device path's plain version on the whole cube, the same sums:
    dev = extract_flux_core(td.images, td.images_err, td.backgrounds, td.pixelflags,
                            t(masks), t(r0s), t(c0s), h, w, windows=t(windows))
    for a, b in zip(got, dev):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=0, equal_nan=True)


def test_extract_aperture_batch_streams_short_chunks(sector, monkeypatch):
    """extract_aperture_batch on host contexts of both packages, 5 frames a
    chunk (T = 12: chunks of 5, 5 and 2)."""
    sim, d, jh, th, _ = sector
    monkeypatch.setattr(engine, "_extract_flux_streamed",
                        functools.partial(engine._extract_flux_streamed, chunk=5))
    monkeypatch.setattr(jax_engine, "_extract_flux_streamed",
                        functools.partial(jax_engine._extract_flux_streamed, chunk=5))
    sids = [int(s) for s in sim.starid]
    _assert_results_match_jax(extract_aperture_batch(th, sids),
                              jax_engine.extract_aperture_batch(jh, sids))


def test_host_streamed_extraction_matches_device(sector):
    """tests/test_engine_extras.py:23-39 on the port: host against device."""
    sim, d, jh, th, td = sector
    sids = [int(s) for s in sim.starid[:5]]
    assert th.images.device.type == "cpu" and th.cache == "host" and td.cache == "device"
    n_cmp = 0
    for a, b in zip(extract_aperture_batch(td, sids), extract_aperture_batch(th, sids)):
        assert a.status == b.status and a.lightcurve.keys() == b.lightcurve.keys()
        if not a.lightcurve:       # an error status: no light curve on either
            continue
        n_cmp += 1
        np.testing.assert_allclose(b.lightcurve["flux"], a.lightcurve["flux"], rtol=1e-6,
                                   equal_nan=True)
        np.testing.assert_allclose(b.lightcurve["pos_centroid"], a.lightcurve["pos_centroid"],
                                   rtol=1e-5, equal_nan=True)
    assert n_cmp >= 3


def test_open_context_host_default_barycentric(tmp_path, monkeypatch):
    """tests/test_cache_catalog_timecorr.py:176-218 through the port's
    ``open_context(cache="host")``: TIMECORR per target, TIME differences
    equal to the corrector's differential Romer delay."""
    monkeypatch.setenv("PHOTOMETRY_TPU_CACHE", str(tmp_path / "cache"))
    dispatcher.default_time_corrector.cache_clear()
    d = str(tmp_path)
    sim = simulate_sector(SimConfig(shape=(64, 64), n_times=6, n_stars=8, seed=82))
    sim.write_ffis(d)
    sim.write_catalog(d)
    prepare_photometry(d)
    task = {"datasource": "ffi", "sector": 1, "camera": 3, "ccd": 2}
    ctx = dispatcher.open_context(d, task, cache="host", device="cpu")
    try:
        assert ctx.cache == "host" and ctx.time_corrector is not None
        sids = [int(sim.starid[0]), int(sim.starid[-1])]
        res = extract_aperture_batch(ctx, sids)
        t0, t1 = res[0].lightcurve["time"], res[1].lightcurve["time"]
        tc0, tc1 = res[0].lightcurve["timecorr"], res[1].lightcurve["timecorr"]
        assert np.any(tc0 != tc1)
        tgt0, tgt1 = ctx.catalog.target(sids[0]), ctx.catalog.target(sids[1])
        t_nocorr = ctx.time - ctx.timecorr
        c0 = ctx.time_corrector.barycentric_correction(t_nocorr, tgt0["ra"], tgt0["decl"])
        c1 = ctx.time_corrector.barycentric_correction(t_nocorr, tgt1["ra"], tgt1["decl"])
        np.testing.assert_allclose(t0 - t1, c0 - c1, atol=1e-9)
        assert np.max(np.abs(tc0 - ctx.timecorr)) < 30.0 / 86400.0
    finally:
        ctx.close()
        dispatcher.default_time_corrector.cache_clear()


def _assert_model_parity(method, got, want):
    """Each method's own parity bounds (tests/test_torch_{psf,linpsf,halo}.py),
    as tests/test_torch_bf16.py applies them."""
    n_ok = 0
    for g, w in zip(got, want):
        assert g.method == w.method == method
        assert g.status.value == w.status.value, g.starid
        if not w.lightcurve:
            continue
        n_ok += 1
        assert g.stamp == w.stamp, g.starid
        np.testing.assert_array_equal(g.mask, w.mask)
        scale = 1e-4 * np.nanmedian(np.abs(w.lightcurve["flux"]))
        if method == "halo":
            for k in ("flux", "flux_err"):
                np.testing.assert_allclose(g.lightcurve[k], w.lightcurve[k], rtol=5e-4,
                                           equal_nan=True, err_msg=f"{g.starid} {k}")
            continue
        assert g.details["n_stars_fit"] == w.details["n_stars_fit"]
        for k in ("flux", "flux_err", "flux_background", "pos_centroid"):
            if method == "psf":
                rtol, atol = 1e-4, 1e-4 if k == "pos_centroid" else scale
            elif k == "pos_centroid":
                rtol, atol = 1e-6, 0.0
            else:
                rtol, atol = 1e-4, scale if k == "flux_background" else 0.0
            np.testing.assert_allclose(g.lightcurve[k], w.lightcurve[k], rtol=rtol, atol=atol,
                                       equal_nan=True, err_msg=f"{g.starid} {k}")
    assert n_ok >= 2


def _run_model(method, sim, jctx, tctx):
    order = np.argsort(sim.tmag)
    if method == "halo":
        sids = [int(s) for s in sim.starid[order[:3]]]
        return (halo.extract_halo_batch(tctx, sids),
                None if jctx is None else jax_halo.extract_halo_batch(jctx, sids))
    sids = [int(s) for s in sim.starid[order[:8]]]
    jp = JaxPRF.gaussian(sigma=SIGMA)
    jax_mod, mod = (jax_psf_fit, psf_fit) if method == "psf" else (jax_linpsf, linpsf)
    fn = "extract_psf_batch" if method == "psf" else "extract_linpsf_batch"
    return (getattr(mod, fn)(tctx, sids, prf=prf_from_jax(jp, "cpu")),
            None if jctx is None else getattr(jax_mod, fn)(jctx, sids, prf=jp))


@pytest.mark.parametrize("method", ["psf", "linpsf", "halo"])
def test_models_on_host_contexts_match_jax(sector, method):
    sim, d, jh, th, td = sector
    got, want = _run_model(method, sim, jh, th)
    _assert_model_parity(method, got, want)
    # the port's host context gathers its stamps on the host: its device
    # context's results
    dev, _ = _run_model(method, sim, None, td)
    for g, w in zip(got, dev):
        assert g.status == w.status
        for k in ("flux", "flux_err"):
            np.testing.assert_array_equal(g.lightcurve.get(k), w.lightcurve.get(k))


def test_bf16_host_keeps_float32_cubes(sector):
    """cache="host" ignores cube_dtype as the JAX package does
    (photometry_tpu/core/engine.py:194-196): the attribute is kept, the
    cubes are the stored float32, the results the float32 host context's."""
    sim, d, jh, th, _ = sector
    j16 = JaxSectorContext(d, 1, 3, 2, cache="host", cube_dtype=jnp.bfloat16)
    t16 = SectorContext(d, 1, 3, 2, cache="host", cube_dtype=torch.bfloat16, device="cpu")
    assert j16.images.dtype == np.float32 and j16.cube_dtype == jnp.bfloat16
    assert t16.cube_dtype == torch.bfloat16
    for name in ("images", "images_err", "backgrounds"):
        assert getattr(t16, name).dtype == torch.float32
        assert torch.equal(getattr(t16, name), getattr(th, name))
    sids = [int(s) for s in sim.starid]
    got = extract_aperture_batch(t16, sids)
    _assert_results_match_jax(got, jax_engine.extract_aperture_batch(j16, sids))
    for g, w in zip(got, extract_aperture_batch(th, sids)):
        for k in KEYS:
            np.testing.assert_array_equal(g.lightcurve.get(k), w.lightcurve.get(k))
    j16.close()
    t16.close()
