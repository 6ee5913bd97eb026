"""Port parity of bfloat16 cubes, ``SectorContext(cube_dtype=torch.bfloat16)``, on the CPU.

- The cast: the port's bfloat16 cube equals the JAX package's bit for bit
  (compared as uint16), on adversarial values (NaN of either sign and with
  payloads, +-inf, float32 values past bfloat16's range, ties, subnormals,
  -0) and on a prepared sector's
  cubes read from the file by both packages; ``context_from_jax`` of a
  bfloat16 JAX context keeps the bits.
- ``cube_dtype`` spellings; anything but float32 and bfloat16 raises
  ValueError, ``mesh=`` still raises NotImplementedError, and with
  ``cache="host"`` the cubes keep their stored float32 (the attribute is
  kept), as in the JAX package.
- ``extract_aperture_batch`` on bfloat16 contexts of both packages:
  statuses and masks equal, fluxes to rtol 1e-4 / atol 1e-3
  (tests/test_bandext.py:41); the port's bfloat16 fluxes within 2e-3 of
  its float32 ones (tests/test_engine_extras.py:79).
- ``extract_psf_batch``, ``extract_linpsf_batch`` and
  ``extract_halo_batch`` on bfloat16 contexts of both packages, at the
  tolerances of tests/test_torch_psf.py, tests/test_torch_linpsf.py and
  tests/test_torch_halo.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_extraction_parity

from photometry_tpu.core.engine import SectorContext as JaxSectorContext
from photometry_tpu.core.engine import extract_aperture_batch as jax_extract
from photometry_tpu.models import halo as jax_halo
from photometry_tpu.models import linpsf as jax_linpsf
from photometry_tpu.models import psf_fit as jax_psf_fit
from photometry_tpu.models.prf import PRF as JaxPRF
from photometry_tpu.prepare import prepare_photometry
from photometry_tpu.sim.simulator import SimConfig, simulate_sector

from photometry_tpu_torch.core.engine import SectorContext, _on_device, context_from_jax
from photometry_tpu_torch.core.engine import extract_aperture_batch
from photometry_tpu_torch.models import halo, linpsf, psf_fit
from photometry_tpu_torch.models.prf import prf_from_jax

SIGMA = 1.1
CPU = torch.device("cpu")


def bf16_bits(x) -> np.ndarray:
    """The uint16 bits of a bfloat16 tensor or JAX / numpy bfloat16 array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


@pytest.fixture(scope="module")
def sector(tmp_path_factory):
    """tests/test_psf_models.py's psf_setup sector: both packages' contexts,
    bfloat16 (the port's from ``context_from_jax``) and float32."""
    d = str(tmp_path_factory.mktemp("torch_bf16"))
    sim = simulate_sector(SimConfig(shape=(96, 96), n_times=12, n_stars=18, seed=51,
                                    tmag_range=(8.0, 12.5), psf_sigma=SIGMA))
    sim.write_ffis(d)
    sim.write_catalog(d)
    prepare_photometry(d)
    j16 = JaxSectorContext(d, 1, 3, 2, cube_dtype=jnp.bfloat16)
    j32 = JaxSectorContext(d, 1, 3, 2)
    t16 = context_from_jax(j16, "cpu")
    t32 = context_from_jax(j32, "cpu")
    yield sim, d, j16, t16, t32
    for ctx in (j16, j32, t16, t32):
        ctx.close()


def _adversarial():
    x = np.random.default_rng(0).normal(100, 50, (3, 6, 8)).astype(np.float32)
    special = [np.nan, -np.nan, np.inf, -np.inf,
               3.4e38, -3.4e38, np.finfo(np.float32).max,     # past bfloat16's range: inf
               3.3895e38, 3.3961e38,                          # bfloat16's largest, and just past
               1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8,          # ties: to even, down and up
               1e-40, -1e-41, 1e-45, np.finfo(np.float32).tiny,   # subnormals, smallest normal
               -0.0, 0.0]
    x.flat[:len(special)] = special
    # NaNs whose payload would round into inf or -0 without their own rule:
    payloads = np.array([0x7F800001, 0x7FFFFFFF, 0xFFBFFFFF, 0xFF800001], np.uint32)
    x.flat[len(special):len(special) + 4] = payloads.view(np.float32)
    return x


def test_bf16_cast_matches_jax_bit_for_bit(sector):
    sim, d, j16, t16, _ = sector
    x = _adversarial()
    got = _on_device(x, torch.bfloat16, CPU)
    np.testing.assert_array_equal(bf16_bits(got), bf16_bits(jnp.asarray(x, jnp.bfloat16)))
    # A prepared sector's cubes, read from the file by both packages:
    own = SectorContext(d, 1, 3, 2, cube_dtype="bfloat16", device="cpu")
    for name in ("images", "images_err", "backgrounds"):
        assert getattr(own, name).dtype == torch.bfloat16
        np.testing.assert_array_equal(bf16_bits(getattr(own, name)),
                                      bf16_bits(getattr(j16, name)), err_msg=name)
    assert own.pixelflags.dtype == torch.uint8 and own.sumimage.dtype == np.float32
    own.close()


def test_context_from_jax_bf16(sector):
    sim, d, j16, t16, t32 = sector
    assert t16.cube_dtype == torch.bfloat16 and t32.cube_dtype == torch.float32
    for name in ("images", "images_err", "backgrounds"):
        assert getattr(t16, name).dtype == torch.bfloat16
        np.testing.assert_array_equal(bf16_bits(getattr(t16, name)),
                                      bf16_bits(getattr(j16, name)), err_msg=name)
    np.testing.assert_array_equal(t16.pixelflags.numpy(), np.asarray(j16.pixelflags))
    np.testing.assert_array_equal(t16.sumimage, j16.sumimage)
    assert t16.sumimage.dtype == np.float32


def test_cube_dtype_spellings(sector):
    sim, d, *_ = sector
    for spelling, want in ((None, torch.float32), (np.float32, torch.float32),
                           ("float32", torch.float32), (torch.float32, torch.float32),
                           (torch.bfloat16, torch.bfloat16), ("bfloat16", torch.bfloat16),
                           (jnp.bfloat16, torch.bfloat16)):
        ctx = SectorContext(d, 1, 3, 2, cube_dtype=spelling, device="cpu")
        assert ctx.images.dtype == ctx.backgrounds.dtype == want, spelling
        ctx.close()
    for bad in (torch.float16, "float64", np.int32, "bf16"):
        with pytest.raises(ValueError, match="cube_dtype"):
            SectorContext(d, 1, 3, 2, cube_dtype=bad, device="cpu")
    with pytest.raises(NotImplementedError):
        SectorContext(d, 1, 3, 2, cube_dtype=torch.bfloat16, mesh=object(), device="cpu")
    host = SectorContext(d, 1, 3, 2, cube_dtype=torch.bfloat16, cache="host", device="cpu")
    jhost = JaxSectorContext(d, 1, 3, 2, cube_dtype=jnp.bfloat16, cache="host")
    assert host.cube_dtype == torch.bfloat16 and host.images.dtype == torch.float32
    assert jhost.images.dtype == np.float32
    np.testing.assert_array_equal(host.images.numpy(), jhost.images)
    host.close()
    jhost.close()


def test_aperture_bf16_matches_jax(sector):
    sim, d, j16, t16, t32 = sector
    sids = [int(s) for s in sim.starid]
    want = jax_extract(j16, sids)
    got = extract_aperture_batch(t16, sids)
    ref32 = extract_aperture_batch(t32, sids)
    n_ok = 0
    for g, w, f in zip(got, want, ref32):
        assert g.status.value == w.status.value, g.starid
        assert g.stamp == w.stamp, g.starid
        if w.mask is None:
            assert g.mask is None
            continue
        n_ok += 1
        np.testing.assert_array_equal(g.mask, w.mask, err_msg=str(g.starid))
        np.testing.assert_array_equal(g.aperture_image, w.aperture_image)
        keys = ("flux", "flux_err", "flux_background", "pos_centroid", "shenanigans_any")
        assert_extraction_parity([g.lightcurve[k] for k in keys],
                                 [w.lightcurve[k] for k in keys])
        if f.status == g.status and f.mask is not None:
            rel = np.nanmax(np.abs(g.lightcurve["flux"] / f.lightcurve["flux"] - 1))
            assert rel < 2e-3, (g.starid, rel)
    assert n_ok >= len(sids) - 3


def _assert_model_parity(method, got, want):
    """Each method's own parity bounds (tests/test_torch_{psf,linpsf,halo}.py)."""
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
            if method == "psf":          # tests/test_torch_psf.py's _assert_lc_close
                rtol, atol = 1e-4, 1e-4 if k == "pos_centroid" else scale
            elif k == "pos_centroid":    # tests/test_torch_linpsf.py
                rtol, atol = 1e-6, 0.0
            else:
                rtol, atol = 1e-4, scale if k == "flux_background" else 0.0
            np.testing.assert_allclose(g.lightcurve[k], w.lightcurve[k], rtol=rtol, atol=atol,
                                       equal_nan=True, err_msg=f"{g.starid} {k}")
    assert n_ok >= 2


@pytest.mark.parametrize("method", ["psf", "linpsf", "halo"])
def test_models_bf16_match_jax(sector, method):
    sim, d, j16, t16, _ = sector
    order = np.argsort(sim.tmag)
    if method == "halo":
        sids = [int(s) for s in sim.starid[order[:3]]]
        want = jax_halo.extract_halo_batch(j16, sids)
        got = halo.extract_halo_batch(t16, sids)
    else:
        sids = [int(s) for s in sim.starid[order[:8]]]
        jp = JaxPRF.gaussian(sigma=SIGMA)
        jax_mod, mod = (jax_psf_fit, psf_fit) if method == "psf" else (jax_linpsf, linpsf)
        fn = "extract_psf_batch" if method == "psf" else "extract_linpsf_batch"
        want = getattr(jax_mod, fn)(j16, sids, prf=jp)
        got = getattr(mod, fn)(t16, sids, prf=prf_from_jax(jp, "cpu"))
    _assert_model_parity(method, got, want)
