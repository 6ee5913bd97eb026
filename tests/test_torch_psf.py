"""Port parity of the PSF method, on the CPU.

Every input is made once (numpy seeds or the JAX package's own test
problems) and handed to both packages; JAX runs on the CPU, its Pallas
kernel in interpret mode, as the JAX package's own tests run it.

Tolerances, and why:

- PRF renders, gradients and design matrices: rtol 1e-5 plus 1e-5 of the
  largest value.  Same float32 table, same Catmull-Rom weights; the JAX
  package selects table rows by one-hot matmuls, the port by indexing, so
  only the order of float32 sums differs (measured <= 5e-7 relative).
- smallsolve: rtol 1e-5.  The same unrolled Cholesky, op for op.
- The kernel's plain version against the JAX Pallas kernel, and the torch
  fitter against the JAX fitter: the bounds of tests/test_psf_pallas.py.
  The pixel sums of the normal equations run in another float32 order, and
  iterated Gauss-Newton steps amplify one ulp of JtJ on near-degenerate
  blends; those bounds were set for exactly that.
- ``extract_psf_batch`` and the drain: statuses and stamps equal; flux,
  flux_err, background and centroid to rtol 1e-4 with an absolute floor of
  1e-4 of the median flux (fitted fluxes of faint neighbours near zero).
  Measured agreement is ~2e-6 relative.
"""

import glob
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import n, t

from photometry_tpu.cli import prepare_cmd, todo_cmd
from photometry_tpu.core import dispatcher as jax_dispatcher
from photometry_tpu.core.drain import run_drain as jax_run_drain
from photometry_tpu.core.engine import SectorContext as JaxSectorContext
from photometry_tpu.core.timecorr import SpacecraftEphemeris as JaxEphemeris
from photometry_tpu.core.timecorr import TimeCorrector as JaxTimeCorrector
from photometry_tpu.io import fits as pf
from photometry_tpu.models import psf_fit as jax_psf_fit
from photometry_tpu.models.prf import PRF as JaxPRF
from photometry_tpu.models.psf_pallas import fused_warm_fit as jax_fused_warm_fit
from photometry_tpu.ops import smallsolve as jax_smallsolve
from photometry_tpu.sim.simulator import SimConfig, simulate_sector

from photometry_tpu_torch.core import dispatcher as torch_dispatcher
from photometry_tpu_torch.core.drain import run_drain as torch_run_drain
from photometry_tpu_torch.core.engine import context_from_jax
from photometry_tpu_torch.core.timecorr import SpacecraftEphemeris, TimeCorrector
from photometry_tpu_torch.models import psf_fit
from photometry_tpu_torch.models.prf import PRF, prf_from_jax
from photometry_tpu_torch.models.psf_fused import fused_ok, fused_warm_fit
from photometry_tpu_torch.ops import smallsolve
from photometry_tpu_torch.utils.profiling import StageTimer

_GAUSSIAN = JaxPRF.gaussian

SIGMA = 1.1
_JAX_GAUSSIAN = {}


def _jax_gaussian(sigma):
    """One JAX Gaussian PRF per sigma.  PRFs hash by identity and the JAX
    fit programs take the PRF as a static argument, so sharing the object
    lets the drain test reuse the programs the batch test compiled."""
    if sigma not in _JAX_GAUSSIAN:
        _JAX_GAUSSIAN[sigma] = _GAUSSIAN(sigma=sigma)
    return _JAX_GAUSSIAN[sigma]


def _density(terms, oversample=9, radius=8.0):
    """Oversampled PRF density: a sum of axis-aligned Gaussians (a, sy, sx)."""
    m = int(radius * oversample)
    offs = np.arange(-m, m + 1) / oversample
    g = np.zeros((2 * m + 1, 2 * m + 1))
    for a, sy, sx in terms:
        g += a * np.exp(-0.5 * (offs[:, None] / sy) ** 2 - 0.5 * (offs[None, :] / sx) ** 2)
    return g / (g.sum() / oversample ** 2)


def _jax_prf(kind, tmp_path):
    g = _jax_gaussian(SIGMA)
    if kind == "gaussian":
        return g
    if kind == "table":
        return JaxPRF(g.iprf, g.oversample, g.center_x, g.center_y, info={})
    if kind == "table_os8.5":        # non-integer oversample: bicubic_eval
        return JaxPRF(g.iprf, 8.5, g.center_x, g.center_y, info={})
    path = str(tmp_path / "tess-k2-1-1-characterized-prf.mat")
    JaxPRF.write_mat(path, [_density([(0.7, 1.1, 1.1), (0.3, 2.0, 2.0)])], [1024.0], [1024.0])
    return JaxPRF.from_mat(path, sector=1, camera=1, ccd=1, stamp=(0, 15, 0, 15))


def _close(got, want, what):
    got, want = n(got), n(want)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max(),
                               err_msg=what)


@pytest.mark.parametrize("kind", ["gaussian", "table", "table_os8.5", "mat_k2"])
def test_prf_matches_jax(kind, tmp_path):
    jp = _jax_prf(kind, tmp_path)
    if kind == "mat_k2":
        tp = PRF.from_mat(jp.info["file"], sector=1, camera=1, ccd=1, stamp=(0, 15, 0, 15),
                          device="cpu")
        np.testing.assert_array_equal(tp.iprf, jp.iprf)
        assert tp._svd_factors()[0].shape[1] == jp._svd_factors()[0].shape[1] == 2
    else:
        tp = prf_from_jax(jp, "cpu")
    assert tp._grid_separable == jp._grid_separable
    assert tp.has_analytic_grads == jp.has_analytic_grads
    rng = np.random.default_rng(3)
    S, shape = 6, (11, 13)
    rows = rng.uniform(-3, 14, S).astype(np.float32)
    cols = rng.uniform(-3, 16, S).astype(np.float32)
    rows[0] = -1000.0                                  # a dummy star
    params = np.stack([rows, cols, rng.uniform(100, 1000, S).astype(np.float32)], 1)
    # The JAX side runs jitted: one compile per method instead of one per
    # eager primitive (the same float32 ops either way).
    _close(tp.integrate_to_image(t(params), shape, 5.0),
           jax.jit(jp.integrate_to_image, static_argnums=(1, 2))(params, shape, 5.0),
           "integrate_to_image")
    _close(tp.render_batch(t(params[None].repeat(3, 0)), shape),
           jax.jit(jp.render_batch, static_argnums=(1,))(params[None].repeat(3, 0), shape),
           "render_batch")
    _close(tp.design_matrix(t(rows), t(cols), shape),
           jax.jit(jp.design_matrix, static_argnums=(2,))(rows, cols, shape), "design_matrix")
    dr = rng.uniform(-6, 6, (5, 7)).astype(np.float32)
    dc = rng.uniform(-6, 6, (5, 7)).astype(np.float32)
    _close(tp.pixel_fraction(t(dr), t(dc)), jax.jit(jp.pixel_fraction)(dr, dc), "pixel_fraction")
    if jp._grid_separable:
        want = jax.jit(jp.render_separable_with_grads, static_argnums=(2, 3))(rows, cols, shape,
                                                                              5.0)
        for a, b, what in zip(tp.render_separable_with_grads(t(rows), t(cols), shape, 5.0),
                              want, ("q", "q_row", "q_col")):
            _close(a, b, what)
    if jp.has_analytic_grads:
        for a, b, what in zip(tp.pixel_fraction_grads(t(dr), t(dc)),
                              jax.jit(jp.pixel_fraction_grads)(dr, dc),
                              ("q", "q_drow", "q_dcol")):
            _close(a, b, what)


def test_smallsolve_matches_jax():
    rng = np.random.default_rng(5)
    B, K = 16, 15
    X = rng.normal(size=(B, K, 40)).astype(np.float32)
    A = X @ X.transpose(0, 2, 1)
    A[:4, -3:, :] = 0.0                  # dummy-star rows and columns: singular
    A[:4, :, -3:] = 0.0
    b = rng.normal(size=(B, K)).astype(np.float32)
    for name in ("chol_small", "spd_inverse_diag_small"):
        for jitter in (0.0, 1e-3):
            np.testing.assert_allclose(n(getattr(smallsolve, name)(t(A), jitter)),
                                       n(getattr(jax_smallsolve, name)(A, jitter)),
                                       rtol=1e-5, atol=1e-6, err_msg=f"{name} {jitter}")
    np.testing.assert_allclose(n(smallsolve.solve_spd_small(t(A), t(b), 1e-3)),
                               n(jax_smallsolve.solve_spd_small(A, b, 1e-3)), rtol=1e-5, atol=1e-6)
    L = jax_smallsolve.chol_small(A[4:], 0.0)
    np.testing.assert_allclose(n(smallsolve.cho_solve_small(t(L), t(b[4:]))),
                               n(jax_smallsolve.cho_solve_small(L, b[4:])), rtol=1e-5, atol=1e-6)


def _check_fit(p_got, p_ref, valid, S, tight=True):
    """The parameter bounds of tests/test_psf_pallas.py."""
    vm = np.asarray(valid)
    pos_d = np.abs(p_got[:, :2 * S] - p_ref[:, :2 * S])[np.concatenate([vm, vm], 1)]
    rel = (np.abs(p_got[:, 2 * S:] - p_ref[:, 2 * S:]) / np.maximum(p_ref[:, 2 * S:], 10.0))[vm]
    if tight:
        assert pos_d.max() < 2e-3, pos_d.max()
        assert np.percentile(rel, 95) < 1e-3, rel
        assert rel.max() < 2e-2, rel.max()
    else:                                # heavy S=6 blends: bulk tight, tail loose
        assert np.percentile(pos_d, 90) < 5e-3
        assert np.percentile(rel, 90) < 5e-3, rel


def _pallas_problem(B, S, seed, h=11, w=11):
    """tests/test_psf_pallas.py:_problem drawn with numpy: S stars in a +-2 px
    box on the table PRF of sigma 1.2, fluxes 800-3800, pedestal 5, noise 0.8,
    background 2, a start 0.25 off the truth, the last star a dummy on every
    third instance, a 5x5 MOMF aperture and star 0 the main target."""
    g = JaxPRF.gaussian(sigma=1.2)
    prf = JaxPRF(g.iprf, g.oversample, g.center_x, g.center_y, info={})
    rng = np.random.default_rng(seed)
    p_true = np.concatenate([5.0 + rng.uniform(-2, 2, (B, S)), 5.0 + rng.uniform(-2, 2, (B, S)),
                             800.0 + 3000.0 * rng.uniform(size=(B, S))], 1)
    par = t(p_true.reshape(B, 3, S).transpose(0, 2, 1).astype(np.float32))
    imgs = n(prf_from_jax(prf, "cpu").integrate_to_image(par, (h, w), 5.0))
    imgs = (imgs + 5.0 + 0.8 * rng.normal(size=(B, h, w))).astype(np.float32)
    p0 = (p_true + 0.25 * rng.normal(size=p_true.shape)).astype(np.float32)
    valid = np.ones((B, S), bool)
    valid[::3, S - 1] = False
    mini = np.zeros((B, h, w), bool)
    mini[:, 3:8, 3:8] = True
    onehot = np.zeros((B, S), np.float32)
    onehot[:, 0] = 1.0
    return prf, imgs, np.full((B, h, w), 2.0, np.float32), p0, valid, mini, onehot


@pytest.mark.parametrize("S,n_iters", [(3, 1), (3, 4), (6, 4)])
def test_fused_plain_matches_jax_pallas(S, n_iters):
    prf, imgs, bkgs, p0, valid, mini, onehot = (_pallas_problem(24, 3, seed=1) if S == 3
                                                else _pallas_problem(8, 6, seed=11))
    B, h, w = imgs.shape
    want = jax_fused_warm_fit(imgs, bkgs, jnp.float32(1.0), p0, valid, mini, onehot, prf,
                              (h, w), S, n_iters)
    tprf = prf_from_jax(prf, "cpu")
    assert fused_ok(tprf, (h, w), S, "Gaussian_d")
    got = fused_warm_fit(t(imgs), t(bkgs), 1.0, t(p0), t(valid), t(mini), t(onehot), tprf,
                         (h, w), S, n_iters)
    assert got["params"].shape == (B, 3 * S)
    _check_fit(n(got["params"]), n(want["params"]), valid, S, tight=S == 3)
    if S == 3:
        np.testing.assert_allclose(n(got["flux_ap"]), n(want["flux_ap"]), rtol=2e-2, atol=2.0)
        np.testing.assert_allclose(n(got["fluxvar_target"]), n(want["fluxvar_target"]),
                                   rtol=2e-2)


@pytest.mark.parametrize("B, n_sms, want", [
    (180 * 512, 132, 8),          # a chunk's warm fits: full blocks
    (180, 132, 1),                # its first-cadence fit: one instance a block
    (1000, 132, 3),
    (1, 132, 1),
])
def test_fused_warps_per_block(B, n_sms, want):
    from photometry_tpu_torch.models.psf_fused import MAX_WARPS, warps_per_block
    got = warps_per_block(B, n_sms)
    assert got == want and 1 <= got <= MAX_WARPS


def _separated_problem(jp, B=8, S=3, h=15, w=15, seed=2):
    """B stamps of S resolved stars (neighbours 2.5-5 px from a central
    target, fluxes 800-3800), noise 0.8 on a pedestal of 5, a start 0.25 off
    the truth, the last star a dummy on every third stamp."""
    rng = np.random.default_rng(seed)
    ang = rng.uniform(0, 2 * np.pi, (B, S))
    rad = np.where(np.arange(S) == 0, 0.0, rng.uniform(2.5, 5.0, (B, S)))
    rows = (h - 1) / 2 + rng.uniform(-0.5, 0.5, (B, 1)) + rad * np.sin(ang)
    cols = (w - 1) / 2 + rng.uniform(-0.5, 0.5, (B, 1)) + rad * np.cos(ang)
    p_true = np.concatenate([rows, cols, 800.0 + 3000.0 * rng.uniform(size=(B, S))], 1)
    imgs = np.stack([np.asarray(jp.integrate_to_image(p.reshape(3, S).T, (h, w), 5.0))
                     for p in p_true]) + 5.0 + 0.8 * rng.normal(size=(B, h, w))
    p0 = p_true + 0.25 * rng.normal(size=p_true.shape)
    valid = np.ones((B, S), bool)
    valid[::3, S - 1] = False
    return (imgs.astype(np.float32), np.full((B, h, w), 2.0, np.float32),
            p0.astype(np.float32), valid)


@pytest.mark.parametrize("kind,lhood", [("table", "Gaussian_d"), ("gaussian", "Gaussian_m"),
                                        ("table_os8.5", "Poisson")])
def test_make_psf_fitter_matches_jax(kind, lhood, tmp_path):
    """All three likelihoods, each on another branch: separable table,
    analytic Gaussian, and jacfwd (non-integer oversample).  On resolved
    stars: the blends of ``_pallas_problem`` leave the Gaussian_m and
    analytic branches of the two float32 fitters further apart than
    test_psf_pallas.py's bounds, which were set for Gaussian_d."""
    jp = _jax_prf(kind, tmp_path)
    imgs, bkgs, p0, valid = _separated_problem(jp)
    B, h, w = imgs.shape
    S = valid.shape[1]
    fit = jax_psf_fit.make_psf_fitter(jp, (h, w), S, lhood, n_iters=4)
    p_ref, mdl_ref, var_ref = jax.jit(jax.vmap(
        lambda i, b, p, v: fit(i, b, 1.0, p, v)))(imgs, bkgs, p0, valid)
    tfit = psf_fit.make_psf_fitter(prf_from_jax(jp, "cpu"), (h, w), S, lhood, n_iters=4)
    p, mdl, var = tfit(t(imgs), t(bkgs), 1.0, t(p0), t(valid))
    _check_fit(n(p), n(p_ref), valid, S)
    np.testing.assert_allclose(n(mdl), n(mdl_ref), rtol=2e-2, atol=2.0)
    np.testing.assert_allclose(n(var)[:, 0], n(var_ref)[:, 0], rtol=2e-2)


@pytest.fixture(scope="module")
def psf_sector(tmp_path_factory):
    """The JAX package's PSF test sector (tests/test_psf_models.py psf_setup)."""
    d = str(tmp_path_factory.mktemp("torch_psf") / "sector")
    os.makedirs(d)
    sim = simulate_sector(SimConfig(shape=(96, 96), n_times=12, n_stars=18, seed=51,
                                    tmag_range=(8.0, 12.5), psf_sigma=SIGMA))
    sim.write_ffis(d)
    sim.write_catalog(d)
    assert prepare_cmd.main(["-q", d]) == 0
    assert todo_cmd.main(["-q", d]) == 0
    return sim, d


def _assert_lc_close(got, want, what):
    scale = 1e-4 * np.nanmedian(np.abs(want["flux"]))
    for k in ("flux", "flux_err", "flux_background", "pos_centroid"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                   atol=scale if k.startswith("flux") else 1e-4,
                                   equal_nan=True, err_msg=f"{what} {k}")


@pytest.mark.parametrize("kind", ["gaussian", "table"])
def test_extract_psf_batch_matches_jax(psf_sector, kind, tmp_path):
    sim, d = psf_sector
    jctx = JaxSectorContext(d, 1, 3, 2)
    tctx = context_from_jax(jctx, "cpu")
    jp = _jax_prf(kind, tmp_path)
    sids = [int(s) for s in sim.starid]
    want = jax_psf_fit.extract_psf_batch(jctx, sids, prf=jp)
    recorder = StageTimer()
    with recorder.recording():
        got = psf_fit.extract_psf_batch(tctx, sids, prf=prf_from_jax(jp, "cpu"))
    # On the CPU both routes are the plain fitter:
    assert recorder.timings["psf_instances"] > 0
    assert recorder.timings.get("psf_fused_instances", 0) == 0
    assert [r.starid for r in got] == sids
    for g, w in zip(got, want):
        assert g.status.value == w.status.value, g.starid
        assert g.stamp == w.stamp, g.starid
        assert g.method == w.method == "psf"
        np.testing.assert_array_equal(g.mask, w.mask)
        _assert_lc_close(g.lightcurve, w.lightcurve, g.starid)
        assert g.details["n_stars_fit"] == w.details["n_stars_fit"]
    jctx.close()
    tctx.close()


def test_run_drain_psf_matches_jax(psf_sector, tmp_path, monkeypatch):
    sim, d = psf_sector
    d_jax, d_torch = str(tmp_path / "jax"), str(tmp_path / "torch")
    for dst in (d_jax, d_torch):
        shutil.copytree(d, dst, ignore=shutil.ignore_patterns("*.fits.gz", "c1800"))
    t0 = float(sim.time[0]) + 2457000.0
    monkeypatch.setattr(jax_dispatcher, "default_time_corrector",
                        lambda: JaxTimeCorrector(JaxEphemeris.synthetic(t0 - 5, t0 + 10)))
    monkeypatch.setattr(torch_dispatcher, "default_time_corrector",
                        lambda: TimeCorrector(SpacecraftEphemeris.synthetic(t0 - 5, t0 + 10)))
    monkeypatch.setattr(JaxPRF, "gaussian", staticmethod(_jax_gaussian))
    assert jax_run_drain(d_jax, 3, method="psf") == len(sim.starid)
    assert torch_run_drain(d_torch, 3, method="psf", device="cpu") == len(sim.starid)

    def products(root):
        out = {}
        for path in glob.glob(os.path.join(root, "**", "*tasoc_lc.fits.gz"), recursive=True):
            lc = pf.read_fits(path)[1].data
            out[os.path.basename(path)] = {"flux": np.asarray(lc["FLUX_RAW"]),
                                           "flux_err": np.asarray(lc["FLUX_RAW_ERR"])}
        return out

    want, got = products(d_jax), products(d_torch)
    assert sorted(got) == sorted(want) and len(want) == len(sim.starid)
    for name in want:
        scale = 1e-4 * np.nanmedian(np.abs(want[name]["flux"]))
        for k in ("flux", "flux_err"):
            np.testing.assert_allclose(got[name][k], want[name][k], rtol=1e-4, atol=scale,
                                       equal_nan=True, err_msg=f"{name} {k}")
