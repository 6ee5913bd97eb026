"""Port parity of linear PSF photometry, on the CPU.

The same inputs go through the JAX package (on the CPU) and the port.

Tolerances, and why:

- design matrices: rtol 1e-5 plus 1e-5 of the largest value, as the PRF
  renders in tests/test_torch_psf.py (the same float32 table; only the
  order of float32 sums differs).  The batched form equals the port's
  per-frame ``design_matrix`` exactly.
- fluxes of the solves and of ``extract_linpsf_batch``: rtol 1e-4, the
  JAX suite's own batching bound for linPSF (tests/test_psf_models.py:190);
  flux_err and contamination to the same rtol.  Statuses, ``n_stars_fit``,
  masks and the presence of ``AP_CONT`` are exact.
"""

import jax
import numpy as np
import pytest

from torch_parity import n, t

from photometry_tpu.core.engine import SectorContext as JaxSectorContext
from photometry_tpu.models import linpsf as jax_linpsf
from photometry_tpu.models.prf import PRF as JaxPRF
from photometry_tpu.prepare import prepare_photometry
from photometry_tpu.sim.simulator import SimConfig, simulate_sector

from photometry_tpu_torch.core.engine import context_from_jax
from photometry_tpu_torch.models import linpsf
from photometry_tpu_torch.models.prf import prf_from_jax

SIGMA = 1.1
_JAX_PRFS = {}


def _jax_prf(kind):
    """One JAX PRF per kind (the JAX programs take the PRF as a static
    argument: sharing it lets the tests reuse their compiles)."""
    if kind not in _JAX_PRFS:
        g = JaxPRF.gaussian(sigma=SIGMA)
        _JAX_PRFS[kind] = {
            "gaussian": g,
            "table": JaxPRF(g.iprf, g.oversample, g.center_x, g.center_y, info={}),
            "table_os8.5": JaxPRF(g.iprf, 8.5, g.center_x, g.center_y, info={}),
        }[kind]
    return _JAX_PRFS[kind]


@pytest.mark.parametrize("kind", ["gaussian", "table", "table_os8.5"])
def test_design_matrix_batch_matches_jax(kind):
    jp = _jax_prf(kind)
    tp = prf_from_jax(jp, "cpu")
    assert tp._grid_separable == jp._grid_separable
    rng = np.random.default_rng(7)
    N, T, S, shape = 3, 4, 5, (15, 17)
    rows = rng.uniform(-3, 17, (N, T, S)).astype(np.float32)
    cols = rng.uniform(-3, 19, (N, T, S)).astype(np.float32)
    rows[:, :, -1] = -1000.0                           # a dummy star
    got = n(tp.design_matrix_batch(t(rows), t(cols), shape))
    assert got.shape == (N, T, S, shape[0] * shape[1])
    frame = jax.jit(jax.vmap(jax.vmap(lambda r, c: jp.design_matrix(r, c, shape))))
    want = np.swapaxes(np.asarray(frame(rows, cols)), -1, -2)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    assert np.all(got[:, :, -1] == 0.0)
    for i in range(N):
        for j in range(T):
            np.testing.assert_array_equal(
                n(tp.design_matrix(t(rows[i, j]), t(cols[i, j]), shape)).T, got[i, j])


def test_linpsf_timeseries_matches_jax():
    jp = _jax_prf("gaussian")
    tp = prf_from_jax(jp, "cpu")
    rng = np.random.default_rng(9)
    T, S, shape = 6, 4, (15, 15)
    rows = (np.array([7.0, 5.0, 10.0, -1000.0]) + rng.normal(0, 0.1, (T, S))).astype(np.float32)
    cols = (np.array([7.0, 10.0, 4.0, -1000.0]) + rng.normal(0, 0.1, (T, S))).astype(np.float32)
    valid = np.array([True, True, True, False])
    flux = np.array([5000.0, 2000.0, 800.0, 0.0])
    A = np.asarray(jax.vmap(lambda r, c: jp.design_matrix(r, c, shape))(rows, cols))
    images = (A @ flux).reshape(T, *shape) + rng.normal(0, 5.0, (T, *shape))
    images[2, 3, 4] = np.nan
    images[4] = np.inf
    images = images.astype(np.float32)
    want = jax_linpsf.linpsf_timeseries(images, rows, cols, valid, prf=jp, shape=shape, S=S)
    got = linpsf.linpsf_timeseries(t(images), t(rows), t(cols), t(valid), tp, shape, S)
    for k in ("fluxes", "models"):
        w = np.asarray(want[k])
        np.testing.assert_allclose(n(got[k]), w, rtol=1e-4, atol=1e-4 * np.abs(w).max(),
                                   err_msg=k)
    assert np.all(n(got["fluxes"])[:, 3] == 0.0)
    np.testing.assert_allclose(n(got["fluxes"])[[0, 1, 2, 3, 5], :3].mean(0), flux[:3],
                               rtol=0.05)


@pytest.fixture(scope="module")
def psf_sector(tmp_path_factory):
    """tests/test_psf_models.py's psf_setup sector, with both packages' contexts."""
    d = str(tmp_path_factory.mktemp("torch_linpsf"))
    sim = simulate_sector(SimConfig(shape=(96, 96), n_times=12, n_stars=18, seed=51,
                                    tmag_range=(8.0, 12.5), psf_sigma=SIGMA))
    sim.write_ffis(d)
    sim.write_catalog(d)
    prepare_photometry(d)
    jctx = JaxSectorContext(d, 1, 3, 2)
    tctx = context_from_jax(jctx, "cpu")
    yield sim, jctx, tctx
    jctx.close()
    tctx.close()


@pytest.mark.parametrize("kind", ["gaussian", "table"])
def test_extract_linpsf_batch_matches_jax(psf_sector, kind):
    sim, jctx, tctx = psf_sector
    jp = _jax_prf(kind)
    sids = [int(s) for s in sim.starid]
    keep_diag = kind == "table"
    want = jax_linpsf.extract_linpsf_batch(jctx, sids, prf=jp, keep_diag=keep_diag)
    got = linpsf.extract_linpsf_batch(tctx, sids, prf=prf_from_jax(jp, "cpu"),
                                      keep_diag=keep_diag)
    assert [r.starid for r in got] == sids
    n_warn = 0
    for g, w in zip(got, want):
        assert g.method == w.method == "linpsf"
        assert g.status.value == w.status.value, g.starid
        n_warn += g.status.name == "WARNING"
        assert g.stamp == w.stamp
        assert g.details["n_stars_fit"] == w.details["n_stars_fit"]
        np.testing.assert_array_equal(g.mask, w.mask)
        assert ("AP_CONT" in g.additional_headers) == ("AP_CONT" in w.additional_headers)
        scale = 1e-4 * np.nanmedian(np.abs(w.lightcurve["flux"]))
        for k in ("flux", "flux_err", "flux_background"):
            np.testing.assert_allclose(g.lightcurve[k], w.lightcurve[k], rtol=1e-4,
                                       atol=scale if k == "flux_background" else 0.0,
                                       equal_nan=True, err_msg=f"{g.starid} {k}")
        np.testing.assert_allclose(g.lightcurve["pos_centroid"], w.lightcurve["pos_centroid"],
                                   rtol=1e-6)
        np.testing.assert_allclose(g.details["contamination"], w.details["contamination"],
                                   rtol=1e-4, atol=1e-7)
        if keep_diag:
            wm = w.details["diag_fit"]["model"]
            np.testing.assert_allclose(g.details["diag_fit"]["model"], wm, rtol=1e-4,
                                       atol=1e-4 * np.abs(wm).max())
            assert g.details["diag_fit"]["cadence"] == w.details["diag_fit"]["cadence"]
    assert n_warn >= 1, "no target crossed the contamination WARNING"


def test_linpsf_chunks_cover_the_group():
    """The working-set budget splits big groups without losing a target."""
    tp = prf_from_jax(_jax_prf("table"), "cpu")
    group = list(range(1000))
    chunks = list(linpsf._chunks(group, 512, 17, 17, 5, tp))
    assert [x for c in chunks for x in c] == group and len(chunks) > 1
