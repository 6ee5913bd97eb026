"""Port parity of halo photometry, on the CPU.

Every input is made once (numpy seeds, or the JAX package's own test data
and sector, tests/test_halo.py) and handed to both packages.

Tolerances are the JAX suite's own between its two formulations of the
descent (tests/test_halo.py:62-66): weights rtol 5e-4, atol 1e-6, objective
values rel 1e-3.  The light curves and weightmaps are functions of the
weights alone (float64 on the host in both packages), so they carry the
weights' rtol; statuses, error texts, saturated-pixel counts and cadence
ranges are exact.
"""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import n, t

from photometry_tpu.models import halo as jax_halo
from photometry_tpu.prepare import prepare_photometry
from photometry_tpu.core.engine import SectorContext as JaxSectorContext
from photometry_tpu.sim.simulator import SimConfig, simulate_sector

from photometry_tpu_torch.core import dispatcher
from photometry_tpu_torch.core.engine import SectorContext, context_from_jax
from photometry_tpu_torch.core.status import STATUS
from photometry_tpu_torch.models import halo

W_RTOL, W_ATOL, OBJ_REL = 5e-4, 1e-6, 1e-3


def _assert_weights(got, want, what):
    np.testing.assert_allclose(n(got), n(want), rtol=W_RTOL, atol=W_ATOL, err_msg=what)


def _noisy_pixels():
    """tests/test_halo.py test_tvmin_downweights_noisy_pixels' data."""
    rng = np.random.default_rng(3)
    T, P = 200, 10
    signal = 1.0 + 0.01 * np.sin(np.linspace(0, 8 * np.pi, T))
    fn = np.empty((T, P))
    for p in range(P):
        noise = 0.001 if p < 5 else 0.1
        fn[:, p] = signal * (1 + rng.normal(0, noise, T))
    return fn.astype(np.float32)


@pytest.mark.parametrize("objective", halo.OBJECTIVES)
def test_tvmin_weights_matches_jax(objective):
    fn = _noisy_pixels()
    good = np.ones(len(fn), bool)
    good[[17, 18, 90]] = False
    w_j, v_j = jax_halo.tvmin_weights(jnp.asarray(fn), jnp.asarray(good), objective=objective)
    w_t, v_t = halo.tvmin_weights(t(fn), t(good), objective=objective)
    _assert_weights(w_t, w_j, objective)
    assert float(v_t) == pytest.approx(float(v_j), rel=OBJ_REL)
    assert float(w_t.sum()) == pytest.approx(1.0, rel=1e-5)
    assert float(w_t[:5].sum()) > 0.8


def test_tvmin_weights_batch_matches_jax():
    """tests/test_halo.py test_tvmin_batch_padding_parity's padded data."""
    rng = np.random.default_rng(11)
    T, sizes, Ppad = 150, (7, 12, 5), 16
    signal = 1.0 + 0.02 * np.sin(np.linspace(0, 6 * np.pi, T))
    fn_pad = np.ones((len(sizes), T, Ppad), np.float32)
    pix_ok = np.zeros((len(sizes), Ppad), bool)
    goods = np.ones((len(sizes), T), bool)
    for i, P in enumerate(sizes):
        fn_pad[i, :, :P] = signal[:, None] * (1 + rng.normal(0, 0.01, (T, P)))
        pix_ok[i, :P] = True
        goods[i, rng.integers(0, T, 5 + 3 * i)] = False
    w_j, v_j = jax_halo.tvmin_weights_batch(jnp.asarray(fn_pad), jnp.asarray(goods),
                                            jnp.asarray(pix_ok))
    w_t, v_t = halo.tvmin_weights_batch(t(fn_pad), t(goods), t(pix_ok))
    _assert_weights(w_t, w_j, "batch")
    np.testing.assert_allclose(n(v_t), n(v_j), rtol=OBJ_REL)
    w_t = n(w_t)
    assert np.all(w_t[~pix_ok] == 0.0), "padded pixels must get weight exactly 0"
    np.testing.assert_allclose(w_t.sum(axis=1), 1.0, rtol=1e-5)
    # Each row equals the unpadded single-target descent:
    for i, P in enumerate(sizes):
        w_i, _ = halo.tvmin_weights(t(fn_pad[i, :, :P]), t(goods[i]))
        _assert_weights(w_t[i, :P], w_i, f"row {i}")


def test_tv_derivative_at_zero_is_plus_one():
    """|x|'(0) = +1 as JAX takes it (torch's autograd takes 0).

    Pixels 0 and 1 step by +d and -d between cadences 40 and 41, the other
    pixels hold still over cadences 39-41 (d = 2^-6, so every difference is
    exact): at the uniform starting weights a first- and a second-order
    difference row have dF exactly 0 with a nonzero row of D, and the first
    Adam step moves both logits by lr one way or the other.
    """
    rng = np.random.default_rng(5)
    T, P, d = 96, 6, 2.0 ** -6
    fn = np.ones((T, P), np.float32)
    fn[:, 2:] += rng.normal(0, 0.002, (T, P - 2)).astype(np.float32)
    fn[41:, 0] += d
    fn[41:, 1] -= d
    fn[39:42, 2:] = fn[40, 2:]
    D = fn[41] - fn[40]
    assert D[0] == d and D[1] == -d and np.all(D[2:] == 0)
    for objective in ("tv", "tv_o2"):
        w_j, v_j = jax_halo.tvmin_weights(jnp.asarray(fn), jnp.ones(T, bool),
                                          objective=objective)
        w_t, v_t = halo.tvmin_weights(t(fn), torch.ones(T, dtype=torch.bool),
                                      objective=objective)
        _assert_weights(w_t, w_j, objective)
        assert float(v_t) == pytest.approx(float(v_j), rel=OBJ_REL)


def test_find_split_times_matches_jax():
    tt = np.linspace(1330, 1355, 100)
    gap = np.concatenate([np.linspace(2000, 2012, 50), np.linspace(2014, 2026, 50)])
    cases = [(1, tt), (2, tt), (42, gap), (42, np.linspace(2000, 2026, 100))]
    for sector, time in cases:
        tc = np.full(len(time), 0.003)
        assert halo.find_split_times(sector, time, tc) == \
            jax_halo.find_split_times(sector, time, tc), sector
    assert halo.find_split_times(1, tt, np.zeros(100)) == (1339.0, 1347.366, 1349.315)


def test_invalid_objective():
    for fn in (lambda: halo.tvmin_weights(torch.ones(10, 3), torch.ones(10, dtype=torch.bool),
                                          objective="nope"),
               lambda: halo.tvmin_weights_batch(torch.ones(1, 10, 3),
                                                torch.ones(1, 10, dtype=torch.bool),
                                                torch.ones(1, 3, dtype=torch.bool),
                                                objective="nope")):
        with pytest.raises(ValueError, match="Invalid halo objective"):
            fn()


@pytest.fixture(scope="module")
def halo_sector(tmp_path_factory):
    """tests/test_halo.py's halo_setup sector, with both packages' contexts."""
    d = str(tmp_path_factory.mktemp("torch_halo"))
    sim = simulate_sector(SimConfig(shape=(96, 96), n_times=20, n_stars=12, seed=61,
                                    tmag_range=(4.8, 12.0)))
    sim.write_ffis(d)
    sim.write_catalog(d)
    prepare_photometry(d)
    jctx = JaxSectorContext(d, 1, 3, 2)
    tctx = context_from_jax(jctx, "cpu")
    yield sim, jctx, tctx
    jctx.close()
    tctx.close()


def _saturated(jctx, tctx, sid):
    """Both contexts with 3x3 pixels around ``sid`` above SATURATION_FLUX
    (tests/test_halo.py test_halo_objective_and_sigclip_on_saturated_sim)."""
    tgt = jctx.catalog.target(sid)
    row, col = jctx.target_position(tgt["ra"], tgt["decl"])
    r, c = int(round(row)), int(round(col))
    images = np.array(jctx.images)
    images[:, r - 1:r + 2, c - 1:c + 2] = 2.0 * halo.SATURATION_FLUX
    j2 = JaxSectorContext.__new__(JaxSectorContext)
    j2.__dict__.update(jctx.__dict__)
    j2.images = jnp.asarray(images)
    t2 = SectorContext.__new__(SectorContext)
    t2.__dict__.update(tctx.__dict__)
    t2.images = torch.as_tensor(images)
    return j2, t2


@pytest.mark.parametrize("kw", [{}, {"sigclip": True},
                                {"objective": "tv_o2", "maxiter": 41, "sigclip": True},
                                {"objective": "l2v", "maxiter": 41, "sigclip": True},
                                {"maxiter": 21, "saturate": True}],
                         ids=["tv", "tv-sigclip", "tv_o2-sigclip", "l2v-sigclip", "saturated"])
def test_extract_halo_batch_matches_jax(halo_sector, kw):
    sim, jctx, tctx = halo_sector
    kw = dict(kw)
    sids = [int(s) for s in sim.starid[np.argsort(sim.tmag)[:3]]]
    saturate = kw.pop("saturate", False)
    if saturate:
        jctx, tctx = _saturated(jctx, tctx, sids[0])
    want = jax_halo.extract_halo_batch(jctx, sids, **kw)
    got = halo.extract_halo_batch(tctx, sids, **kw)
    n_ok = 0
    for g, w in zip(got, want):
        assert g.starid == w.starid and g.method == w.method == "halo"
        assert g.status.value == w.status.value, g.starid
        assert g.details.get("errors") == w.details.get("errors"), g.starid
        if not w.lightcurve:
            continue
        n_ok += 1
        assert g.stamp == w.stamp and g.skip_targets == w.skip_targets
        np.testing.assert_array_equal(g.mask, w.mask)
        for k in ("flux", "flux_err"):
            np.testing.assert_allclose(g.lightcurve[k], w.lightcurve[k], rtol=W_RTOL,
                                       equal_nan=True, err_msg=f"{g.starid} {k}")
        np.testing.assert_allclose(g.lightcurve["pos_centroid"], w.lightcurve["pos_centroid"],
                                   rtol=1e-12)
        gw, ww = g.details["halo_weightmap"], w.details["halo_weightmap"]
        for k in ("initial_cadence", "final_cadence", "sat_pixels"):
            assert gw[k] == ww[k], (g.starid, k)
        np.testing.assert_allclose(gw["weightmap"], ww["weightmap"], rtol=W_RTOL,
                                   atol=W_ATOL * np.nanmax(np.abs(ww["weightmap"])),
                                   equal_nan=True, err_msg=f"{g.starid} weightmap")
        assert g.details["mask_size"] == w.details["mask_size"]
        for k in ("HALO_OBJ", "HALO_MXI", "HALO_SCL"):
            assert g.additional_headers[k] == w.additional_headers[k]
        assert g.additional_headers["HALO_VER"][0] == "photometry-tpu-torch"
    assert n_ok >= 2
    if saturate:
        assert all(s >= 9 for s in got[0].details["halo_weightmap"]["sat_pixels"])


def test_extract_halo_batch_invalid_objective(halo_sector):
    sim, jctx, tctx = halo_sector
    for fn, ctx in ((jax_halo.extract_halo_batch, jctx), (halo.extract_halo_batch, tctx)):
        with pytest.raises(ValueError, match="Invalid halo objective"):
            fn(ctx, [int(sim.starid[0])], objective="nope")


def test_halo_switch_queue_defers_and_flushes(halo_sector, tmp_path, monkeypatch):
    """tests/test_halo.py test_halo_switch_queue_defers_and_flushes, on the port."""
    sim, _, ctx = halo_sector
    bright = [int(s) for s in sim.starid[np.argsort(sim.tmag)[:2]]]
    monkeypatch.setattr(dispatcher, "_needs_halo_switch",
                        lambda res, tmag_limit, flux_limit: res.starid in bright)

    def task(sid, prio):
        return {"starid": sid, "datasource": "ffi", "sector": 1, "camera": 3, "ccd": 2,
                "cadence": 1800, "priority": prio, "method": None,
                "tmag": float(sim.tmag[sim.starid == sid][0])}

    hq = dispatcher.HaloSwitchQueue(min_flush=2)
    out = str(tmp_path / "lc")
    res1 = dispatcher.photometry_batch(ctx, [task(bright[0], 1)], output_folder=out, version=1,
                                       halo_queue=hq)[0]
    assert res1.details.get("halo_switch_deferred")
    assert hq.pending == 1 and not hq.should_flush()
    assert not glob.glob(os.path.join(out, "*.fits.gz"))

    dispatcher.photometry_batch(ctx, [task(bright[1], 2)], output_folder=out, version=1,
                                halo_queue=hq)
    assert hq.pending == 2 and hq.should_flush()
    flushed = hq.flush()
    assert hq.pending == 0
    assert sorted(int(tk["starid"]) for tk, _ in flushed) == sorted(bright)
    for tk, res in flushed:
        assert res.method == "halo" and res.status in (STATUS.OK, STATUS.WARNING)
        assert "Automatically switched to Halo photometry" in res.details["errors"]
        assert not res.details.get("halo_switch_deferred")
        assert os.path.exists(res.details["filepath_lightcurve"])
    direct = halo.extract_halo_batch(ctx, [int(tk["starid"]) for tk, _ in flushed])
    for (tk, res), ref in zip(flushed, direct):
        np.testing.assert_allclose(res.lightcurve["flux"], ref.lightcurve["flux"], rtol=1e-5,
                                   equal_nan=True)

    # Context pinning: a task from another CCD must force a flush first:
    assert hq.matches(task(bright[0], 9))
    hq.add(ctx, task(bright[0], 9), res1, save=False)
    assert not hq.matches(dict(task(bright[0], 9), ccd=1))
    assert len(hq.flush(force=True)) == 1
