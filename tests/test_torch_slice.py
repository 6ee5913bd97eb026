"""Port parity of the FFI aperture slice, end to end on CPU.

(e) ``extract_aperture_batch`` of both packages on one prepared simulated
    sector — the port's context made from the JAX one by
    ``context_from_jax``.  Statuses, masks, stamps and skip-targets equal;
    flux, flux_err, background and centroid to rtol 1e-4 / atol 1e-3
    (float32 sums in another order); ``details`` metrics to rtol 1e-4.
(f) ``run_drain(method="aperture")`` of both packages on copies of one
    todo, with both ``default_time_corrector``s patched to one
    TimeCorrector: FITS FLUX_RAW / FLUX_RAW_ERR to the (e) tolerance,
    diagnostics rows equal.
"""

import glob
import os
import shutil
import sqlite3

import numpy as np
import pytest

from torch_parity import ATOL, RTOL, assert_extraction_parity

from photometry_tpu.cli import prepare_cmd, todo_cmd
from photometry_tpu.core import dispatcher as jax_dispatcher
from photometry_tpu.core.drain import run_drain as jax_run_drain
from photometry_tpu.core.engine import SectorContext as JaxSectorContext
from photometry_tpu.core.engine import extract_aperture_batch as jax_extract
from photometry_tpu.core.timecorr import SpacecraftEphemeris as JaxEphemeris
from photometry_tpu.core.timecorr import TimeCorrector as JaxTimeCorrector
from photometry_tpu.io import fits as pf
from photometry_tpu.sim.simulator import SimConfig, simulate_sector
from photometry_tpu_torch.core import dispatcher as torch_dispatcher
from photometry_tpu_torch.core.drain import run_drain as torch_run_drain
from photometry_tpu_torch.core.engine import context_from_jax, extract_aperture_batch
from photometry_tpu_torch.core.timecorr import SpacecraftEphemeris, TimeCorrector


#: Absolute float32 perturbation of rel = flux / median - 1 allowed for the
#: variability metrics (see test_extract_aperture_batch_matches_jax).
DREL = 1e-6


@pytest.fixture(scope="module")
def sector(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_slice") / "sector")
    os.makedirs(d)
    sim = simulate_sector(SimConfig(shape=(128, 128), n_times=24, n_stars=25, seed=11,
                                    tmag_range=(8.0, 13.0)))
    sim.write_ffis(d)
    sim.write_catalog(d)
    assert prepare_cmd.main(["-q", d]) == 0
    assert todo_cmd.main(["-q", d]) == 0
    return sim, d


@pytest.fixture(scope="module")
def both(sector):
    sim, d = sector
    jctx = JaxSectorContext(d, 1, 3, 2)
    tctx = context_from_jax(jctx, "cpu")
    sids = [int(s) for s in sim.starid]
    yield jctx, tctx, sids
    jctx.close()
    tctx.close()


def test_extract_aperture_batch_matches_jax(both):
    jctx, tctx, sids = both
    want = jax_extract(jctx, sids)
    got = extract_aperture_batch(tctx, sids)
    assert [r.starid for r in got] == sids
    n_ok = 0
    for g, w in zip(got, want):
        assert g.status.value == w.status.value, g.starid   # each package has its STATUS
        assert g.skip_targets == w.skip_targets, g.starid
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
        np.testing.assert_allclose(g.lightcurve["pos_corr"], w.lightcurve["pos_corr"],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(g.lightcurve["time"], w.lightcurve["time"])
        for k in ("mean_flux", "completeness", "crowdsap", "contamination", "edge_flux",
                  "pos_centroid"):
            if k in w.details:
                np.testing.assert_allclose(g.details[k], w.details[k], rtol=1e-4,
                                           err_msg=f"{g.starid} {k}")
        # The variability metrics are functions of rel = flux / median - 1,
        # which cancels: a flux that differs by a few float32 ulp (sums in
        # another order) moves rel by ~3e-7 absolute (measured max 3.6e-7),
        # up to 3e-3 of these small metrics.  Each gets rtol 1e-4 plus the
        # effect of a DREL = 1e-6 perturbation of rel (variability: of the
        # residual and its trend, over the median relative error).
        std = np.sqrt(w.details["variance"])
        rel_err = np.nanmedian(w.lightcurve["flux_err"]) / abs(w.details["mean_flux"])
        for k, atol in (("rms_hour", DREL), ("ptp", DREL), ("variance", 2 * std * DREL),
                        ("variability", 2 * DREL / rel_err)):
            np.testing.assert_allclose(g.details[k], w.details[k], rtol=1e-4, atol=atol,
                                       err_msg=f"{g.starid} {k}")
        for k in ("mask_size", "stamp_resizes", "stamp", "errors",
                  "nearest_neighbour_px", "nearest_significant_neighbour_px"):
            assert g.details.get(k) == w.details.get(k), (g.starid, k)
        # FITS header values; FLFRCSAP/CROWDSAP are rounded to 6 decimals, so
        # a few-ulp completeness difference can move the last digit:
        assert g.additional_headers.keys() == w.additional_headers.keys()
        for k, (gv, gc) in g.additional_headers.items():
            wv, wc = w.additional_headers[k]
            assert gc == wc and (gv == wv or abs(gv - wv) <= 1.5e-6), (g.starid, k, gv, wv)
    assert n_ok >= len(sids) - 3


def _products(d):
    out = {}
    for path in glob.glob(os.path.join(d, "**", "*tasoc_lc.fits.gz"), recursive=True):
        lc = pf.read_fits(path)[1].data
        out[os.path.basename(path)] = (np.asarray(lc["FLUX_RAW"]), np.asarray(lc["FLUX_RAW_ERR"]))
    return out


def _rows(d):
    with sqlite3.connect(os.path.join(d, "todo.sqlite")) as conn:
        todo = conn.execute("SELECT priority, status FROM todolist ORDER BY priority").fetchall()
        diag = conn.execute(
            "SELECT priority, method_used, mask_size, stamp_width, stamp_height, "
            "stamp_resizes FROM diagnostics ORDER BY priority").fetchall()
        skipped = conn.execute("SELECT * FROM photometry_skipped ORDER BY priority").fetchall()
    return todo, diag, skipped


def test_run_drain_matches_jax(sector, tmp_path, monkeypatch):
    sim, d = sector
    d_jax, d_torch = str(tmp_path / "jax"), str(tmp_path / "torch")
    for dst in (d_jax, d_torch):
        shutil.copytree(d, dst, ignore=shutil.ignore_patterns("*.fits.gz", "c1800"))
    t0 = float(sim.time[0]) + 2457000.0
    monkeypatch.setattr(jax_dispatcher, "default_time_corrector",
                        lambda: JaxTimeCorrector(JaxEphemeris.synthetic(t0 - 5, t0 + 10)))
    monkeypatch.setattr(torch_dispatcher, "default_time_corrector",
                        lambda: TimeCorrector(SpacecraftEphemeris.synthetic(t0 - 5, t0 + 10)))
    n_jax = jax_run_drain(d_jax, 3, method="aperture")
    n_torch = torch_run_drain(d_torch, 3, method="aperture", device="cpu")
    assert n_jax == n_torch == len(sim.starid)
    assert _rows(d_torch) == _rows(d_jax)
    want, got = _products(d_jax), _products(d_torch)
    assert sorted(got) == sorted(want) and len(want) >= len(sim.starid) - 3
    for name in want:
        for a, b in zip(got[name], want[name]):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, equal_nan=True, err_msg=name)
