"""Port parity of Target Pixel Files, on the CPU.

On tests/test_integration_tpf.py's kind of sector (a 96x96 simulated
FFI sector with two TPFs, one of them with a secondary target in its stamp,
one gzipped and one not), made by the JAX package's prepare and todo CLIs:

- ``TpfContext`` of both packages: time, shape, cubes, sum image,
  collected pixels, SPOC aperture, motion model and positions equal.
- ``extract_aperture_batch`` on each TPF primary and on the ``tpf:NNN``
  group: statuses, masks and APERTURE bits equal, fluxes to rtol 1e-4 /
  atol 1e-3 (tests/test_bandext.py:41), ``pos_corr`` within 2e-5 px.
- ``open_context`` builds a TpfContext for ``tpf`` and ``tpf:NNN`` tasks;
  ``ContextCache`` neither caches it nor evicts the FFI context for it.
- ``method="psf"`` on a TPF, at tests/test_torch_psf.py's tolerances.
- The mixed FFI + TPF + secondary pipeline: each package's photometry CLI
  drains a copy of the todo; statuses and methods per task equal, light
  curves to the extraction tolerance.
- A 20-s TPF at T = 6,000 (tests/test_long_time_axis.py:24), against the
  JAX package and the injected flux.
"""

import glob
import os
import shutil
import sqlite3

import numpy as np
import pytest
import torch

from torch_parity import ATOL, RTOL, assert_extraction_parity

from photometry_tpu.cli import photometry_cmd as jax_photometry_cmd
from photometry_tpu.cli import prepare_cmd, todo_cmd
from photometry_tpu.core import dispatcher as jax_dispatcher
from photometry_tpu.core.engine import TpfContext as JaxTpfContext
from photometry_tpu.core.engine import extract_aperture_batch as jax_extract
from photometry_tpu.core.timecorr import SpacecraftEphemeris as JaxEphemeris
from photometry_tpu.core.timecorr import TimeCorrector as JaxTimeCorrector
from photometry_tpu.io import fits as pf
from photometry_tpu.models import psf_fit as jax_psf_fit
from photometry_tpu.sim.simulator import SimConfig, simulate_sector

from photometry_tpu_torch.cli import photometry_cmd
from photometry_tpu_torch.core import dispatcher
from photometry_tpu_torch.core.engine import SectorContext, TpfContext, extract_aperture_batch
from photometry_tpu_torch.core.status import STATUS
from photometry_tpu_torch.core.timecorr import SpacecraftEphemeris, TimeCorrector
from photometry_tpu_torch.models import psf_fit


def _tasks(d):
    with sqlite3.connect(os.path.join(d, "todo.sqlite")) as conn:
        conn.row_factory = sqlite3.Row
        return [dict(r) for r in conn.execute(
            "SELECT priority, starid, sector, camera, ccd, cadence, datasource, method, tmag "
            "FROM todolist ORDER BY priority;")]


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_tpf") / "mix")
    os.makedirs(d)
    sim = simulate_sector(SimConfig(shape=(96, 96), n_times=8, n_stars=24, seed=23,
                                    tmag_range=(8.0, 12.0)))
    sim.write_ffis(d)
    sim.write_catalog(d)
    primaries = [int(sim.starid[0]), int(sim.starid[2])]
    sim.write_tpf(d, primaries[0], stamp=(15, 15), n_times=40)
    sim.write_tpf(d, primaries[1], stamp=(15, 15), n_times=40, gzip=False)
    assert prepare_cmd.main(["-q", d]) == 0
    assert todo_cmd.main(["-q", d]) == 0
    tasks = _tasks(d)
    assert sorted(t["starid"] for t in tasks if t["datasource"] == "tpf") == sorted(primaries)
    assert any(t["datasource"].startswith("tpf:") for t in tasks), "no secondary target"
    return sim, d, tasks


def test_tpf_context_matches_jax(mixed):
    sim, d, tasks = mixed
    for task in [t for t in tasks if t["datasource"] == "tpf"]:
        sid = task["starid"]
        j = JaxTpfContext(d, sid)
        g = TpfContext(d, sid, sector=task["sector"], cadence=task["cadence"], device="cpu")
        assert g.datasource == "tpf" and g.device == torch.device("cpu")
        for k in ("sector", "camera", "ccd", "data_rel", "cadence", "num_frm", "n_readout",
                  "readnoise", "gain", "pixel_offset_row", "pixel_offset_col", "n_times"):
            assert getattr(g, k) == getattr(j, k), k
        assert g.shape == tuple(j.shape) == (15, 15)
        for k in ("time", "timecorr", "cadenceno", "quality", "collected", "tpf_aperture",
                  "bkg_pixels_used"):
            np.testing.assert_array_equal(getattr(g, k), getattr(j, k), err_msg=k)
        np.testing.assert_array_equal(g.sumimage, j.sumimage)
        for k in ("images", "images_err", "backgrounds", "pixelflags"):
            assert getattr(g, k).dtype == (torch.uint8 if k == "pixelflags" else torch.float32)
            np.testing.assert_array_equal(getattr(g, k).numpy(), np.asarray(getattr(j, k)),
                                          err_msg=k)
        assert g.motion.warpmode == j.motion.warpmode == "translation"
        t_nc = g.time - g.timecorr
        cols, rows = np.array([3.0, 7.5]) + g.pixel_offset_col, np.array([4.0, 6.5]) + \
            g.pixel_offset_row
        np.testing.assert_allclose(g.motion.jitter_batch(t_nc, cols, rows),
                                   j.motion.jitter_batch(t_nc, cols, rows), rtol=0, atol=1e-9)
        tgt = g.catalog.target(sid)
        assert g.target_position(tgt["ra"], tgt["decl"]) == j.target_position(tgt["ra"],
                                                                              tgt["decl"])
        np.testing.assert_array_equal(g.corrected_time(0.0, 0.0)[0], j.corrected_time(0, 0)[0])
        g.close()
        j.close()


def _groups(tasks):
    """(context star, the task's starids, datasource) of every TPF primary and tpf:NNN group."""
    out = [(t["starid"], [t["starid"]], "tpf") for t in tasks if t["datasource"] == "tpf"]
    secondary = {}
    for t in tasks:
        if t["datasource"].startswith("tpf:"):
            secondary.setdefault(int(t["datasource"][4:]), []).append(t["starid"])
    return out + [(p, sids, f"tpf:{p}") for p, sids in secondary.items()]


def test_tpf_extraction_matches_jax(mixed):
    sim, d, tasks = mixed
    n_ok = 0
    for primary, sids, ds in _groups(tasks):
        j = JaxTpfContext(d, primary)
        g = TpfContext(d, primary, device="cpu")
        want = jax_extract(j, sids)
        got = extract_aperture_batch(g, sids)
        for a, b in zip(got, want):
            assert a.status.value == b.status.value, (ds, a.starid)
            assert a.stamp == b.stamp == (0, 15, 0, 15)
            assert a.details.get("errors") == b.details.get("errors")
            assert a.details["stamp_resizes"] == 0
            if b.mask is None:
                continue
            n_ok += 1
            np.testing.assert_array_equal(a.mask, b.mask, err_msg=ds)
            np.testing.assert_array_equal(a.aperture_image, b.aperture_image, err_msg=ds)
            # the SPOC aperture, its 2|8 cleared, and 2|8 on our mask:
            np.testing.assert_array_equal(a.aperture_image & ~10, g.tpf_aperture & ~10)
            assert np.all((a.aperture_image & 10 == 10) == a.mask)
            keys = ("flux", "flux_err", "flux_background", "pos_centroid", "shenanigans_any")
            assert_extraction_parity([a.lightcurve[k] for k in keys],
                                     [b.lightcurve[k] for k in keys])
            np.testing.assert_allclose(a.lightcurve["pos_corr"], b.lightcurve["pos_corr"],
                                       rtol=0, atol=2e-5)
            assert np.abs(a.lightcurve["pos_corr"]).max() > 1e-3     # the jitter is there
            np.testing.assert_array_equal(a.lightcurve["time"], b.lightcurve["time"])
            np.testing.assert_array_equal(a.stamp_wcs.crpix, b.stamp_wcs.crpix)
            assert a.skip_targets == b.skip_targets
        g.close()
        j.close()
    assert n_ok >= 3


def test_open_context_and_cache(mixed):
    sim, d, tasks = mixed
    ffi = next(t for t in tasks if t["datasource"] == "ffi")
    for task in tasks:
        if task["datasource"] == "ffi":
            continue
        ctx = dispatcher.open_context(d, task, device="cpu")
        assert isinstance(ctx, TpfContext) and ctx.device == torch.device("cpu")
        primary = int(task["datasource"][4:]) if ":" in task["datasource"] else task["starid"]
        assert ctx.tpf.starid == primary
        ctx.close()
    with dispatcher.ContextCache(device="cpu") as cache:
        first, cached = cache.get(d, ffi)
        assert isinstance(first, SectorContext) and cached
        tpf_task = next(t for t in tasks if t["datasource"].startswith("tpf"))
        ctx, cached = cache.get(d, tpf_task)
        assert isinstance(ctx, TpfContext) and not cached
        cache.release(ctx, cached)
        again, cached = cache.get(d, ffi)
        assert again is first and cached


def test_psf_on_tpf_matches_jax(mixed):
    sim, d, tasks = mixed
    n_ok = 0
    for primary, sids, ds in _groups(tasks):
        j = JaxTpfContext(d, primary)
        g = TpfContext(d, primary, device="cpu")
        want = jax_psf_fit.extract_psf_batch(j, sids)
        got = psf_fit.extract_psf_batch(g, sids)
        for a, b in zip(got, want):
            assert a.method == b.method == "psf"
            assert a.status.value == b.status.value, (ds, a.starid)
            assert a.stamp == b.stamp == (0, 15, 0, 15)
            if not b.lightcurve:
                continue
            n_ok += 1
            scale = 1e-4 * np.nanmedian(np.abs(b.lightcurve["flux"]))
            for k in ("flux", "flux_err", "flux_background", "pos_centroid"):
                np.testing.assert_allclose(a.lightcurve[k], b.lightcurve[k], rtol=1e-4,
                                           atol=scale if k.startswith("flux") else 1e-4,
                                           equal_nan=True, err_msg=f"{ds} {a.starid} {k}")
            np.testing.assert_array_equal(a.aperture_image, b.aperture_image)
        g.close()
        j.close()
    assert n_ok >= 2


def _rows(d):
    with sqlite3.connect(os.path.join(d, "todo.sqlite")) as conn:
        return conn.execute(
            "SELECT t.priority, t.datasource, t.status, d.method_used FROM todolist t "
            "LEFT JOIN diagnostics d ON t.priority = d.priority ORDER BY t.priority;").fetchall()


def _products(d):
    out = {}
    for path in glob.glob(os.path.join(d, "**", "*tasoc_lc.fits.gz"), recursive=True):
        lc = pf.read_fits(path)[1].data
        out[os.path.relpath(path, d)] = (np.asarray(lc["FLUX_RAW"]),
                                         np.asarray(lc["FLUX_RAW_ERR"]))
    return out


def test_mixed_pipeline_drain_matches_jax(mixed, tmp_path, monkeypatch):
    sim, d, tasks = mixed
    d_jax, d_torch = str(tmp_path / "jax"), str(tmp_path / "torch")
    for dst in (d_jax, d_torch):
        shutil.copytree(d, dst)
    t0 = float(sim.time[0]) + 2457000.0
    monkeypatch.setattr(jax_dispatcher, "default_time_corrector",
                        lambda: JaxTimeCorrector(JaxEphemeris.synthetic(t0 - 5, t0 + 10)))
    monkeypatch.setattr(dispatcher, "default_time_corrector",
                        lambda: TimeCorrector(SpacecraftEphemeris.synthetic(t0 - 5, t0 + 10)))
    assert jax_photometry_cmd.main(["-q", "--all", "--version", "7", d_jax]) == 0
    assert photometry_cmd.main(["-q", "--all", "--version", "7", "--device", "cpu",
                                d_torch]) == 0
    rows = _rows(d_torch)
    assert rows == _rows(d_jax)
    good = (STATUS.OK.value, STATUS.WARNING.value, STATUS.SKIPPED.value)
    assert all(r[2] is not None for r in rows)
    assert all(r[2] in good for r in rows if r[1] == "tpf")
    assert {r[1].split(":")[0] for r in rows if r[3] == "aperture"} == {"ffi", "tpf"}
    want, got = _products(d_jax), _products(d_torch)
    assert sorted(got) == sorted(want)
    assert any(name.startswith("c0120") for name in got)     # the 120-s TPF products
    for name in want:
        for a, b in zip(got[name], want[name]):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, equal_nan=True, err_msg=name)


@pytest.fixture(scope="module")
def fast_tpf(tmp_path_factory):
    """tests/test_long_time_axis.py's 20-s TPF: 6,000 cadences."""
    d = str(tmp_path_factory.mktemp("torch_fast_tpf"))
    sim = simulate_sector(SimConfig(shape=(96, 96), n_times=8, n_stars=8, seed=123,
                                    tmag_range=(8.0, 11.0)))
    sim.write_catalog(d)
    sim.write_tpf(d, int(sim.starid[0]), cadence=20, n_times=6000)
    return sim, d


def test_fast_tpf_long_time_axis(fast_tpf):
    sim, d = fast_tpf
    sid = int(sim.starid[0])
    ctx = TpfContext(d, sid, device="cpu")
    assert ctx.n_times == 6000 and ctx.cadence == 20
    res = extract_aperture_batch(ctx, [sid])[0]
    jctx = JaxTpfContext(d, sid)
    ref = jax_extract(jctx, [sid])[0]
    assert res.status.value == ref.status.value
    assert res.status in (STATUS.OK, STATUS.WARNING)
    np.testing.assert_array_equal(res.mask, ref.mask)
    flux = res.lightcurve["flux"]
    assert flux.shape == (6000,)
    np.testing.assert_allclose(flux, ref.lightcurve["flux"], rtol=RTOL, atol=ATOL,
                               equal_nan=True)
    assert np.isfinite(flux).sum() > 5500
    truth = float(10 ** (-0.4 * (sim.tmag[0] - 20.451)))
    assert 0.8 < np.nanmedian(flux) / truth < 1.2
    assert np.isfinite(res.details["rms_hour"])
    np.testing.assert_allclose(res.details["rms_hour"], ref.details["rms_hour"], rtol=1e-3)
    ctx.close()
    jctx.close()
