"""Port parity of the dispatcher's default path, the drain and the CLI, on the CPU.

- ``photometry_batch`` with default methods on tests/test_deblend_switch.py's
  crowded sector: each target's method, status and both switch decisions
  equal the JAX package's; the linPSF reruns' fluxes to rtol 1e-4
  (tests/test_psf_models.py:190).
- ``run_drain(method=None)`` of both packages on copies of one sector with
  two bright stars on the CCD's edges (the aperture pass quick-breaks, and
  the halo switch fires) and split blends (the deblend switch fires), the
  halo queue's ``min_batch`` set to 2 through the settings: todolist and
  diagnostics rows equal, products written for the same targets, fluxes
  to the method's tolerance (aperture rtol 1e-4 / atol 1e-3 as in
  tests/test_torch_slice.py, linPSF rtol 1e-4, halo the weights' rtol 5e-4
  of tests/test_halo.py:62-66).
- A ``KernelError`` inside either switch's rerun (inline or at a queue's
  flush) propagates; a ``RuntimeError`` keeps the aperture result.
- ``photometry_single`` mirrors tests/test_dispatcher_single.py:25-60, and
  the CLI takes ``--method linpsf`` and ``--method halo``.
"""

import glob
import os
import shutil
import sqlite3

import numpy as np
import pytest

from torch_parity import ATOL, RTOL
from test_deblend_switch import _crowded_sector

from photometry_tpu.cli import prepare_cmd, todo_cmd
from photometry_tpu.core import dispatcher as jax_dispatcher
from photometry_tpu.core.drain import run_drain as jax_run_drain
from photometry_tpu.core.timecorr import SpacecraftEphemeris as JaxEphemeris
from photometry_tpu.core.timecorr import TimeCorrector as JaxTimeCorrector
from photometry_tpu.io import fits as pf
from photometry_tpu.io import settings as jax_settings
from photometry_tpu.sim.simulator import SimConfig, simulate_sector

from photometry_tpu_torch.cli import photometry_cmd
from photometry_tpu_torch.core import dispatcher
from photometry_tpu_torch.core.drain import run_drain
from photometry_tpu_torch.core.engine import context_from_jax
from photometry_tpu_torch.core.status import STATUS
from photometry_tpu_torch.core.timecorr import SpacecraftEphemeris, TimeCorrector
from photometry_tpu_torch.io import settings as torch_settings
from photometry_tpu_torch.ops._kernels import KernelError

SWITCHED = {"halo": "Automatically switched to Halo photometry",
            "linpsf": "Automatically switched to linPSF photometry"}


def _tasks(d):
    with sqlite3.connect(os.path.join(d, "todo.sqlite")) as conn:
        conn.row_factory = sqlite3.Row
        return [dict(r) for r in conn.execute(
            "SELECT priority, starid, sector, camera, ccd, cadence, datasource, method, tmag "
            "FROM todolist WHERE datasource='ffi' ORDER BY priority;")]


def _switched(res):
    return [m for m, text in SWITCHED.items()
            if any(e.startswith(text) for e in res.details.get("errors") or [])]


@pytest.fixture(scope="module")
def crowded(tmp_path_factory):
    sim, d = _crowded_sector(tmp_path_factory.mktemp("torch_crowded"))
    tasks = _tasks(d)
    jctx = jax_dispatcher.open_context(d, tasks[0])
    tctx = context_from_jax(jctx, "cpu")
    yield sim, d, tasks, jctx, tctx
    jctx.close()
    tctx.close()


def test_default_path_matches_jax(crowded):
    sim, d, tasks, jctx, tctx = crowded
    assert all(t["method"] is None for t in tasks)
    want = jax_dispatcher.photometry_batch(jctx, [dict(t) for t in tasks], save=False)
    got = dispatcher.photometry_batch(tctx, [dict(t) for t in tasks], save=False)
    assert [r.starid for r in got] == [int(t["starid"]) for t in tasks]
    for g, w in zip(got, want):
        assert (g.method, g.status.value, _switched(g)) == \
            (w.method, w.status.value, _switched(w)), g.starid
        if g.method == "linpsf":
            np.testing.assert_allclose(g.lightcurve["flux"], w.lightcurve["flux"], rtol=1e-4,
                                       err_msg=str(g.starid))
            assert g.details["completeness"] == pytest.approx(w.details["completeness"],
                                                              rel=1e-4)
    assert sum(r.method == "linpsf" for r in got) == 12     # test_deblend_switch's count

    # Both switch decisions on the aperture pass, target by target:
    settings = torch_settings.load_settings()
    ap_j = jax_dispatcher.extract_aperture_batch(jctx, [int(t["starid"]) for t in tasks])
    ap_t = dispatcher.extract_aperture_batch(tctx, [int(t["starid"]) for t in tasks])
    for g, w in zip(ap_t, ap_j):
        assert dispatcher._needs_halo_switch(g, 6.0, 0.01) == \
            jax_dispatcher._needs_halo_switch(w, 6.0, 0.01)
        assert dispatcher._needs_deblend_switch(g, settings) == (w.starid in {
            r.starid for r in want if "linpsf" in _switched(r)})


@pytest.mark.parametrize("rerun", ["halo", "halo_queue", "linpsf"])
@pytest.mark.parametrize("exc", [KernelError, RuntimeError])
def test_switch_failures(crowded, monkeypatch, rerun, exc):
    """What says the port or the card cannot do the work propagates out of
    either switch; any other failure keeps the aperture results."""
    sim, d, tasks, _, ctx = crowded
    tasks = [dict(t) for t in tasks[:8]]
    sid0 = int(tasks[0]["starid"])
    run_method = dispatcher._run_method

    def failing(ctx_, starids, method, **kw):
        if method == rerun.split("_")[0]:
            raise exc("injected failure")
        return run_method(ctx_, starids, method, **kw)

    monkeypatch.setattr(dispatcher, "_run_method", failing)
    if rerun.startswith("halo"):
        monkeypatch.setattr(dispatcher, "_needs_halo_switch",
                            lambda res, tmag_limit, flux_limit: res.starid == sid0)
    hq = dispatcher.HaloSwitchQueue(min_flush=1) if rerun == "halo_queue" else None

    def run():
        out = dispatcher.photometry_batch(ctx, tasks, save=False, halo_queue=hq)
        if hq is not None:
            assert out[0].details.get("halo_switch_deferred")
            flushed = hq.flush()
            assert [int(t["starid"]) for t, _ in flushed] == [sid0]
            out[0] = flushed[0][1]
        return out

    if exc is KernelError:
        with pytest.raises(KernelError, match="injected failure"):
            run()
        return
    out = run()
    switched = [r for r in out if r.method != "aperture"]
    if rerun == "linpsf":
        assert not switched
        assert sum(dispatcher._needs_deblend_switch(r, torch_settings.load_settings())
                   for r in out) >= 2
    else:
        assert out[0].method == "aperture" and not _switched(out[0])
        assert not out[0].details.get("halo_switch_deferred")


def _settings_with_min_batch(load, n):
    """A ``load_settings`` that answers [haloswitch] min_batch with ``n``."""
    base = load()

    class Settings:
        def getint(self, section, option, fallback=None):
            if (section, option) == ("haloswitch", "min_batch"):
                return n
            return base.getint(section, option, fallback=fallback)

        def __getattr__(self, name):
            return getattr(base, name)

    return lambda: Settings()


@pytest.fixture(scope="module")
def bright_sector(tmp_path_factory):
    """Two bright stars on the CCD's edges (the aperture pass cannot grow
    their stamps: "Stamp resize hit limit"), two fainter isolated stars and
    three split blends at 3.5-5.5 px (test_deblend_switch's geometry)."""
    d = str(tmp_path_factory.mktemp("torch_bright") / "sector")
    os.makedirs(d)
    stars = [(30.0, 1.0, 4.8), (96.0, 126.0, 5.3), (64.0, 20.0, 9.5), (20.0, 100.0, 9.8)]
    for i, sep in enumerate([3.5, 4.5, 5.5]):
        r, c = 60.0 + 14.0 * i, 55.0
        stars += [(r, c, 10.0), (r + sep * 0.7, c + sep * 0.714, 10.3)]
    sim = simulate_sector(SimConfig(shape=(128, 128), n_times=12, n_stars=len(stars),
                                    stars=tuple(stars), seed=23, jitter_amp=0.02,
                                    variable_fraction=0.0))
    sim.write_ffis(d)
    sim.write_catalog(d)
    assert prepare_cmd.main(["-q", d]) == 0
    assert todo_cmd.main(["-q", d]) == 0
    return sim, d


def _rows(d):
    with sqlite3.connect(os.path.join(d, "todo.sqlite")) as conn:
        todo = conn.execute("SELECT priority, status FROM todolist ORDER BY priority").fetchall()
        diag = conn.execute("SELECT priority, method_used, errors FROM diagnostics "
                            "ORDER BY priority").fetchall()
    return todo, diag


def _products(d):
    out = {}
    for path in glob.glob(os.path.join(d, "**", "*tasoc_lc.fits.gz"), recursive=True):
        hdus = pf.read_fits(path)
        lc = hdus[1].data
        out[os.path.basename(path)] = (np.asarray(lc["FLUX_RAW"]), np.asarray(lc["FLUX_RAW_ERR"]),
                                       [h.name for h in hdus])
    return out


def test_run_drain_default_method_matches_jax(bright_sector, tmp_path, monkeypatch):
    sim, d = bright_sector
    d_jax, d_torch = str(tmp_path / "jax"), str(tmp_path / "torch")
    for dst in (d_jax, d_torch):
        shutil.copytree(d, dst, ignore=shutil.ignore_patterns("*.fits.gz", "c1800"))
    t0 = float(sim.time[0]) + 2457000.0
    monkeypatch.setattr(jax_dispatcher, "default_time_corrector",
                        lambda: JaxTimeCorrector(JaxEphemeris.synthetic(t0 - 5, t0 + 10)))
    monkeypatch.setattr(dispatcher, "default_time_corrector",
                        lambda: TimeCorrector(SpacecraftEphemeris.synthetic(t0 - 5, t0 + 10)))
    monkeypatch.setattr(jax_dispatcher, "load_settings",
                        _settings_with_min_batch(jax_settings.load_settings, 2))
    monkeypatch.setattr(dispatcher, "load_settings",
                        _settings_with_min_batch(torch_settings.load_settings, 2))
    flushes = []
    flush = dispatcher.HaloSwitchQueue.flush

    def counting_flush(self, force=False):
        out = flush(self, force)
        flushes.append((force, len(out)))
        return out

    monkeypatch.setattr(dispatcher.HaloSwitchQueue, "flush", counting_flush)
    n_tasks = len(sim.starid)
    assert jax_run_drain(d_jax, 3, batch_size=5) == n_tasks
    timers = {"lease": 0.0, "context": 0.0, "photometry": 0.0, "save": 0.0, "sqlite": 0.0,
              "wall": 0.0, "n_done": 0, "n_batches": 0}
    assert run_drain(d_torch, 3, batch_size=5, device="cpu", timers=timers) == n_tasks
    assert flushes == [(False, 2)], flushes      # min_batch reached after lease 1
    assert timers["n_done"] == n_tasks

    todo, diag = _rows(d_torch)
    assert (todo, diag) == _rows(d_jax)
    methods = {prio: m for prio, m, _ in diag}
    assert sorted(methods.values()).count("halo") == 2
    assert sorted(methods.values()).count("linpsf") >= 4
    assert all(status == STATUS.OK.value or status == STATUS.WARNING.value
               for _, status in todo)

    want, got = _products(d_jax), _products(d_torch)
    assert sorted(got) == sorted(want) and len(want) == n_tasks
    method_of = {int(sid): methods[prio] for prio, sid in
                 sqlite3.connect(os.path.join(d_torch, "todo.sqlite")).execute(
                     "SELECT priority, starid FROM todolist")}
    tol = {"aperture": (RTOL, ATOL), "linpsf": (1e-4, 0.0), "halo": (5e-4, 0.0)}
    for name, (flux, ferr, hdus) in got.items():
        sid = int(name[4:15])                      # tess{starid:011d}-s...
        rtol, atol = tol[method_of[sid]]
        assert hdus == want[name][2], name
        assert ("WEIGHTMAP" in hdus) == (method_of[sid] == "halo")
        for a, b in zip((flux, ferr), want[name][:2]):
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, equal_nan=True, err_msg=name)


def test_photometry_single(bright_sector, tmp_path):
    """tests/test_dispatcher_single.py:25-60 on the port."""
    sim, d = bright_sector
    kw = dict(datasource="ffi", sector=1, camera=3, ccd=2, device="cpu")
    res = dispatcher.photometry_single(int(sim.starid[2]), d, output_folder=str(tmp_path),
                                       version=2, **kw)
    assert res.status in (STATUS.OK, STATUS.WARNING) and res.method == "aperture"
    assert os.path.exists(res.details["filepath_lightcurve"])
    ratio = np.nanmedian(res.lightcurve["flux"] / sim.flux_true[2])
    assert 0.7 < ratio < 1.2
    for method in ("psf", "linpsf", "halo"):
        res = dispatcher.photometry_single(int(sim.starid[3]), d, method=method, save=False,
                                           **kw)
        assert res.method == method and res.status in (STATUS.OK, STATUS.WARNING), method
    res = dispatcher.photometry_single(int(sim.starid[0]), d, method="bogus", save=False, **kw)
    assert res.status == STATUS.ERROR
    assert any("Invalid method" in e for e in res.details.get("errors", []))
    # The default method switches a bright edge star to halo on its own:
    res = dispatcher.photometry_single(int(sim.starid[0]), d, save=False, **kw)
    assert res.method == "halo" and SWITCHED["halo"] in res.details["errors"]


@pytest.mark.parametrize("method", ["linpsf", "halo"])
def test_cli_methods(bright_sector, tmp_path, method):
    sim, d = bright_sector
    work = str(tmp_path / "sector")
    shutil.copytree(d, work, ignore=shutil.ignore_patterns("*.fits.gz", "c1800"))
    sid = int(sim.starid[3])
    assert photometry_cmd.main(["-q", "--version", "1", "--method", method, "--starid",
                                str(sid), "--device", "cpu", work]) == 0
    with sqlite3.connect(os.path.join(work, "todo.sqlite")) as conn:
        rows = conn.execute("SELECT t.status, d.method_used FROM todolist t JOIN diagnostics d "
                            "ON t.priority = d.priority WHERE t.starid = ?", (sid,)).fetchall()
    assert rows == [(STATUS.OK.value, method)]
    assert glob.glob(os.path.join(work, "**", "*tasoc_lc.fits.gz"), recursive=True)
