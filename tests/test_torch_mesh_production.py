"""The port's multi-card production path on the CPU: the dispatcher, the
drain, both CLIs and every method on a mesh context, case for case with
tests/test_mesh_production.py.

The mesh is ``make_mesh(4, 2, ["cpu"] * 8)`` (``--mesh time=4,targets=2
--device cpu`` on the command line), over a JAX-prepared 96x96 sector at
T = 10, which the time axis does not divide (padded to 12).

- ``parse_mesh_spec`` and ``mesh_axes``: forms and errors.
- ``photometry_batch`` on a mesh context against the port's single-device
  context: statuses, methods, flux, flux_err, flux_background and
  pos_centroid **bit for bit** (the JAX package's bar,
  tests/test_mesh_production.py:60-101); against the JAX package's mesh
  context (8 virtual devices) on the same sector: statuses equal, the
  extraction to rtol 1e-4 / atol 1e-3 (tests/test_bandext.py:41);
  ``context_from_jax`` of that JAX context is a port mesh context with the
  same padding, ``n_times`` and cubes.
- ``extract_psf_batch``, ``extract_linpsf_batch`` and
  ``extract_halo_batch`` on the mesh context: bit for bit the single-device
  context's, and the JAX mesh context's at tests/test_torch_psf.py's,
  tests/test_torch_linpsf.py's and tests/test_torch_halo.py's bounds.
- ``photometry_cmd --mesh time=4,targets=2`` and ``scheduler_cmd --mesh
  time=2`` drain copies of the sector: every task done, the products carry
  the true T, and every task's status, method and FLUX_RAW equal a drain
  without a mesh bit for bit.
"""

import glob
import os
import shutil
import sqlite3

import numpy as np
import pytest
import torch

from torch_parity import assert_extraction_parity

from photometry_tpu.sim.simulator import SimConfig, simulate_sector

from photometry_tpu_torch.core.dispatcher import open_context, photometry_batch
from photometry_tpu_torch.parallel.mesh import (CPU_DEVICES, TARGET_AXIS, TIME_AXIS, ShardedCube,
                                                make_mesh, mesh_axes, parse_mesh_spec)

SIGMA = 1.1
KEYS = ("flux", "flux_err", "flux_background", "pos_centroid")


@pytest.fixture(scope="module")
def prepared_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_mesh_e2e"))
    sim = simulate_sector(SimConfig(shape=(96, 96), n_times=10, n_stars=18, seed=77,
                                    tmag_range=(8.0, 13.0), psf_sigma=SIGMA))
    sim.write_ffis(d)
    sim.write_catalog(d)
    from photometry_tpu.cli import prepare_cmd, todo_cmd
    assert prepare_cmd.main(["-q", d]) == 0
    assert todo_cmd.main(["-q", d]) == 0
    return sim, d


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(n_time=4, n_targets=2, devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def contexts(prepared_dir, mesh):
    """The port's single-device and mesh contexts of the sector."""
    sim, d = prepared_dir
    task = _ffi_tasks(d)[0]
    one = open_context(d, task, device="cpu")
    on_mesh = open_context(d, task, device="cpu", mesh=mesh)
    yield one, on_mesh
    one.close()
    on_mesh.close()


def _ffi_tasks(d):
    with sqlite3.connect(os.path.join(d, "todo.sqlite")) as conn:
        conn.row_factory = sqlite3.Row
        rows = conn.execute(
            "SELECT priority, starid, sector, camera, ccd, cadence, "
            "datasource, method, tmag FROM todolist "
            "WHERE datasource='ffi' ORDER BY priority;").fetchall()
    return [dict(r) for r in rows]


def _same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and np.array_equal(a.view(np.uint8), b.view(np.uint8))


def test_parse_mesh_spec():
    m = parse_mesh_spec("time=4,targets=2", device="cpu")
    assert m.shape[TIME_AXIS] == 4 and m.shape[TARGET_AXIS] == 2
    m = parse_mesh_spec("time=2", device="cpu")
    assert m.shape[TIME_AXIS] == 2 and m.shape[TARGET_AXIS] == 1
    assert parse_mesh_spec("3", device="cpu").shape == {TIME_AXIS: 3, TARGET_AXIS: 1}
    assert parse_mesh_spec("targets=2", device="cpu").shape == {TIME_AXIS: 1, TARGET_AXIS: 2}
    assert parse_mesh_spec("auto", device="cpu").size == CPU_DEVICES
    for bad in ("rows=4", "time=999", "time=0", "time=x", ""):
        with pytest.raises(ValueError):
            parse_mesh_spec(bad, device="cpu")
    assert mesh_axes("time=4, targets=2") == (4, 2) and mesh_axes("auto") is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            parse_mesh_spec("time=2")                 # the default is the card, never the CPU


def test_mesh_batch_bitwise_vs_single_device(prepared_dir, contexts, mesh):
    """photometry_batch on a (4 time x 2 targets) mesh context == the
    single-device context bit for bit, at a T (10) the mesh does not divide."""
    sim, d = prepared_dir
    one, ctx = contexts
    tasks = _ffi_tasks(d)
    assert len(tasks) >= 8
    assert ctx.mesh is mesh
    assert isinstance(ctx.images, ShardedCube)
    assert ctx.images.shape[0] == 12 and ctx.n_times == 10
    assert len(ctx.images.shards) == 4 and ctx.pixelflags.dtype == torch.uint8
    assert torch.equal(ctx.images.full(), one.images)
    assert torch.isnan(ctx.images.shards[3][1:]).all() and not ctx.pixelflags.shards[3][1:].any()

    res1 = photometry_batch(one, tasks, save=False)
    res2 = photometry_batch(ctx, tasks, save=False)
    assert [r.status for r in res1] == [r.status for r in res2]
    n_checked = 0
    for r1, r2 in zip(res1, res2):
        assert r1.starid == r2.starid and r1.method == r2.method
        if not r1.lightcurve:
            continue
        for key in KEYS:
            assert r2.lightcurve[key].shape[0] == 10
            assert _same_bits(r1.lightcurve[key], r2.lightcurve[key]), (r1.starid, key)
        np.testing.assert_array_equal(r1.mask, r2.mask)
        n_checked += 1
    assert n_checked >= 6


def test_mesh_matches_jax_mesh(prepared_dir, contexts):
    """The port's mesh context against the JAX package's on the same sector
    (8 virtual devices): statuses equal, the extraction within tolerance;
    context_from_jax of the JAX mesh context is the port's mesh context."""
    from photometry_tpu.core.dispatcher import open_context as jax_open_context
    from photometry_tpu.core.dispatcher import photometry_batch as jax_photometry_batch
    from photometry_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from photometry_tpu_torch.core.engine import context_from_jax
    sim, d = prepared_dir
    _, ctx = contexts
    tasks = _ffi_tasks(d)
    jctx = jax_open_context(d, tasks[0], mesh=jax_make_mesh(n_time=4, n_targets=2))
    try:
        carried = context_from_jax(jctx, "cpu")
        assert carried.mesh.shape == ctx.mesh.shape and carried.n_times == 10
        for name in ("images", "images_err", "backgrounds", "pixelflags"):
            a, b = getattr(carried, name), getattr(ctx, name)
            assert a.shape == b.shape == (12, 96, 96)
            assert all(_same_bits(x.numpy(), y.numpy()) for x, y in zip(a.shards, b.shards))
        want = jax_photometry_batch(jctx, tasks, save=False)
    finally:
        jctx.close()
    got = photometry_batch(ctx, tasks, save=False)
    assert [r.status.value for r in got] == [r.status.value for r in want]
    n_ok = 0
    for g, w in zip(got, want):
        assert g.method == w.method
        if not w.lightcurve or w.method != "aperture":
            continue
        np.testing.assert_array_equal(g.mask, w.mask)
        assert_extraction_parity([g.lightcurve[k] for k in KEYS + ("shenanigans_any",)],
                                 [w.lightcurve[k] for k in KEYS + ("shenanigans_any",)])
        n_ok += 1
    assert n_ok >= 6


def _run_model(method, sim, ctx, jctx=None):
    from photometry_tpu.models.prf import PRF as JaxPRF
    from photometry_tpu_torch.models import halo, linpsf, psf_fit
    from photometry_tpu_torch.models.prf import prf_from_jax
    order = np.argsort(sim.tmag)
    if method == "halo":
        sids = [int(s) for s in sim.starid[order[:3]]]
        if jctx is not None:
            from photometry_tpu.models import halo as jax_halo
            return jax_halo.extract_halo_batch(jctx, sids)
        return halo.extract_halo_batch(ctx, sids)
    sids = [int(s) for s in sim.starid[order[:8]]]
    jp = JaxPRF.gaussian(sigma=SIGMA)
    fn = "extract_psf_batch" if method == "psf" else "extract_linpsf_batch"
    if jctx is not None:
        from photometry_tpu.models import linpsf as jax_linpsf
        from photometry_tpu.models import psf_fit as jax_psf_fit
        return getattr(jax_psf_fit if method == "psf" else jax_linpsf, fn)(jctx, sids, prf=jp)
    return getattr(psf_fit if method == "psf" else linpsf, fn)(ctx, sids,
                                                               prf=prf_from_jax(jp, "cpu"))


@pytest.mark.parametrize("method", ["psf", "linpsf", "halo"])
def test_models_on_mesh_context(prepared_dir, contexts, method):
    """Each method's stamps are gathered shard by shard and cut to the true
    T: bit for bit the single-device context's results; the JAX mesh
    context's at each method's own parity bounds (as
    tests/test_torch_host_cache.py applies them)."""
    from photometry_tpu.core.dispatcher import open_context as jax_open_context
    from photometry_tpu.parallel.mesh import make_mesh as jax_make_mesh
    sim, d = prepared_dir
    one, ctx = contexts
    got = _run_model(method, sim, ctx)
    single = _run_model(method, sim, one)
    n_lc = 0
    for g, s in zip(got, single):
        assert g.status == s.status and g.method == s.method == method
        for k in ("flux", "flux_err"):
            if s.lightcurve.get(k) is not None:
                assert g.lightcurve[k].shape == (10,)
                assert _same_bits(g.lightcurve[k], s.lightcurve[k]), (g.starid, k)
        n_lc += bool(s.lightcurve)
    assert n_lc >= 2
    jctx = jax_open_context(d, _ffi_tasks(d)[0], mesh=jax_make_mesh(n_time=4, n_targets=2))
    try:
        want = _run_model(method, sim, None, jctx)
    finally:
        jctx.close()
    for g, w in zip(got, want):
        assert g.status.value == w.status.value, g.starid
        if not w.lightcurve:
            continue
        scale = 1e-4 * np.nanmedian(np.abs(w.lightcurve["flux"]))
        for k in ("flux", "flux_err"):
            rtol, atol = {"psf": (1e-4, scale), "linpsf": (1e-4, 0.0),
                          "halo": (5e-4, 0.0)}[method]
            np.testing.assert_allclose(g.lightcurve[k], w.lightcurve[k], rtol=rtol, atol=atol,
                                       equal_nan=True, err_msg=f"{g.starid} {k}")


def _copy(prepared_dir, tmp_path, name):
    _, d = prepared_dir
    dst = str(tmp_path / name)
    shutil.copytree(d, dst, ignore=shutil.ignore_patterns("c1800", "summary.json"))
    with sqlite3.connect(os.path.join(dst, "todo.sqlite")) as conn:
        conn.execute("UPDATE todolist SET status=NULL")
        for table in ("diagnostics", "photometry_skipped"):
            if conn.execute("SELECT name FROM sqlite_master WHERE name=?", (table,)).fetchone():
                conn.execute(f"DELETE FROM {table}")
    return dst


def _drained(folder):
    """{priority: (status, method, FLUX_RAW or None)} of a drained folder."""
    from photometry_tpu_torch.io import fits as pf
    with sqlite3.connect(os.path.join(folder, "todo.sqlite")) as conn:
        rows = conn.execute(
            "SELECT t.priority, t.status, d.method_used, d.lightcurve FROM todolist t "
            "LEFT JOIN diagnostics d ON t.priority = d.priority").fetchall()
    out = {}
    for p, status, method, path in rows:
        assert status is not None, f"{folder}: priority {p} not processed"
        flux = None
        if path:
            lc = pf.read_fits(os.path.join(folder, path))[1].data
            assert len(lc["TIME"]) == 10                    # the true T, not the padded 12
            flux = np.asarray(lc["FLUX_RAW"])
        out[p] = (status, method, flux)
    return out


def _assert_drains_equal(got, want):
    assert set(got) == set(want)
    n_lc = 0
    for p in want:
        assert got[p][:2] == want[p][:2], p
        if want[p][2] is not None:
            assert _same_bits(got[p][2], want[p][2]), p
            n_lc += 1
    assert n_lc >= 8


@pytest.fixture(scope="module")
def plain_drain(prepared_dir, tmp_path_factory):
    """The sector drained by the CLI without a mesh (the reference drain)."""
    from photometry_tpu_torch.cli import photometry_cmd
    dst = _copy(prepared_dir, tmp_path_factory.mktemp("plain"), "d")
    assert photometry_cmd.main(["-q", "--all", "--version", "5", "--device", "cpu", dst]) == 0
    return _drained(dst)


def test_mesh_cli_end_to_end(prepared_dir, tmp_path, plain_drain, monkeypatch):
    """photometry_cmd --mesh time=4,targets=2 drains the queue (leases,
    sharded extraction, the switches, FITS products): the same statuses,
    methods and FLUX_RAW bits as the drain without a mesh."""
    from photometry_tpu_torch.cli import photometry_cmd
    from photometry_tpu_torch.parallel import sharded
    calls = []
    real = sharded._run_blocks
    monkeypatch.setattr(sharded, "_run_blocks",
                        lambda *a, **kw: calls.append(a[5]) or real(*a, **kw))
    d = _copy(prepared_dir, tmp_path, "mesh")
    assert photometry_cmd.main(["-q", "--all", "--version", "5", "--mesh", "time=4,targets=2",
                                "--device", "cpu", d]) == 0
    assert calls and set(calls) == {2}           # (time shard, target shard) blocks
    got = _drained(d)
    assert len(glob.glob(os.path.join(d, "c1800", "*", "*.fits.gz"))) >= 8
    assert sum(np.isfinite(f).sum() >= 5 for _, _, f in got.values() if f is not None) >= 8
    _assert_drains_equal(got, plain_drain)


def test_scheduler_cmd_mesh(prepared_dir, tmp_path, plain_drain):
    """scheduler_cmd --mesh time=2: the spawned worker builds its mesh and
    drains the queue with the drain's results."""
    from photometry_tpu_torch.cli import scheduler_cmd
    d = _copy(prepared_dir, tmp_path, "sched")
    assert scheduler_cmd.main(["-q", "--workers", "1", "--version", "5", "--mesh", "time=2",
                               "--device", "cpu", d]) == 0
    _assert_drains_equal(_drained(d), plain_drain)
