"""The port's diagnostics: plots, the K2P2 debug images, ``--plot`` and movies, on the CPU.

- ``plots.plot_image`` (three scales), ``plot_image_fit_residuals`` and
  ``plot_outline`` against the committed tests/baselines/*.npz with
  tests/test_plot_regression.py's thumbnail and ``TOL`` (read only), and
  each port thumbnail against the JAX function's on the same input.
- ``build_masks_batch(..., debug=True)`` against the JAX package's
  ``build_mask(..., debug=True)`` stamp by stamp: ``above``, ``labels``,
  ``seg`` and ``mask`` equal, ``blurred`` to tests/test_torch_k2p2.py's
  blur tolerance; the production outputs unchanged by ``debug``.
- tests/test_diagnostics_plots.py on the port: ``--plot`` through the CLI
  (sumimage and the K2P2 5-panel), psf and linpsf (``psf_fit``), halo (the
  weight maps), ``photometry_single``, the ``HaloSwitchQueue`` flush and a
  deblend-switched blend, each writing the figures the JAX package writes
  (the switched blend one more: its ``psf_fit``).
- tests/test_movie_cli_prf_dir.py:22, 73, 91 and 114 on the port: per-CCD
  and combined movies, the MP4 gate, ``process_shard`` and the CLI's
  static split.
"""

import glob
import os
import shutil
import socket
import sys

import numpy as np
import pytest

import torch_parity  # noqa: F401  (one intra-op thread per test worker)
from torch_parity import n, t
from test_plot_regression import BASELINE_DIR, TOL, _demo_image, _thumbnail
from test_torch_k2p2 import K, _corpus

from photometry_tpu_torch import plots
from photometry_tpu_torch.core import dispatcher
from photometry_tpu_torch.core.status import STATUS


def _baseline(name):
    path = os.path.join(BASELINE_DIR, f"{name}.npz")
    assert os.path.exists(path), path
    return np.load(path)["thumbnail"]


def _draw(mod, what):
    """One baseline figure drawn by ``mod`` (the port's plots or the JAX package's)."""
    img = _demo_image()
    if what == "plot_image_fit_residuals":
        fig = mod.plt.figure(figsize=(9, 3))
        mod.plot_image_fit_residuals(fig, img, _demo_image(seed=5) * 0.95)
    else:
        fig, ax = mod.plt.subplots(figsize=(4, 4))
        if what == "plot_outline":
            mod.plot_image(img, ax=ax, scale="log")
            mod.plot_outline(img > 500, ax=ax, color="r")
        else:
            mod.plot_image(img, ax=ax, scale=what.rsplit("_", 1)[1], cbar="right")
    thumb = _thumbnail(fig)
    mod.plt.close(fig)
    return thumb


@pytest.mark.parametrize("what", ["plot_image_linear", "plot_image_log", "plot_image_sqrt",
                                  "plot_image_fit_residuals", "plot_outline"])
def test_thumbnails_match_baselines_and_jax(what):
    from photometry_tpu import plots as jax_plots
    got = _draw(plots, what)
    delta = float(np.abs(got - _baseline(what)).mean())
    assert delta < TOL, f"{what}: thumbnail deviation {delta:.2f} > {TOL}"
    assert float(np.abs(got - _draw(jax_plots, what)).mean()) < TOL


def test_plot_helpers(tmp_path):
    """tests/test_scheduler_merge_plots.py::test_plots on the port."""
    rng = np.random.default_rng(0)
    img = rng.normal(100, 5, (32, 32))
    img[10, 10] = np.nan
    fig = plots.plt.figure()
    ax = fig.add_subplot(111)
    for scale in ("log", "sqrt", "linear"):
        plots.plot_image(img, ax=ax, scale=scale, cbar="right")
    with pytest.raises(ValueError):
        plots.plot_image(img, ax=ax, scale="bogus")
    mask = np.zeros((32, 32), bool)
    mask[5:9, 5:9] = True
    assert len(plots.plot_outline(mask, ax=ax)) == 32
    plots.set_copyright(fig)
    p = plots.save_figure(str(tmp_path / "sub" / "fig"), fig=fig)
    assert p.endswith("fig.png") and os.path.exists(p)
    plots.plt.close(fig)
    plots.plots_interactive("NoSuchBackend")
    plots.plots_noninteractive()
    assert plots.matplotlib.get_backend().lower() == "agg"


# --- the K2P2 debug images ---------------------------------------------------------

@pytest.mark.parametrize("segmentation", [True, False], ids=["watershed", "dbscan-only"])
def test_k2p2_debug_matches_jax(segmentation):
    import functools

    import jax
    import jax.numpy as jnp
    from photometry_tpu.core.engine import DEFAULT_K2P2_PARAMS
    from photometry_tpu.models.k2p2 import build_mask
    from photometry_tpu_torch.models.k2p2 import K2P2Params, build_masks_batch
    params = DEFAULT_K2P2_PARAMS._replace(segmentation=segmentation)
    fn = jax.jit(functools.partial(build_mask, params=params, debug=True))
    imgs, cc, cr, ct, cv, tr, tc, tm = _corpus()
    sid = np.arange(1, K + 1, dtype=np.int64)
    tparams = K2P2Params(**params._asdict())
    for i in list(range(0, 64, 4)) + [64, 65, 66, 67]:        # and the hand-made cases
        want = fn(jnp.asarray(imgs[i]), jnp.asarray(cc[i]), jnp.asarray(cr[i]),
                  jnp.asarray(ct[i]), jnp.asarray(sid), jnp.asarray(cv[i]),
                  jnp.float32(tr[i]), jnp.float32(tc[i]), jnp.float32(tm[i]))
        args = [t(x[i:i + 1]) for x in (imgs, cc, cr, ct)] + [t(sid[None]), t(cv[i:i + 1])]
        args += [t(x[i:i + 1]) for x in (tr, tc, tm)]
        got = build_masks_batch(*args, params=tparams, debug=True)
        for key in ("above", "labels", "seg", "mask"):
            np.testing.assert_array_equal(n(got[key])[0], np.asarray(want[key]),
                                          err_msg=f"stamp {i} {key}")
        np.testing.assert_allclose(n(got["blurred"])[0], np.asarray(want["blurred"]),
                                   rtol=1e-5, atol=1e-3, err_msg=f"stamp {i} blurred")
        plain = build_masks_batch(*args, params=tparams)
        assert set(plain) < set(got)
        for key in plain:
            np.testing.assert_array_equal(n(plain[key]), n(got[key]), err_msg=key)


# --- --plot through the dispatcher, the drain and the CLI ----------------------------

@pytest.fixture(scope="module")
def sector(tmp_path_factory):
    """tests/test_diagnostics_plots.py's sector, prepared by the JAX package."""
    from photometry_tpu.cli import todo_cmd
    from photometry_tpu.prepare import prepare_photometry
    from photometry_tpu.sim.simulator import SimConfig, simulate_sector
    d = str(tmp_path_factory.mktemp("torch_diagplots") / "sector")
    os.makedirs(d)
    sim = simulate_sector(SimConfig(shape=(96, 96), n_times=10, n_stars=12, seed=71,
                                    tmag_range=(4.8, 12.5)))
    sim.write_ffis(d)
    sim.write_catalog(d)
    prepare_photometry(d)
    assert todo_cmd.main(["-q", d]) == 0
    return sim, d


def _task(sim, sid, method=None):
    return {"starid": int(sid), "datasource": "ffi", "sector": 1, "camera": 3, "ccd": 2,
            "cadence": 1800, "method": method, "priority": 1,
            "tmag": float(sim.tmag[sim.starid == sid][0])}


def _figures(base, sid):
    folder = os.path.join(base, "plots", f"{int(sid):011d}")
    return sorted(os.path.basename(p) for p in glob.glob(os.path.join(folder, "*.png")))


def _both(sim, d, tmp_path, sid, method):
    """photometry_batch with plot_folder on the port and on the JAX package:
    (the port's result, its figures, the JAX package's figures)."""
    from photometry_tpu.core import dispatcher as jax_dispatcher
    got_dir, want_dir = str(tmp_path / "torch"), str(tmp_path / "jax")
    task = _task(sim, sid, method)
    ctx = dispatcher.open_context(d, task, device="cpu")
    try:
        res = dispatcher.photometry_batch(ctx, [dict(task)], save=False, plot_folder=got_dir)[0]
    finally:
        ctx.close()
    jctx = jax_dispatcher.open_context(d, task)
    try:
        jax_dispatcher.photometry_batch(jctx, [dict(task)], save=False, plot_folder=want_dir)
    finally:
        jctx.close()
    return res, _figures(got_dir, sid), _figures(want_dir, sid)


def test_cli_plot_flag_aperture(sector, tmp_path):
    sim, d = sector
    from photometry_tpu_torch.cli import photometry_cmd
    work = str(tmp_path / "sector")
    shutil.copytree(d, work)
    sid = int(sim.starid[3])
    assert photometry_cmd.main(["-q", "--starid", str(sid), "--version", "5", "--plot",
                                "--device", "cpu", work]) == 0
    assert _figures(work, sid) == ["masks_flux.png", "sumimage.png"]
    assert not glob.glob(os.path.join(work, "plots", "*", "*weightmap*"))


@pytest.mark.parametrize("method", ["aperture", "psf", "linpsf", "halo"])
def test_method_figures_as_jax(sector, tmp_path, method):
    sim, d = sector
    sid = int(sim.starid[0] if method == "halo" else sim.starid[4])   # halo: Tmag ~4.8
    res, got, want = _both(sim, d, tmp_path, sid, method)
    assert res.status in (STATUS.OK, STATUS.WARNING) and res.method == method
    assert got == want and "sumimage.png" in got
    assert {"aperture": "masks_flux.png" in got, "psf": "psf_fit.png" in got,
            "linpsf": "psf_fit.png" in got,
            "halo": any(f.startswith(f"{sid}_weightmap_") for f in got)}[method]


def test_photometry_single_plots(sector, tmp_path):
    sim, d = sector
    sid = int(sim.starid[5])
    res = dispatcher.photometry_single(sid, d, method="linpsf", sector=1, camera=3, ccd=2,
                                       save=False, plot_folder=str(tmp_path), device="cpu")
    assert res.status in (STATUS.OK, STATUS.WARNING)
    assert _figures(str(tmp_path), sid) == ["psf_fit.png", "sumimage.png"]


def test_halo_queue_flush_plots(sector, tmp_path, monkeypatch):
    """A default-method bright star deferred to the queue is plotted at its
    flush (with the halo weight maps), not in its lease."""
    sim, d = sector
    sid = int(sim.starid[0])
    monkeypatch.setattr(dispatcher, "_needs_halo_switch",
                        lambda res, tmag_limit, flux_limit: res.starid == sid)
    task = _task(sim, sid)
    ctx = dispatcher.open_context(d, task, device="cpu")
    queue = dispatcher.HaloSwitchQueue(min_flush=1)
    base = str(tmp_path)
    try:
        out = dispatcher.photometry_batch(ctx, [task], save=False, plot_folder=base,
                                          halo_queue=queue)
        assert out[0].details.get("halo_switch_deferred")
        assert _figures(base, sid) == []
        (_, res), = queue.flush()
    finally:
        ctx.close()
    assert res.method == "halo"
    figs = _figures(base, sid)
    assert "sumimage.png" in figs and any(f.startswith(f"{sid}_weightmap_") for f in figs)


def test_run_drain_plot_and_deblend_switch(sector, tmp_path, monkeypatch):
    """run_drain(plot=True): every OK aperture task gets its two figures; a
    target the deblend switch sends to linPSF gets its fit figure too."""
    from photometry_tpu_torch.core.drain import run_drain
    sim, d = sector
    work = str(tmp_path / "sector")
    shutil.copytree(d, work)
    blend = int(sim.starid[6])
    monkeypatch.setattr(dispatcher, "_needs_deblend_switch",
                        lambda res, settings: res.starid == blend)
    assert run_drain(work, 1, plot=True, device="cpu") == len(sim.starid)
    import sqlite3
    with sqlite3.connect(os.path.join(work, "todo.sqlite")) as conn:
        rows = conn.execute("SELECT t.starid, t.status, d.method_used FROM todolist t "
                            "JOIN diagnostics d ON t.priority = d.priority").fetchall()
    methods = {sid: m for sid, status, m in rows
               if status in (STATUS.OK.value, STATUS.WARNING.value)}
    assert methods[blend] == "linpsf"
    for sid, m in methods.items():
        figs = _figures(work, sid)
        assert "sumimage.png" in figs, sid
        assert ("masks_flux.png" in figs) == (m == "aperture"), sid
        assert ("psf_fit.png" in figs) == (m == "linpsf"), sid


def test_plot_failures(sector, tmp_path, monkeypatch):
    from photometry_tpu_torch import diagnostics
    from photometry_tpu_torch.ops._kernels import KernelError
    sim, d = sector
    task = _task(sim, int(sim.starid[4]), "aperture")
    ctx = dispatcher.open_context(d, task, device="cpu")
    try:
        res = dispatcher.photometry_batch(ctx, [task], save=False)[0]
        for exc, raises in ((ValueError, False), (KernelError, True)):
            def broken(*a, **kw):
                raise exc("injected")
            monkeypatch.setattr(diagnostics, "k2p2_debug", broken)
            if raises:
                with pytest.raises(KernelError):
                    diagnostics.plot_target_diagnostics(res, ctx, str(tmp_path))
            else:
                written = diagnostics.plot_target_diagnostics(res, ctx, str(tmp_path))
                assert [os.path.basename(p) for p in written] == ["sumimage.png"]
        # Figures asked for without matplotlib: an error, not a quiet skip.
        import photometry_tpu_torch
        monkeypatch.setitem(sys.modules, "photometry_tpu_torch.plots", None)
        monkeypatch.delattr(photometry_tpu_torch, "plots")
        with pytest.raises(ImportError):
            diagnostics.plot_target_diagnostics(res, ctx, str(tmp_path))
    finally:
        ctx.close()


# --- movies ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def cube_dir(tmp_path_factory):
    """tests/test_movie_cli_prf_dir.py's prepared sector, by the JAX package."""
    from photometry_tpu.prepare import prepare_photometry
    from photometry_tpu.sim.simulator import SimConfig, simulate_sector
    d = str(tmp_path_factory.mktemp("torch_mcli"))
    sim = simulate_sector(SimConfig(shape=(64, 64), n_times=5, n_stars=8, seed=77))
    sim.write_ffis(d)
    sim.write_catalog(d)
    prepare_photometry(d)
    return d


def test_movie_cli(cube_dir, tmp_path):
    from photometry_tpu_torch.cli import movie_cmd
    assert movie_cmd.main(["-q", "--frames", "2", cube_dir]) == 0
    gifs = glob.glob(os.path.join(cube_dir, "*images.gif"))
    assert gifs and os.path.getsize(gifs[0]) > 1000
    assert movie_cmd.main(["-q", str(tmp_path)]) == 1              # no cubes


def test_combined_movie_cli(cube_dir):
    from photometry_tpu_torch.cli import movie_cmd
    from photometry_tpu_torch.movie import mosaic_frame
    assert movie_cmd.main(["-q", "--combined", "--frames", "2", cube_dir]) == 0
    gifs = glob.glob(os.path.join(cube_dir, "*combined_images.gif"))
    assert gifs and os.path.getsize(gifs[0]) > 1000
    m = mosaic_frame(cube_dir, 1, 0)
    assert m.shape == (256, 256)
    assert np.isfinite(m[128:192, 64:128]).all()              # camera 3, ccd 2 block
    assert np.isnan(m[:64, :64]).all()


def test_mp4_capability_gate(cube_dir, monkeypatch):
    from photometry_tpu_torch import movie
    from photometry_tpu_torch.io.discovery import find_cube_files
    cube = find_cube_files(cube_dir)[0]
    if shutil.which("ffmpeg"):
        out = movie.make_movie(cube, fmt="mp4", max_frames=2, fps=2)
        assert out.endswith(".mp4") and os.path.getsize(out) > 0
    else:
        assert not movie.ffmpeg_available()
        with pytest.raises(RuntimeError, match="ffmpeg"):
            movie.make_movie(cube, fmt="mp4", max_frames=2)
        with pytest.raises(RuntimeError, match="ffmpeg"):
            movie.make_combined_movie(cube_dir, 1, fmt="mp4", max_frames=2)
    out = movie.make_movie(cube, fmt="png", max_frames=2, dpi=40)
    assert sorted(os.listdir(out)) == ["0000.png", "0001.png"]
    monkeypatch.setattr(shutil, "which", lambda _: None)
    assert not movie.ffmpeg_available()


def test_movie_cli_process_shard(cube_dir, monkeypatch):
    from photometry_tpu_torch.cli import movie_cmd
    seen = []
    monkeypatch.setattr("photometry_tpu_torch.movie.make_movie",
                        lambda cube, **kw: seen.append(cube) or f"{cube}.gif")
    assert movie_cmd.main(["-q", "--process-id", "0", "--num-processes", "2", cube_dir]) == 0
    assert len(seen) == 1
    assert movie_cmd.main(["-q", "--process-id", "1", "--num-processes", "2", cube_dir]) == 0
    assert len(seen) == 1
    with pytest.raises(SystemExit):
        movie_cmd.main(["-q", "--process-id", "0", cube_dir])


def test_process_shard():
    """tests/test_multihost.py's shard rules, and the defaults of a
    torch.distributed group of one."""
    import torch.distributed as dist
    from photometry_tpu_torch.parallel import multihost
    items = list(range(10))
    shards = [multihost.process_shard(items, process_id=p, process_count=3) for p in range(3)]
    assert sorted(sum(shards, [])) == items and shards[0] == [0, 3, 6, 9]
    for pid, count in ((3, 3), (-1, 3), (0, 0)):
        with pytest.raises(ValueError):
            multihost.process_shard([1, 2, 3], process_id=pid, process_count=count)
    assert not multihost.is_initialized()
    assert multihost.process_shard(items) == items
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=0,
                            world_size=1)
    try:
        assert multihost.is_initialized()
        assert multihost.process_shard(items) == items
        assert multihost.process_shard(items, process_count=2) == items[0::2]
    finally:
        dist.destroy_process_group()
    assert not multihost.is_initialized()
