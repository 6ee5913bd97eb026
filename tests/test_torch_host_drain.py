"""Draining a sector from host-resident cubes (``cache="host"``) on the CPU.

- ``run_drain(cache="host")`` on a small simulated sector (the halo and
  linPSF switches fire) stores the same todo rows and writes the same
  light-curve files, byte for byte, as ``run_drain(cache="device")``; its
  aperture products agree with float64 re-sums of the cube over their
  APERTURE masks.  Only the host drain reports the streamed extraction and
  the host-gathered stamps (``aperture.stream``, ``stamps.host`` and their
  counters).
- ``run_drain`` and ``worker_loop`` hand ``cache`` to every FFI context
  they open (``ContextCache`` -> ``open_context``); an unknown value is
  refused before any task is leased.
- ``photometry_cmd --cache host`` and ``scheduler_cmd --cache host``
  reach the drain.
- One streamed extraction counts one ``stream_passes`` and T x H x W x 13
  bytes (three float32 planes and the uint8 flags) in ``stream_bytes``.
"""

import glob
import os
import shutil
import sqlite3

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one intra-op thread per test worker)

from photometry_tpu_torch.cli import photometry_cmd, prepare_cmd, scheduler_cmd, todo_cmd
from photometry_tpu_torch.core import dispatcher, engine
from photometry_tpu_torch.core.drain import new_timers, run_drain
from photometry_tpu_torch.io import fits as pf
from photometry_tpu_torch.parallel import scheduler
from photometry_tpu_torch.sim.simulator import SimConfig, simulate_sector
from photometry_tpu_torch.taskmanager import TaskManager
from photometry_tpu_torch.utils.profiling import StageTimer

STREAM_KEYS = ("aperture.stream", "stream_passes", "stream_bytes")
STAMP_KEYS = ("stamps.host", "host_stamp_bytes")


@pytest.fixture(scope="module")
def sector(tmp_path_factory):
    """Two bright stars on the CCD's edges (the halo switch), two split
    blends (the deblend switch) and two isolated stars, made by the port's
    prepare and todo CLIs."""
    d = str(tmp_path_factory.mktemp("torch_host_drain") / "sector")
    os.makedirs(d)
    stars = [(30.0, 1.0, 4.8), (96.0, 126.0, 5.3), (64.0, 20.0, 9.5), (20.0, 100.0, 9.8)]
    for i, sep in enumerate([3.5, 4.5]):
        r, c = 60.0 + 14.0 * i, 55.0
        stars += [(r, c, 10.0), (r + sep * 0.7, c + sep * 0.714, 10.3)]
    sim = simulate_sector(SimConfig(shape=(128, 128), n_times=12, n_stars=len(stars),
                                    stars=tuple(stars), seed=29, jitter_amp=0.02,
                                    variable_fraction=0.0))
    sim.write_ffis(d)
    sim.write_catalog(d)
    assert prepare_cmd.main(["-q", "--device", "cpu", d]) == 0
    assert todo_cmd.main(["-q", d]) == 0
    return d


@pytest.fixture
def copy(sector, tmp_path):
    """A fresh copy of the sector, its todo list untouched."""
    def make(name):
        dst = str(tmp_path / name)
        shutil.copytree(sector, dst)
        return dst
    return make


@pytest.fixture
def opened(monkeypatch):
    """The ``cache`` of every FFI context ``open_context`` opens."""
    caches, real = [], dispatcher.open_context

    def recorded(input_folder, task, cache="device", **kw):
        if task["datasource"] == "ffi":
            caches.append(cache)
        return real(input_folder, task, cache=cache, **kw)
    monkeypatch.setattr(dispatcher, "open_context", recorded)
    return caches


def _rows(d):
    with sqlite3.connect(os.path.join(d, "todo.sqlite")) as conn:
        return conn.execute(
            "SELECT t.priority, t.starid, t.status, d.method_used, d.errors FROM todolist t "
            "LEFT JOIN diagnostics d ON t.priority = d.priority ORDER BY t.priority").fetchall()


def _products(d):
    out = {}
    for path in glob.glob(os.path.join(d, "**", "*tasoc_lc.fits.gz"), recursive=True):
        with open(path, "rb") as fh:
            out[os.path.relpath(path, d)] = fh.read()
    return out


def _resum_gap(ctx, path):
    """The largest |FLUX_RAW - float64 sum over the APERTURE mask| of a
    product, over the median |sum|."""
    hdus = pf.read_fits(path)
    lc, ap = hdus[1].data, hdus[3]
    c0 = int(round(ctx.wcs.crpix[0] - ap.header["CRPIX1"]))
    r0 = int(round(ctx.wcs.crpix[1] - ap.header["CRPIX2"]))
    mask = (np.asarray(ap.data) & 2) != 0
    h, w = mask.shape
    idx = np.searchsorted(ctx.cadenceno, np.asarray(lc["CADENCENO"]))
    img = ctx.images[idx, r0:r0 + h, c0:c0 + w].double().numpy()
    want = np.where(mask[None] & np.isfinite(img), img, 0.0).sum(axis=(1, 2))
    got = np.asarray(lc["FLUX_RAW"], np.float64)
    return float(np.max(np.abs(got - want)) / np.median(np.abs(want)))


def test_host_drain_writes_what_the_device_drain_writes(copy, opened):
    d_dev, d_host = copy("device"), copy("host")
    t_dev, t_host = new_timers(), new_timers()
    n_dev = run_drain(d_dev, 1, batch_size=5, device="cpu", timers=t_dev)
    n_host = run_drain(d_host, 1, batch_size=5, device="cpu", timers=t_host, cache="host")
    assert n_host == n_dev > 0
    assert opened and set(opened[:1]) == {"device"} and set(opened[1:]) == {"host"}
    rows = _rows(d_host)
    assert rows == _rows(d_dev)
    methods = [r[3] for r in rows]
    assert methods.count("halo") == 2 and methods.count("linpsf") >= 2
    got = _products(d_host)
    assert len(got) == len(rows) and got == _products(d_dev)

    assert not any(t_dev[k] for k in STREAM_KEYS + STAMP_KEYS)
    assert all(t_host[k] > 0 for k in STREAM_KEYS + STAMP_KEYS), t_host
    assert t_host["stream_staged_bytes"] == 0          # no staging buffers off a card
    assert t_host["aperture.stream"] <= t_host["aperture"]
    assert t_host["stamps.host"] <= t_host["linpsf"]

    task = next(r for r in rows if r[3] == "aperture")
    ctx = dispatcher.open_context(d_host, {"datasource": "ffi", "sector": 1, "camera": 3,
                                           "ccd": 2, "starid": task[1]},
                                  cache="host", device="cpu")
    try:
        with sqlite3.connect(os.path.join(d_host, "todo.sqlite")) as conn:
            paths = [p for (p,) in conn.execute(
                "SELECT lightcurve FROM diagnostics WHERE method_used='aperture'")]
        assert paths
        for p in paths:
            path = p if os.path.isabs(p) else os.path.join(d_host, p)
            assert _resum_gap(ctx, path) < 1e-5, p
    finally:
        ctx.close()


def test_worker_loop_opens_host_contexts(sector, copy, opened):
    """A worker's lease step opens its contexts with the worker's ``cache``."""
    d = copy("worker")
    with TaskManager(d) as tm:
        batch = tm.get_task_batch(batch_size=4, datasource="ffi")
        tm.start_tasks([t["priority"] for t in batch])

    class Conn:
        def __init__(self):
            self.inbox = [(scheduler.START, batch), (scheduler.EXIT, None)]
            self.sent = []

        def send(self, msg):
            self.sent.append(msg)

        def recv(self):
            return self.inbox.pop(0) if self.inbox else (scheduler.EXIT, None)

        def close(self):
            pass
    conn = Conn()
    scheduler.worker_loop(conn, d, d, 1, device="cpu", cache="host")
    tags = [tag for tag, _ in conn.sent]
    assert tags[0] == scheduler.READY and tags[-1] == scheduler.BYE
    rows = [r for tag, payload in conn.sent if tag == scheduler.DONE for r in payload]
    assert len(rows) == len(batch) and opened and set(opened) == {"host"}


@pytest.mark.parametrize("where", ["run_drain", "ContextCache", "run_distributed"])
def test_an_unknown_cache_is_refused_before_any_lease(copy, where):
    d = copy("refused")
    with pytest.raises(ValueError, match="cache='disk'"):
        if where == "run_drain":
            run_drain(d, 1, device="cpu", cache="disk")
        elif where == "ContextCache":
            dispatcher.ContextCache(device="cpu", cache="disk")
        else:
            scheduler.run_distributed(d, n_workers=1, device="cpu", cache="disk")
    with sqlite3.connect(os.path.join(d, "todo.sqlite")) as conn:
        assert conn.execute("SELECT COUNT(*) FROM todolist WHERE status IS NOT NULL"
                            ).fetchone() == (0,)


def test_photometry_cmd_cache_host_reaches_the_drain(copy, opened):
    d = copy("cli")
    assert photometry_cmd.main(["-q", "--version", "1", "--all", "--batch-size", "5",
                                "--cache", "host", "--device", "cpu", d]) == 0
    assert opened and set(opened) == {"host"}
    assert all(r[2] is not None for r in _rows(d))


@pytest.mark.mpi
def test_scheduler_cmd_cache_host_reaches_the_workers(copy, monkeypatch, capsys):
    """``--cache host`` goes to ``run_distributed`` and on to its spawned
    worker, whose rows are those of the device drain."""
    d_sched, d_drain = copy("sched"), copy("drain")
    handed, real = [], scheduler.run_distributed

    def recorded(*a, **kw):
        handed.append(kw.get("cache"))
        return real(*a, **kw)
    monkeypatch.setattr(scheduler, "run_distributed", recorded)
    assert scheduler_cmd.main(["-q", "--workers", "1", "--batch-size", "5", "--version", "1",
                               "--cache", "host", "--device", "cpu", d_sched]) == 0
    assert handed == ["host"]
    run_drain(d_drain, 1, batch_size=5, device="cpu")
    strip = lambda rows: [r[:4] for r in rows]  # noqa: E731
    assert strip(_rows(d_sched)) == strip(_rows(d_drain))
    capsys.readouterr()
    with pytest.raises(SystemExit):
        scheduler_cmd.main(["--help"])
    assert "--cache {device,host}" in capsys.readouterr().out


def test_one_streamed_pass_counts_the_cube_bytes(copy):
    d = copy("stream")
    ctx = engine.SectorContext(d, 1, 3, 2, cache="host", device="cpu")
    try:
        T, (H, W) = ctx.n_times, ctx.shape
        masks = torch.zeros(3, 9, 7, dtype=torch.bool)
        masks[:, 2:7, 1:6] = True
        r0s = torch.tensor([10, 50, 100], dtype=torch.int32)
        c0s = torch.tensor([20, 60, 90], dtype=torch.int32)
        timers = new_timers()
        with StageTimer(timers).recording():
            out = engine._extract_flux_streamed(ctx, masks, r0s, c0s, 9, 7, chunk=5,
                                                windows=masks)
        assert timers["stream_passes"] == 1
        assert timers["stream_bytes"] == T * H * W * 13
        assert timers["stream_staged_bytes"] == 0 and timers["aperture.stream"] > 0
        want = engine.extract_flux_core(ctx.images, ctx.images_err, ctx.backgrounds,
                                        ctx.pixelflags, masks, r0s, c0s, 9, 7, windows=masks)
        for a, b in zip(out, want):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-5, equal_nan=True)
    finally:
        ctx.close()
