"""The port's task-pull scheduler on the CPU (``device="cpu"`` workers).

- ``run_distributed`` as tests/test_scheduler_merge_plots.py holds the JAX
  package's: spawned workers over pipes (:32-50), remote workers over TCP
  (:148-188), a worker crashing once and respawned with no duplicate
  diagnostics rows (:190-229), every worker dead giving ``drained=False``
  (:231-250).
- Parity: the port's ``run_distributed`` (2 workers, ``device="cpu"``) and
  the JAX package's (2 workers, ``platform="cpu"``), each on its own copy
  of one JAX-prepared sector where both automatic switches fire (the halo
  queue's ``min_batch`` set to 2 by a settings file the workers read):
  per task the same final status and method, the same products, fluxes
  within tests/test_torch_dispatch.py's drain tolerances.
- One lease step: on the same sector, one worker of ``run_distributed``
  and ``run_drain`` store the same todo rows (status, method, errors) and
  write the same light-curve files, byte for byte.
- A ``KernelError`` in a worker's photometry (a TCP worker started here
  through :func:`kernel_error_worker`) kills the worker: no ERROR rows, the
  lease back in the queue, ``drained`` False.
- a malformed ``mesh_spec`` / ``--mesh`` refused with ``ValueError``
  before any worker starts or any task is leased (the workers build a
  well-formed one themselves: tests/test_torch_mesh_production.py);
  ``scheduler_cmd``'s exit codes.

The workers are spawned processes; they run torch on one thread each.
"""

import glob
import json
import multiprocessing
import os
import shutil
import socket
import sqlite3

import numpy as np
import pytest

import torch_parity  # noqa: F401  (one intra-op thread per test worker)
from torch_parity import ATOL, RTOL

from photometry_tpu_torch.cli import scheduler_cmd
from photometry_tpu_torch.core.status import STATUS
from photometry_tpu_torch.parallel.scheduler import run_distributed, worker_remote

pytestmark = pytest.mark.mpi


def kernel_error_worker(address, folder):
    """A TCP worker whose photometry raises ``KernelError`` on every lease."""
    from photometry_tpu_torch.core import drain
    from photometry_tpu_torch.ops._kernels import KernelError

    def failing(*a, **kw):
        raise KernelError("injected kernel failure")

    from photometry_tpu_torch.parallel import scheduler
    drain.photometry_batch = failing     # what the workers' lease step calls
    scheduler.worker_remote(address, folder, version=1, device="cpu")


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


@pytest.fixture(scope="module")
def sector(tmp_path_factory):
    """tests/test_scheduler_merge_plots.py's prepared sector, by the JAX package."""
    from photometry_tpu.prepare import prepare_photometry
    from photometry_tpu.sim.simulator import SimConfig, simulate_sector
    from photometry_tpu.todolist import make_todo
    d = str(tmp_path_factory.mktemp("torch_sched") / "sector")
    os.makedirs(d)
    sim = simulate_sector(SimConfig(shape=(96, 96), n_times=8, n_stars=14, seed=71,
                                    tmag_range=(8.5, 12.5)))
    sim.write_ffis(d)
    sim.write_catalog(d)
    prepare_photometry(d)
    make_todo(d)
    return d


@pytest.fixture
def folder(sector, tmp_path):
    d = str(tmp_path / "sector")
    shutil.copytree(sector, d)
    return d


def _count(d, sql):
    with sqlite3.connect(os.path.join(d, "todo.sqlite")) as conn:
        return conn.execute(sql).fetchone()[0]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_pipes(folder):
    summary = run_distributed(folder, n_workers=2, version=3, batch_size=5, device="cpu")
    assert summary["drained"] is True and summary["respawns"] == 0
    assert summary["tasks_run"] >= summary["numtasks"] - summary["SKIPPED"] - 2
    assert summary["OK"] + summary["WARNING"] + summary["SKIPPED"] >= 0.9 * summary["numtasks"]
    assert _count(folder, "SELECT COUNT(*) FROM diagnostics") > 5
    assert _count(folder, "SELECT COUNT(*) FROM todolist WHERE status IS NULL") == 0
    assert len(glob.glob(os.path.join(folder, "c1800", "*", "*.fits.gz"))) > 5


def test_tcp(folder):
    port = _free_port()
    mp = multiprocessing.get_context("spawn")
    procs = [mp.Process(target=worker_remote, args=(("127.0.0.1", port), folder),
                        kwargs={"version": 4, "device": "cpu"}) for _ in range(2)]
    for p in procs:
        p.start()
    try:
        summary = run_distributed(folder, n_workers=2, version=4, batch_size=5, device="cpu",
                                  listen=("127.0.0.1", port))
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
    assert [p.exitcode for p in procs] == [0, 0]
    assert summary["drained"] is True
    assert summary["OK"] + summary["WARNING"] + summary["SKIPPED"] >= 0.9 * summary["numtasks"]
    assert _count(folder, "SELECT COUNT(*) FROM todolist WHERE status IS NULL") == 0


def test_crash_respawn(folder, tmp_path, monkeypatch):
    marker = str(tmp_path / "crash_once")
    monkeypatch.setenv("PHOTOMETRY_TPU_TEST_CRASH_ONCE", marker)
    summary = run_distributed(folder, n_workers=2, version=7, batch_size=5, device="cpu")
    assert os.path.exists(marker), "crash hook never fired"
    assert _count(folder, "SELECT COUNT(*) FROM todolist WHERE status IS NULL OR status=6") == 0
    assert _count(folder, "SELECT COUNT(*) FROM (SELECT priority FROM diagnostics "
                          "GROUP BY priority HAVING COUNT(*) > 1)") == 0
    assert (_count(folder, "SELECT COUNT(*) FROM diagnostics")
            >= _count(folder, "SELECT COUNT(*) FROM todolist WHERE status IN (1, 2, 3)"))
    assert summary["OK"] + summary["WARNING"] + summary["SKIPPED"] >= 0.9 * summary["numtasks"]
    assert summary["respawns"] >= 1 and summary["drained"] is True
    with open(os.path.join(folder, "summary.json")) as fh:
        assert json.load(fh)["respawns"] == summary["respawns"]


def test_all_workers_dead(folder, monkeypatch):
    monkeypatch.setenv("PHOTOMETRY_TPU_TEST_CRASH_ALWAYS", "1")
    summary = run_distributed(folder, n_workers=2, version=7, batch_size=5, device="cpu",
                              max_respawns=1)
    assert summary["drained"] is False and summary["tasks_run"] == 0
    assert summary["respawns"] == 1
    assert _count(folder, "SELECT COUNT(*) FROM todolist WHERE status IS NULL") > 0


def test_kernel_error_returns_the_lease(folder):
    """What says the card cannot do the work kills the worker; its lease
    goes back to the queue and no ERROR row is written."""
    port = _free_port()
    proc = multiprocessing.get_context("spawn").Process(
        target=kernel_error_worker, args=(("127.0.0.1", port), folder))
    proc.start()
    try:
        summary = run_distributed(folder, n_workers=1, version=1, batch_size=5, device="cpu",
                                  listen=("127.0.0.1", port))
    finally:
        proc.join(timeout=60)
        if proc.is_alive():
            proc.terminate()
    assert proc.exitcode not in (0, None)
    assert summary["drained"] is False and summary["tasks_run"] == 0
    assert _count(folder, "SELECT COUNT(*) FROM todolist WHERE status IS NOT NULL") == 0
    assert _count(folder, "SELECT COUNT(*) FROM diagnostics") == 0


def test_mesh_refused(folder):
    with pytest.raises(ValueError, match="mesh axis"):
        run_distributed(folder, n_workers=1, device="cpu", mesh_spec="rows=2")
    with pytest.raises(ValueError, match="positive integer"):
        scheduler_cmd.main(["-q", "--version", "1", "--device", "cpu", "--mesh", "time=0",
                            folder])
    with pytest.raises(ValueError, match="empty"):
        worker_remote(("127.0.0.1", 1), folder, device="cpu", mesh_spec=" ")
    assert _count(folder, "SELECT COUNT(*) FROM todolist WHERE status IS NOT NULL") == 0


def test_cli_exit_codes(folder, monkeypatch, capsys):
    assert scheduler_cmd.main(["-q", "--workers", "2", "--batch-size", "5", "--version", "2",
                               "--device", "cpu", folder]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["drained"] is True and summary["tasks_run"] > 0
    with sqlite3.connect(os.path.join(folder, "todo.sqlite")) as conn:
        conn.execute("UPDATE todolist SET status=NULL")
        conn.execute("DELETE FROM diagnostics")
    monkeypatch.setenv("PHOTOMETRY_TPU_TEST_CRASH_ALWAYS", "1")
    assert scheduler_cmd.main(["-q", "--workers", "1", "--version", "2", "--device", "cpu",
                               folder]) == 1
    capsys.readouterr()
    with pytest.raises(SystemExit):
        scheduler_cmd.main(["--help"])
    help_text = capsys.readouterr().out
    assert "27.9 GB" in help_text and "71.5 GB" in help_text and "--device" in help_text


# --- parity with the JAX package's scheduler ------------------------------------

def _rows(d):
    with sqlite3.connect(os.path.join(d, "todo.sqlite")) as conn:
        return conn.execute(
            "SELECT t.priority, t.starid, t.status, d.method_used FROM todolist t "
            "LEFT JOIN diagnostics d ON t.priority = d.priority ORDER BY t.priority").fetchall()


def _products(d):
    from photometry_tpu_torch.io import fits as pf
    out = {}
    for path in glob.glob(os.path.join(d, "**", "*tasoc_lc.fits.gz"), recursive=True):
        lc = pf.read_fits(path)[1].data
        out[os.path.basename(path)] = (np.asarray(lc["FLUX_RAW"]), np.asarray(lc["FLUX_RAW_ERR"]))
    return out


@pytest.fixture(scope="module")
def bright_prepared(tmp_path_factory):
    """tests/test_torch_dispatch.py's bright_sector, prepared by the JAX
    package: two bright stars on the CCD's edges (halo switch), two fainter
    isolated stars, three blends at 3.5-5.5 px (deblend switch); and a
    settings file that sets the halo queue's ``min_batch`` to 2."""
    from photometry_tpu.cli import prepare_cmd, todo_cmd
    from photometry_tpu.sim.simulator import SimConfig, simulate_sector
    from photometry_tpu_torch.io.settings import data_dir
    root = tmp_path_factory.mktemp("torch_sched_bright")
    d = str(root / "sector")
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
    with open(os.path.join(data_dir(), "settings.ini")) as fh:
        text = fh.read()
    assert "min_batch" not in text and "\n[haloswitch]\n" in text
    settings = str(root / "settings.ini")
    with open(settings, "w") as fh:
        fh.write(text.replace("\n[haloswitch]\n", "\n[haloswitch]\nmin_batch = 2\n"))
    return d, settings


@pytest.fixture
def bright(bright_prepared, monkeypatch):
    """The prepared bright sector, with its settings file in force here and
    in the workers spawned from here."""
    from photometry_tpu_torch.core import dispatcher
    from photometry_tpu_torch.io.settings import load_settings
    d, settings = bright_prepared
    monkeypatch.setenv("PHOTOMETRY_TPU_SETTINGS", settings)
    load_settings.cache_clear()
    dispatcher.default_time_corrector.cache_clear()
    yield d
    load_settings.cache_clear()
    dispatcher.default_time_corrector.cache_clear()


def test_parity_with_jax_scheduler(bright, tmp_path):
    from photometry_tpu.parallel.scheduler import run_distributed as jax_run_distributed
    d_jax, d_torch = str(tmp_path / "jax"), str(tmp_path / "torch")
    for dst in (d_jax, d_torch):
        shutil.copytree(bright, dst)
    want = jax_run_distributed(d_jax, n_workers=2, version=3, batch_size=5, platform="cpu")
    got = run_distributed(d_torch, n_workers=2, version=3, batch_size=5, device="cpu")
    assert got["drained"] is True and want["drained"] is True
    assert {k: got[k] for k in ("numtasks", "tasks_run", "OK", "WARNING", "ERROR", "SKIPPED")} \
        == {k: want[k] for k in ("numtasks", "tasks_run", "OK", "WARNING", "ERROR", "SKIPPED")}

    rows = _rows(d_torch)
    assert rows == _rows(d_jax)
    methods = {sid: m for _, sid, _, m in rows}
    assert sorted(methods.values()).count("halo") == 2
    assert sorted(methods.values()).count("linpsf") >= 4
    assert all(status in (STATUS.OK.value, STATUS.WARNING.value) for _, _, status, _ in rows)

    p_got, p_want = _products(d_torch), _products(d_jax)
    assert sorted(p_got) == sorted(p_want) and len(p_got) == len(rows)
    tol = {"aperture": (RTOL, ATOL), "linpsf": (1e-4, 0.0), "halo": (5e-4, 0.0)}
    for name, arrays in p_got.items():
        rtol, atol = tol[methods[int(name[4:15])]]
        for a, b in zip(arrays, p_want[name]):
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, equal_nan=True, err_msg=name)


def _errors(d):
    with sqlite3.connect(os.path.join(d, "todo.sqlite")) as conn:
        return conn.execute("SELECT priority, errors FROM diagnostics ORDER BY priority").fetchall()


def _product_bytes(d):
    out = {}
    for path in glob.glob(os.path.join(d, "**", "*tasoc_lc.fits.gz"), recursive=True):
        with open(path, "rb") as fh:
            out[os.path.relpath(path, d)] = fh.read()
    return out


def test_scheduler_rows_and_products_equal_run_drain(bright, tmp_path):
    """One worker of ``run_distributed`` and ``run_drain``, in batches of 5
    on copies of the bright sector, run the same lease step: both switches
    fire, the halo queue flushes mid-drain once its two candidates wait, and
    the todo lists (status, method, errors) and the light-curve files, byte
    for byte, come out the same."""
    from photometry_tpu_torch.core.drain import run_drain
    d_drain, d_sched = str(tmp_path / "drain"), str(tmp_path / "sched")
    for dst in (d_drain, d_sched):
        shutil.copytree(bright, dst)
    n_done = run_drain(d_drain, 3, batch_size=5, device="cpu")
    summary = run_distributed(d_sched, n_workers=1, version=3, batch_size=5, device="cpu")
    assert summary["drained"] is True and summary["tasks_run"] == n_done > 0

    rows = _rows(d_drain)
    assert rows == _rows(d_sched)
    assert _errors(d_drain) == _errors(d_sched)
    methods = [m for _, _, _, m in rows]
    assert methods.count("halo") == 2 and methods.count("linpsf") >= 4

    products = _product_bytes(d_drain)
    assert len(products) == len(rows)
    assert products == _product_bytes(d_sched)
