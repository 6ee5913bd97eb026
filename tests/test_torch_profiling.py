"""The port's span and counter recorder (``photometry_tpu_torch.utils.profiling``), on the CPU.

- ``span`` and ``count`` add into the open recorder, and into the one it
  was opened inside; with none open they add nowhere.
- ``count`` from 8 threads at once loses no addition.
- A span kept on an event list encloses the ``torch.profiler`` event of a
  torch op run inside it: both are on ``time.time_ns()``'s clock.
- ``run_drain`` on a small simulated sector (halo and linPSF switches, a
  TPF) reports every key of ``new_timers`` (those of a host context at 0)
  and the spans of each method sum to at most ``photometry``; with ``method="psf"`` the four steps of
  the PSF extraction sum to at most ``psf``, and ``psf_instances`` is the
  instances the fitter was handed.
- ``prepare_cube`` counts the HDU data bytes of every FFI read in stages 1
  and 2, and the first FFI once more.
- ``device_trace`` writes the program's spans into its Chrome trace, on
  the trace's own time base.
"""

import glob
import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from photometry_tpu_torch.cli import prepare_cmd, todo_cmd
from photometry_tpu_torch.core import dispatcher
from photometry_tpu_torch.core.drain import new_timers, run_drain
from photometry_tpu_torch.core.timecorr import SpacecraftEphemeris, TimeCorrector
from photometry_tpu_torch.io import fits as pf
from photometry_tpu_torch.sim.simulator import SimConfig, simulate_sector
from photometry_tpu_torch.utils import profiling
from photometry_tpu_torch.utils.profiling import StageTimer, count, span

OLD_KEYS = {"lease", "context", "photometry", "save", "sqlite", "wall", "n_done", "n_batches",
            "n_products"}
NEW_KEYS = {"aperture", "halo", "linpsf", "psf", "context.read", "context.upload",
            "save.compress", "fits_bytes", "fits_table_bytes"}
PSF_KEYS = {"psf.setup", "psf.gather", "psf.fit", "psf.results", "psf_instances",
            "psf_fused_instances"}
HOST_KEYS = {"aperture.stream", "stamps.host", "stream_passes", "stream_bytes",
             "stream_staged_bytes", "host_stamp_bytes"}


def test_span_and_count_add_into_the_open_recorders_only():
    with span("a"):
        count("n", 5)
    outer, inner = {}, {"n": 1}
    with StageTimer(outer).recording():
        with span("a"):
            time.sleep(0.01)
        with StageTimer(inner).recording():
            count("n", 2)
            with span("b"):
                pass
        count("n", 3)
    with span("a"):
        count("n", 7)
    assert profiling._active is None
    assert set(outer) == {"a", "b", "n"} and outer["n"] == 5 and outer["a"] >= 0.01
    assert set(inner) == {"b", "n"} and inner["n"] == 3
    assert outer["b"] == inner["b"]


def test_count_from_eight_threads_loses_no_addition():
    timings = {}
    start = threading.Barrier(8)

    def add():
        start.wait()
        for _ in range(5000):
            count("n")
            with span("s"):
                pass

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)              # switch threads often: a lost update shows
    try:
        with StageTimer(timings).recording():
            threads = [threading.Thread(target=add) for _ in range(8)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(th.is_alive() for th in threads)
    assert timings["n"] == 8 * 5000 and timings["s"] > 0


def test_event_span_encloses_the_profiler_event_of_its_op():
    events = []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with StageTimer(events=events).recording():
            with span("op"):
                torch.ones(4096).sum()
    (name, start, end, tid), = events
    assert name == "op" and tid == threading.get_native_id()
    ops = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::sum"]
    assert ops
    for e in ops:
        assert start <= e.start_ns() and e.start_ns() + e.duration_ns() <= end


def test_device_trace_holds_the_program_spans(tmp_path):
    with profiling.device_trace(str(tmp_path)):
        with span("outer"):
            torch.ones(4096).sum()
            count("n", 3)
    path, = glob.glob(str(tmp_path / "trace_*.json"))
    with open(path) as fh:
        trace = json.load(fh)
    mine = [e for e in trace["traceEvents"] if e.get("cat") == "program_span"]
    assert [e["name"] for e in mine] == ["outer"]
    ops = [e for e in trace["traceEvents"] if e.get("name") == "aten::sum"]
    assert ops and all(mine[0]["ts"] <= e["ts"] and e["ts"] + e["dur"] <= mine[0]["ts"]
                       + mine[0]["dur"] for e in ops)
    assert trace["programTimings"]["n"] == 3


@pytest.fixture(scope="module")
def sector(tmp_path_factory):
    """Two bright stars on the CCD's edges (the halo switch), two split
    blends (the deblend switch) and a TPF of a faint isolated star, made by
    the port's prepare and todo CLIs."""
    d = str(tmp_path_factory.mktemp("torch_profiling") / "sector")
    os.makedirs(d)
    stars = [(30.0, 1.0, 4.8), (96.0, 126.0, 5.3), (64.0, 20.0, 9.5), (20.0, 100.0, 9.8)]
    for i, sep in enumerate([3.5, 4.5]):
        r, c = 60.0 + 14.0 * i, 55.0
        stars += [(r, c, 10.0), (r + sep * 0.7, c + sep * 0.714, 10.3)]
    sim = simulate_sector(SimConfig(shape=(128, 128), n_times=12, n_stars=len(stars),
                                    stars=tuple(stars), seed=23, jitter_amp=0.02,
                                    variable_fraction=0.0))
    sim.write_ffis(d)
    sim.write_catalog(d)
    sim.write_tpf(d, int(sim.starid[2]), stamp=(11, 11), n_times=40)
    assert prepare_cmd.main(["-q", "--device", "cpu", d]) == 0
    assert todo_cmd.main(["-q", d]) == 0
    return sim, d


def test_run_drain_reports_every_span_and_counter(sector, monkeypatch):
    sim, d = sector
    t0 = float(sim.time[0]) + 2457000.0
    monkeypatch.setattr(dispatcher, "default_time_corrector",
                        lambda: TimeCorrector(SpacecraftEphemeris.synthetic(t0 - 5, t0 + 10)))
    timers = new_timers()
    assert set(timers) == OLD_KEYS | NEW_KEYS | PSF_KEYS | HOST_KEYS
    n_done = run_drain(d, 1, batch_size=8, device="cpu", timers=timers)
    assert set(timers) == OLD_KEYS | NEW_KEYS | PSF_KEYS | HOST_KEYS
    assert timers["n_done"] == n_done > 0
    assert all(timers[k] > 0 for k in OLD_KEYS | NEW_KEYS - {"psf"}), timers
    assert timers["psf"] == 0 and not any(timers[k] for k in PSF_KEYS)
    assert not any(timers[k] for k in HOST_KEYS)        # the cubes are the device's
    methods = sum(timers[k] for k in ("aperture", "halo", "linpsf", "psf"))
    assert methods <= timers["photometry"]
    assert timers["context.read"] + timers["context.upload"] <= timers["context"]
    assert timers["save.compress"] <= 4 * timers["save"]
    assert timers["wall"] >= timers["photometry"] + timers["save"] + timers["context"]


def test_psf_drain_reports_its_steps_and_instances(sector, monkeypatch, tmp_path):
    """``run_drain(method="psf")`` times the four steps of each PSF
    extraction inside ``psf`` and counts the instances the fitter was
    handed: each target's first cadence, then every cadence."""
    import shutil
    from photometry_tpu_torch.models import psf_fit
    sim, src = sector
    d = str(tmp_path / "sector")
    shutil.copytree(src, d)
    os.remove(os.path.join(d, "todo.sqlite"))
    assert todo_cmd.main(["-q", d]) == 0
    t0 = float(sim.time[0]) + 2457000.0
    monkeypatch.setattr(dispatcher, "default_time_corrector",
                        lambda: TimeCorrector(SpacecraftEphemeris.synthetic(t0 - 5, t0 + 10)))
    handed, fit = [], psf_fit.fit_psf_timeseries_batch

    def recorded(images, *a, **kw):
        handed.append(images.shape[0] * (images.shape[1] + 1))
        return fit(images, *a, **kw)
    monkeypatch.setattr(psf_fit, "fit_psf_timeseries_batch", recorded)
    timers = new_timers()
    n_done = run_drain(d, 1, batch_size=8, method="psf", device="cpu", timers=timers)
    assert n_done > 0 and handed
    steps = ("psf.setup", "psf.gather", "psf.fit", "psf.results")
    assert all(timers[k] > 0 for k in steps), timers
    assert sum(timers[k] for k in steps) <= timers["psf"] <= timers["photometry"]
    assert timers["psf_instances"] == sum(handed)
    assert timers["psf_fused_instances"] == 0            # the CPU takes the plain route
    assert timers["aperture"] == timers["halo"] == timers["linpsf"] == 0


def _data_bytes(path):
    """Bytes of the data arrays of a FITS file's HDUs (none where NAXIS is 0)."""
    return sum(int(np.prod([h.header[f"NAXIS{i}"] for i in range(1, h.header["NAXIS"] + 1)]))
               * abs(h.header["BITPIX"]) // 8 for h in pf.read_fits(path) if h.header["NAXIS"])


def test_prepare_cube_counts_each_read_of_each_frame(sector, tmp_path):
    from chip_smoke import DictCube
    from photometry_tpu_torch.io.discovery import find_ffi_files
    from photometry_tpu_torch.prepare import prepare_cube
    sim, d = sector
    files = find_ffi_files(d)[:6]
    folder = str(tmp_path)                      # no catalog, no TPF: FFIs only
    cube = DictCube(len(files), sim.config.shape, keep_frames=1)
    walls = prepare_cube(cube, files, folder, 1, 3, 2, device="cpu", chunk=4)
    # stage 1 and stage 2 each read every frame; the header comes from the first
    want = 2 * sum(_data_bytes(f) for f in files) + _data_bytes(files[0])
    assert walls["fits_bytes"] == want
    assert 0 < walls["frames.read"] < walls["backgrounds_fit"] + walls["images"]
    assert {"backgrounds_fit", "backgrounds_smooth", "images", "shenanigans",
            "quality_tpf"} <= set(walls)


@pytest.mark.parametrize("n_files,chunk", [(6, 4), (5, 5)])
def test_prepare_cube_counts_the_frames_stage_2_ran_on_the_device(sector, tmp_path, n_files,
                                                                   chunk):
    """``images_device_frames`` counts every frame whose stage-2 arithmetic
    ran on the torch device, a partial last chunk too; the loader's span
    still covers the frames both stages read."""
    from chip_smoke import DictCube
    from photometry_tpu_torch.io.discovery import find_ffi_files
    from photometry_tpu_torch.prepare import prepare_cube
    sim, d = sector
    files = find_ffi_files(d)[:n_files]
    cube = DictCube(len(files), sim.config.shape, keep_frames=1)
    walls = prepare_cube(cube, files, str(tmp_path), 1, 3, 2, device="cpu", chunk=chunk)
    assert walls["images_device_frames"] == len(files)
    assert 0 < walls["frames.read"] < walls["backgrounds_fit"] + walls["images"]
