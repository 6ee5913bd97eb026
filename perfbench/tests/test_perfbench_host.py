"""The host-cube cell ``ffi1800.host`` rehearsed on the CPU at a tiny size
through the harness (two 128-frame chunks a streamed pass), its check seen
to fail with each fault of ``drivers/drain_host.py`` planted in the
program, and its set-up seen to stop at once on a program whose
``run_drain`` takes no ``cache``.  The CPU takes the plain sums where the
card takes ``band_extract.cu``; the device readers stay silent."""

import os
import sys
import time
from unittest import mock

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from perfbench import bench  # noqa: E402
from perfbench.drivers import drain_host  # noqa: E402

CELL = "ffi1800.host"
# ffi1800.drain's rehearsal size: the field's density of stars on a
# 256x256 tile, 200 frames (two chunks of the stream)
TINY = ({"rows": 256, "cols": 256, "n_times": 200,
         "field": {"n_stars": 300, "tmag_min": 7.5, "tmag_max": 13.0, "psf_sigma_px": 1.2}},
        {"todo": 120, "bright": 4, "pairs": 4, "tail": 40, "warm_tasks": 16, "batch_size": 64,
         "check": {"aperture_sample": 12}})


def run(tmp_path, trace=False, seed=2147483077):
    cfg, mix = TINY
    return bench.run_cell(CELL, seed, 0.0, trace, torch.device("cpu"), time.perf_counter(),
                          work=str(tmp_path / "work"), config_override=cfg,
                          traffic_override=mix)


@pytest.mark.parametrize("trace", [False, True])
def test_rehearsal_prints_a_correct_result_line(trace, tmp_path, capsys):
    result, values, run_ = run(tmp_path, trace)
    bench.emit(result)
    out, _ = capsys.readouterr()
    assert out.strip().splitlines()[-1].startswith('{"correct": true'), result["checks"]
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in bench.metrics_of(bench.spec(), CELL, kind)}
    device_only = {m["name"] for m in bench.spec()[kind] if m["source"] == "device_trace"}
    assert set(result["metrics"]) == want - device_only
    assert values["stream_mismatch"] == 0 and values["n_aperture"] > 0
    t = run_["timers"]
    cfg = TINY[0]
    assert t["stream_passes"] == run_["stream_passes_seen"] >= t["n_batches"] > 0
    assert t["stream_bytes"] == t["stream_passes"] * cfg["n_times"] * cfg["rows"] * cfg[
        "cols"] * 13
    assert t["host_stamp_bytes"] > 0


@pytest.mark.parametrize("fault", sorted(drain_host.faults()))
def test_each_planted_fault_comes_out_not_correct(fault, tmp_path):
    with drain_host.faults()[fault]():
        result, values, _ = run(tmp_path)
    assert not result["correct"], result["checks"]
    if fault == "each chunk's sums one chunk late":
        assert values["stream_mismatch"] > 0


def test_a_program_without_a_cache_stops_in_setup(tmp_path):
    """The parent's ``run_drain``, which takes no ``cache``: set-up raises
    before it makes the cube."""
    from photometry_tpu_torch.core import drain
    real = drain.run_drain

    def no_cache(input_folder, version, output_folder=None, products_folder=None, *,
                 all_tasks=True, random_task=False, batch_size=256, method=None,
                 constraints=None, plot=False, summary=None, timers=None, device="cuda",
                 mesh=None):
        return real(input_folder, version, output_folder, products_folder)
    made = []
    with mock.patch.object(drain, "run_drain", no_cache), \
            mock.patch.object(drain_host.ffi_host, "sector", lambda *a, **kw: made.append(a)):
        with pytest.raises(RuntimeError, match="takes no cache"):
            run(tmp_path)
    assert not made


def test_a_drain_that_drops_its_cache_is_refused(tmp_path):
    """A program whose contexts never hear of ``cache="host"`` stops the
    run: the driver's ``open_context`` refuses any other cache."""
    from photometry_tpu_torch.core import dispatcher
    real = dispatcher.ContextCache.__init__

    def drops(self, device="cuda", mesh=None, cache="device"):
        real(self, device=device, mesh=mesh)
    with mock.patch.object(dispatcher.ContextCache, "__init__", drops):
        with pytest.raises(RuntimeError, match="does not reach its contexts"):
            run(tmp_path)
