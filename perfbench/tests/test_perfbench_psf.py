"""The PSF cell ``ffi1800.psf`` rehearsed on the CPU at a tiny size through
the harness, and its check seen to fail with each fault of
``drivers/drain_psf.py`` planted in the program.  The CPU takes the plain
fitter where the card takes ``psf_warm_fit.cu``; the device readers stay
silent."""

import os
import sys
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from perfbench import bench  # noqa: E402
from perfbench.drivers import drain_psf  # noqa: E402

CELL = "ffi1800.psf"
# the field's density of stars on a 256x256 tile, 8 frames; 4 pairs, of
# which the two closer than 5 px are fitted as two stars
TINY = ({"rows": 256, "cols": 256, "n_times": 8,
         "field": {"n_stars": 300, "tmag_min": 7.5, "tmag_max": 13.0}},
        {"todo": 120, "pairs": 4, "warm_tasks": 16, "batch_size": 64,
         "check": {"psf_sample": 12}})


def run(tmp_path, trace=False, seed=2147483011):
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
    assert values["n_psf_truth"] == 12 and values["n_pair_truth"] == 8
    # most sampled cadences are compared (the rest have a pixel on the cutoff's edge)
    assert values["n_psf_cadences"] > 0.75 * 12 * TINY[0]["n_times"]
    assert run_["timers"]["psf_instances"] > 0 and values["prf_not_table"] == 0


@pytest.mark.parametrize("fault", sorted(drain_psf.faults()))
def test_each_planted_fault_comes_out_not_correct(fault, tmp_path):
    with drain_psf.faults()[fault]():
        result, _, _ = run(tmp_path)
    assert not result["correct"], result["checks"]
