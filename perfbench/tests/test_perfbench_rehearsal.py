"""Each cell's path rehearsed on the CPU at a tiny size, and the check seen
to fail when the timed path is broken underneath.  The runs skip the
harness's look for a card (``bench.run_cell`` on the CPU); the kernels'
plain versions run in their place."""

import os
import sys
import time
from unittest import mock

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from perfbench import bench  # noqa: E402

FIELD = {"n_stars": 300, "tmag_min": 7.5, "tmag_max": 13.0, "psf_sigma_px": 1.2}
TINY = {
    "ffi1800.drain": ({"rows": 256, "cols": 256, "n_times": 200, "field": FIELD},
                      {"todo": 120, "bright": 4, "pairs": 4, "tail": 40, "warm_tasks": 16,
                       "batch_size": 64, "check": {"aperture_sample": 12}}),
    "tpf120.drain": ({"n_times": 600, "n_tpf": 8, "gzip": 1,
                      "field": {**FIELD, "n_stars": 3000}}, {}),
    # the full field's density of stars, on tiles as wide as a CCD's:
    "ffi1800.prepare": ({"rows": 256, "cols": 256, "raw_rows": 256, "raw_cols": 256,
                         "n_times": 8, "field": {**FIELD, "n_stars": 190}},
                        {"chunk": 4, "warm_frames": 2}),
}
KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


def run(cell, tmp_path, trace=False, seed=11):
    cfg, mix = TINY[cell]
    result, values, _ = bench.run_cell(cell, seed, 0.0, trace, torch.device("cpu"),
                                       time.perf_counter(),
                                       work=str(tmp_path / "work"), config_override=cfg,
                                       traffic_override=mix)
    return result, values


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", sorted(TINY))
def test_rehearsal_prints_the_result_line(cell, trace, tmp_path, capsys):
    result, values = run(cell, tmp_path, trace)
    bench.emit(result)
    out, err = capsys.readouterr()
    last = out.strip().splitlines()[-1]
    assert KEYS <= set(result) and list(result)[-1] == "checks"
    assert result["correct"], result["checks"]
    assert err.strip().splitlines()[-1].startswith("check ")
    assert last.startswith('{"correct": true')
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in bench.metrics_of(bench.spec(), cell, kind)}
    # On the CPU the device readers find nothing to read and stay silent:
    device_only = {m["name"] for m in bench.spec()[kind] if m["source"] == "device_trace"}
    assert set(result["metrics"]) == want - device_only
    assert values.get("n_aperture", 1) > 0


def _half_lease(batch_fn):
    """Each lease's first half only (none of a one-task TPF lease)."""
    def half(ctx, tasks, **kw):
        keep = tasks[:len(tasks) // 2]
        return batch_fn(ctx, keep, **kw) if keep else []
    return half


def _scaled(fn, key, factor):
    def scaled(*a, **kw):
        out = fn(*a, **kw)
        for res in out:
            if res.lightcurve.get(key) is not None:
                res.lightcurve[key] = res.lightcurve[key] * factor
        return out
    return scaled


def _half_frames(residual):
    """The residuals of each chunk's first half of frames, repeated for the rest."""
    def half(img, *a, **kw):
        out = residual(img[:max(img.shape[0] // 2, 1)], *a, **kw)
        return out[torch.arange(img.shape[0]) % out.shape[0]]
    return half


def faults():
    from perfbench.drivers import drain as drain_driver, prepare as prepare_driver
    from photometry_tpu_torch import prepare
    from photometry_tpu_torch.core import dispatcher, drain
    from photometry_tpu_torch.models import halo, linpsf
    from photometry_tpu_torch.ops import bandext
    sums, residual = bandext.band_sums, prepare.shenanigans_residual
    return {
        # an answer altered where it is produced:
        "band sums off by 1e-3": lambda: mock.patch.object(
            bandext, "band_sums", lambda *a, **kw: sums(*a, **kw) * (1 + 1e-3)),
        "halo flux off by 1e-3": lambda: mock.patch.object(
            halo, "extract_halo_batch", _scaled(halo.extract_halo_batch, "flux", 1 + 1e-3)),
        "linPSF flux_err off by 1e-3": lambda: mock.patch.object(
            linpsf, "extract_linpsf_batch",
            _scaled(linpsf.extract_linpsf_batch, "flux_err", 1 + 1e-3)),
        # half of each lease left out:
        "half of each lease": lambda: mock.patch.object(
            drain, "photometry_batch", _half_lease(drain.photometry_batch)),
        # a step that returns its state unchanged: the halo queue never resolves
        "halo queue never flushed": lambda: mock.patch.object(
            dispatcher.HaloSwitchQueue, "flush", lambda self, force=False: []),
        # the prepare stage: the smoothing leaves the backgrounds as they were,
        # the residuals off by 1e-3, half of each chunk's frames median filtered
        "smoothing returns the backgrounds unchanged": lambda: mock.patch.object(
            prepare, "smooth_backgrounds", lambda *a, **kw: None),
        "residuals off by 1e-3": lambda: mock.patch.object(
            prepare, "shenanigans_residual",
            lambda *a, **kw: residual(*a, **kw) * (1 + 1e-3)),
        "half of each chunk's frames": lambda: mock.patch.object(
            prepare, "shenanigans_residual", _half_frames(residual)),
        # the wrong mask, star, target or sky, each held to the field's truth:
        **drain_driver.faults(), **prepare_driver.faults(),
    }


CASES = [("ffi1800.drain", f) for f in ("band sums off by 1e-3", "halo flux off by 1e-3",
                                         "linPSF flux_err off by 1e-3", "half of each lease",
                                         "halo queue never flushed", "K2P2 masks two rows off",
                                         "linPSF flux of the next star of the fit",
                                         "halo light curves of the next target")]
CASES += [("tpf120.drain", f) for f in ("band sums off by 1e-3", "half of each lease")]
CASES += [("ffi1800.prepare", f) for f in ("smoothing returns the backgrounds unchanged",
                                           "residuals off by 1e-3", "half of each chunk's frames",
                                           "background fit without the catalog's source mask")]


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_broken_timed_path_comes_out_not_correct(cell, fault, tmp_path):
    with faults()[fault]():
        result, _ = run(cell, tmp_path)
    assert not result["correct"], result["checks"]
