"""The background fit's kernel share on hand-made runs: the number it
reads, None where the program has no ``background_kernel_frames`` counter,
and its entry in ``BENCHMARK.json``.  CPU only."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from perfbench import bench  # noqa: E402

NAME = "prepare.background_kernel_share"
RUN = {"window_s": 30.0, "prepares": 2, "n_frames": 256,
       "prepare_walls": {"backgrounds_fit": 25.6, "images": 5.12,
                         "background_kernel_frames": 256, "images_device_frames": 256}}


def test_background_kernel_share_reads_the_counter():
    assert bench.reader(NAME)(RUN) == pytest.approx(100.0)
    half = dict(RUN, prepare_walls=dict(RUN["prepare_walls"], background_kernel_frames=64))
    assert bench.reader(NAME)(half) == pytest.approx(25.0)


def test_background_kernel_share_is_none_without_its_counter():
    """A program without the counter (the parent of the change that added
    it, or a fit on the plain path) gives no value and raises nothing."""
    walls = {k: v for k, v in RUN["prepare_walls"].items() if k != "background_kernel_frames"}
    read = bench.reader(NAME)
    assert read(dict(RUN, prepare_walls=walls)) is None
    assert read(dict(RUN, n_frames=0)) is None
    assert read({}) is None


def test_background_kernel_share_is_listed_for_the_prepare_cell_alone():
    spec = bench.spec()
    m = next(m for m in spec["per_layer"] if m["name"] == NAME)
    assert m["workloads"] == ["ffi1800.prepare"] and m["moves"] == "frames_per_s"
    assert m["layer"] == "background fit and smoothing" and m["source"] == "program_counter"
    assert NAME in [x["name"] for x in bench.metrics_of(spec, "ffi1800.prepare", "per_layer")]
