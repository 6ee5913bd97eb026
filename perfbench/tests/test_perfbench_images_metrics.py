"""The images stage's two metric readers on hand-made runs: the numbers
they read, and None where the program has no ``images`` wall or no
``images_device_frames`` counter.  CPU only."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from perfbench import bench  # noqa: E402

RUN = {"window_s": 30.0, "prepares": 2, "n_frames": 256,
       "prepare_walls": {"backgrounds_fit": 25.6, "images": 5.12, "frames.read": 0.4,
                         "images_device_frames": 256, "fits_bytes": 18_258_000_000}}


def test_images_ms_per_frame_reads_the_images_wall():
    assert bench.reader("prepare.images_ms_per_frame")(RUN) == pytest.approx(20.0)


def test_images_device_share_reads_the_counter():
    assert bench.reader("prepare.images_device_share")(RUN) == pytest.approx(100.0)
    half = dict(RUN, prepare_walls=dict(RUN["prepare_walls"], images_device_frames=64))
    assert bench.reader("prepare.images_device_share")(half) == pytest.approx(25.0)


@pytest.mark.parametrize("metric,absent", [("prepare.images_ms_per_frame", "images"),
                                           ("prepare.images_device_share",
                                            "images_device_frames")])
def test_images_metrics_are_none_without_their_numbers(metric, absent):
    """A program without the counter (the parent of the change that added
    it) or a run without the wall gives no value and raises nothing."""
    read = bench.reader(metric)
    walls = {k: v for k, v in RUN["prepare_walls"].items() if k != absent}
    assert read(dict(RUN, prepare_walls=walls)) is None
    assert read(dict(RUN, n_frames=0)) is None
    assert read({}) is None


def test_images_metrics_are_listed_for_the_prepare_cell_alone():
    spec = bench.spec()
    for name in ("prepare.images_ms_per_frame", "prepare.images_device_share"):
        m = next(m for m in spec["per_layer"] if m["name"] == name)
        assert m["workloads"] == ["ffi1800.prepare"] and m["moves"] == "frames_per_s"
        assert m["layer"] == "images stage"
        assert name in [x["name"] for x in bench.metrics_of(spec, "ffi1800.prepare",
                                                            "per_layer")]
