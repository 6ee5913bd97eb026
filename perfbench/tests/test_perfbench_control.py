"""The check's control on the card: a sound run of each cell passes its
limits and the lower-precision control fails them (``readings.py``), at the
cell's own size.  Needs a CUDA card; run it there with

    python -m pytest --noconftest -m cuda perfbench/tests/test_perfbench_control.py
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from perfbench import bench  # noqa: E402


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in bench.spec()["workloads"]])
def test_sound_run_passes_and_control_fails_on_card(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from perfbench import readings
    lines = list(readings.readings(cell, [2147483001], [2147483002], torch.device("cuda", 0)))
    sound = [ln for ln in lines if ln["kind"] == "sound"]
    control = [ln for ln in lines if ln["kind"] != "sound"]
    assert sound and all(ln["pass"] for ln in sound), sound
    assert control and not any(ln["pass"] for ln in control), control
