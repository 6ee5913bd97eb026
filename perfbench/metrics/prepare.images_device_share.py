"""Percent of the frames prepared whose stage-2 arithmetic (background
subtraction, excluded pixels, the sum image's additions) ran on the torch
device: the ``images_device_frames`` counter in ``prepare_cube``'s walls.
None where the program has no such counter."""


def read(run):
    w = run.get("prepare_walls") or {}
    if not run.get("n_frames") or "images_device_frames" not in w:
        return None
    return 100 * w["images_device_frames"] / run["n_frames"]
