"""Milliseconds per frame of stage 2, the images stage: ``prepare_cube``'s
``images`` wall around ``prepare._images_stage`` (its frame reads
included)."""


def read(run):
    w = run.get("prepare_walls") or {}
    if not run.get("n_frames") or "images" not in w:
        return None
    return 1e3 * w["images"] / run["n_frames"]
