"""Percent of the frames prepared whose background fit took its tile sigma
clipping (the tiled SExtractor mode) from the tile-mode kernel: the
``background_kernel_frames`` counter in ``prepare_cube``'s walls (a chunk's
frames, once a fit).  None where the program has no such counter."""


def read(run):
    w = run.get("prepare_walls") or {}
    if not run.get("n_frames") or "background_kernel_frames" not in w:
        return None
    return 100 * w["background_kernel_frames"] / run["n_frames"]
