"""Milliseconds per frame that stages 1 and 2 wait on the frame loader
(``prepare_cube``'s ``frames.read`` span around ``io.loader.iter_frames``)."""


def read(run):
    w = run.get("prepare_walls") or {}
    if not run.get("n_frames") or "frames.read" not in w:
        return None
    return 1e3 * w["frames.read"] / run["n_frames"]
