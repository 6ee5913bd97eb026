"""Milliseconds per frame of stage 1: the background fit and the time
smoothing (``prepare_cube``'s ``backgrounds_fit`` + ``backgrounds_smooth`` walls)."""


def read(run):
    w = run.get("prepare_walls") or {}
    if not run.get("n_frames") or "backgrounds_fit" not in w:
        return None
    return 1e3 * (w["backgrounds_fit"] + w.get("backgrounds_smooth", 0.0)) / run["n_frames"]
