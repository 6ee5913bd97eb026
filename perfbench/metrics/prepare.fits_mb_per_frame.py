"""Megabytes of FITS HDU data decoded per frame prepared: the
``fits_bytes`` counter of ``io.fits.read_fits`` (after inflation) in
``prepare_cube``'s walls.  Each frame is read twice (stages 1 and 2) and
the first once more."""


def read(run):
    w = run.get("prepare_walls") or {}
    if not run.get("n_frames") or "fits_bytes" not in w:
        return None
    return w["fits_bytes"] / 1e6 / run["n_frames"]
