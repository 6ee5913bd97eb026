"""Megabytes of FITS HDU data the drains decode per task done: the
``fits_bytes`` counter of ``io.fits.read_fits`` (after inflation), in
``run_drain(timers=)``."""


def read(run):
    t = run.get("timers") or {}
    if not t.get("n_done") or "fits_bytes" not in t:
        return None
    return t["fits_bytes"] / 1e6 / t["n_done"]
