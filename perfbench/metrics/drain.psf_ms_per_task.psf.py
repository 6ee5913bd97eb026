"""Milliseconds of a PSF drain's ``psf`` span per task done: every PSF
extraction (``core.dispatcher._run_method``), inside the ``photometry``
phase (``run_drain(timers=)``)."""


def read(run):
    t = run.get("timers") or {}
    if not t.get("n_done") or not t.get("psf"):
        return None
    return 1e3 * t["psf"] / t["n_done"]
