"""Milliseconds of a PSF drain's ``psf.fit`` span per task done: the fits
(``models.psf_fit.fit_psf_timeseries_batch``) up to the host copy of their
results, inside ``psf``.  None where the program has no such span."""


def read(run):
    t = run.get("timers") or {}
    if not t.get("n_done") or "psf.fit" not in t:
        return None
    return 1e3 * t["psf.fit"] / t["n_done"]
