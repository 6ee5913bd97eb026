"""Milliseconds of a PSF drain's ``psf.setup`` span per task done: the host
set-up of each PSF extraction (``models.psf_fit.extract_psf_batch``:
catalog positions, each target's stars, stamp buckets, start parameters
and masks), inside ``psf``.  None where the program has no such span."""


def read(run):
    t = run.get("timers") or {}
    if not t.get("n_done") or "psf.setup" not in t:
        return None
    return 1e3 * t["psf.setup"] / t["n_done"]
