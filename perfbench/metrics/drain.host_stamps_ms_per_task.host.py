"""Milliseconds of the ``stamps.host`` span per task done: the linPSF and
PSF stamps of a host context gathered on the host and moved to the card
(``models.psf_common.context_stamps``).  None where the program has no
such span."""


def read(run):
    t = run.get("timers") or {}
    if not t.get("n_done") or not t.get("stamps.host"):
        return None
    return 1e3 * t["stamps.host"] / t["n_done"]
