"""Milliseconds of the ``aperture.stream`` span per task done: every
streamed extraction of a host cube (``core.engine._extract_flux_streamed``,
inside ``aperture``), up to its last chunk's copies and launch.  None where
the program has no such span."""


def read(run):
    t = run.get("timers") or {}
    if not t.get("n_done") or not t.get("aperture.stream"):
        return None
    return 1e3 * t["aperture.stream"] / t["n_done"]
