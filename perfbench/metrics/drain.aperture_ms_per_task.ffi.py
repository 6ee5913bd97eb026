"""Milliseconds of an FFI drain's ``aperture`` span per task done: every
aperture extraction (``core.dispatcher._run_method``), inside the
``photometry`` phase (``run_drain(timers=)``)."""


def read(run):
    t = run.get("timers") or {}
    if not t.get("n_done") or "aperture" not in t:
        return None
    return 1e3 * t["aperture"] / t["n_done"]
