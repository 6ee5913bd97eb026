"""Milliseconds of an FFI drain's ``linpsf`` span per task done: the linear
PSF extractions the deblend switch chose, inside the ``photometry`` phase
(``run_drain(timers=)``)."""


def read(run):
    t = run.get("timers") or {}
    if not t.get("n_done") or "linpsf" not in t:
        return None
    return 1e3 * t["linpsf"] / t["n_done"]
