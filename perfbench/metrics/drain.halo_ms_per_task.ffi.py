"""Milliseconds of an FFI drain's ``halo`` span per task done: the halo
extractions the halo switch chose (its queue's flushes), inside the
``photometry`` phase (``run_drain(timers=)``)."""


def read(run):
    t = run.get("timers") or {}
    if not t.get("n_done") or "halo" not in t:
        return None
    return 1e3 * t["halo"] / t["n_done"]
