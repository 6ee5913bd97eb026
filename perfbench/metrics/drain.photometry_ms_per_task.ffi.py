"""Milliseconds of an FFI drain's ``photometry`` phase per task done
(``run_drain(timers=)``)."""


def read(run):
    t = run.get("timers") or {}
    if not t.get("n_done") or "photometry" not in t:
        return None
    return 1e3 * t["photometry"] / t["n_done"]
