"""Milliseconds of the drains' ``context`` phase per task done (``run_drain(timers=)``)."""


def read(run):
    t = run.get("timers") or {}
    if not t.get("n_done") or "context" not in t:
        return None
    return 1e3 * t["context"] / t["n_done"]
