"""Milliseconds of the drains' ``save`` phase per task done (``run_drain(timers=)``)."""


def read(run):
    t = run.get("timers") or {}
    if not t.get("n_done") or "save" not in t:
        return None
    return 1e3 * t["save"] / t["n_done"]
