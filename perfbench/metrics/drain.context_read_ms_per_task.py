"""Milliseconds of the drains' ``context.read`` span per task done: each TPF
read from its file (``io.tess.read_tpf``: open, inflate, decode) inside
``TpfContext``, part of the ``context`` phase (``run_drain(timers=)``)."""


def read(run):
    t = run.get("timers") or {}
    if not t.get("n_done") or "context.read" not in t:
        return None
    return 1e3 * t["context.read"] / t["n_done"]
