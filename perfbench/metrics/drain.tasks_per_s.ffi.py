"""Tasks delivered per second in the traced window of an FFI drain: rows
that ended OK or WARNING with their product on disk, over the whole time of
the window's drains.  The FFI drain's rate, kept per layer: on the card's
host its runs spread too widely for an end-to-end bound (PERF.md, section 2)."""


def read(run):
    if "n_tasks" not in run or not run.get("window_s"):
        return None
    return run["n_tasks"] / run["window_s"]
