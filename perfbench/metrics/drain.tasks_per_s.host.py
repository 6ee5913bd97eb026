"""Tasks delivered per second in the traced window of a drain from a host
cube (``run_drain(cache="host")``): rows that ended OK or WARNING with
their product on disk, over the whole time of the window's drains."""


def read(run):
    if "n_tasks" not in run or not run.get("window_s"):
        return None
    return run["n_tasks"] / run["window_s"]
