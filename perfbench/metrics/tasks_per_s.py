"""Tasks delivered per second: rows that ended OK or WARNING with their
light-curve product on disk, over the whole time of the window's drains."""


def read(run):
    if "n_tasks" not in run or not run.get("window_s"):
        return None
    return run["n_tasks"] / run["window_s"]
