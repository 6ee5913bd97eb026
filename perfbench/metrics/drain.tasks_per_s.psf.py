"""Tasks delivered per second in the traced window of a PSF drain: rows that
ended OK or WARNING with their product on disk, over the whole time of the
window's drains (``run_drain(method="psf")``, whole drains back to back)."""


def read(run):
    if "n_tasks" not in run or not run.get("window_s"):
        return None
    return run["n_tasks"] / run["window_s"]
