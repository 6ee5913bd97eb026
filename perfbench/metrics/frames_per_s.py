"""Raw FFIs taken through ``prepare.prepare_cube`` (stages 1-5) into a fresh
store per second, over the whole time of the window's prepares."""


def read(run):
    if "n_frames" not in run or not run.get("window_s"):
        return None
    return run["n_frames"] / run["window_s"]
