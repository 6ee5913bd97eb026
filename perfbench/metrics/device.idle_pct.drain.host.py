"""Share of a host-cube drain's traced window in which no kernel, copy or
set ran on the card (the streamed copies count as busy)."""


def read(run):
    tr = run.get("trace")
    if not tr or not tr["busy_s"] or not tr["window_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
