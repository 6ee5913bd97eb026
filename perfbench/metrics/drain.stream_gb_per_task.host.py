"""Gigabytes (1e9 B) that the streamed extractions copied from the host
cube to the card per task done: the program's ``stream_bytes`` counter
(``ops.bandext.band_sums_streamed``: every plane's bytes, once a pass).
None where the program has no such counter."""


def read(run):
    t = run.get("timers") or {}
    if not t.get("n_done") or not t.get("stream_bytes"):
        return None
    return t["stream_bytes"] / 1e9 / t["n_done"]
