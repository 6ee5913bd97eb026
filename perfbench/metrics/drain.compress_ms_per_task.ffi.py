"""Milliseconds of an FFI drain's ``save.compress`` span per task done: the
products' gzip in the writer threads (``io.fits.write_fits``), summed over
the threads, so it may exceed the ``save`` phase it runs in
(``run_drain(timers=)``)."""


def read(run):
    t = run.get("timers") or {}
    if not t.get("n_done") or "save.compress" not in t:
        return None
    return 1e3 * t["save.compress"] / t["n_done"]
