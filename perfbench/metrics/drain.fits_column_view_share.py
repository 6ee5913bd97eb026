"""Percent of the FITS HDU data bytes the drains decode (``fits_bytes``)
that numeric table columns took, each decoded in one pass from a strided
view on the file's bytes: the ``fits_table_bytes`` counter of
``io.fits.read_fits``, in ``run_drain(timers=)``.  None where the program
has no such counter."""


def read(run):
    t = run.get("timers") or {}
    if not t.get("fits_bytes") or "fits_table_bytes" not in t:
        return None
    return 100 * t["fits_table_bytes"] / t["fits_bytes"]
