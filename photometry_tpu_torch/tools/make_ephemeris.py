"""
Convert a JPL Horizons VECTORS export to the spacecraft-ephemeris npz table.

The port's copy of ``tools/make_ephemeris.py``: the offline provisioning
path for real spacecraft ephemerides (the reference pipeline downloads
binary SPICE kernels at run time, spice.py:104-158).

1. https://ssd.jpl.nasa.gov/horizons/app/ -> Ephemeris Type "Vector Table",
   Target Body "TESS (spacecraft) [-95]", Coordinate Center "@0" (solar
   system barycenter), reference frame ICRF, any span and step covering
   the sectors to process; save the result as a text file.
2. ``python -m photometry_tpu_torch.tools.make_ephemeris export.txt``
   writes the npz into the worker cache (``download_cache.ephemeris_path``,
   shared with the JAX package), or ``-o my_ephemeris.npz`` writes it
   elsewhere, to be served at the ``[timecorr] ephemeris_url`` settings key.

A synthetic-orbit sample in the Horizons format ships at
``photometry_tpu_torch/data/ephemeris/tess_horizons_sample.txt``.  Host
only (numpy).
"""

import argparse
import sys

from ..download_cache import ephemeris_path, horizons_to_ephemeris


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Convert a JPL Horizons VECTORS export to the "
                    "spacecraft-ephemeris npz table.")
    parser.add_argument("horizons_file", help="Horizons text export (VECTORS)")
    parser.add_argument("-o", "--output", default=None,
                        help="Output npz path (default: the worker cache)")
    parser.add_argument("--earth", default=None, metavar="FILE",
                        help="Optional second VECTORS export for the EARTH "
                             "geocentre (target 399, center 500@0); enables "
                             "the Einstein clock term of "
                             "barycentric_correction_full.")
    args = parser.parse_args(argv)

    out = args.output or ephemeris_path()
    eph = horizons_to_ephemeris(args.horizons_file, output=out, earth_source=args.earth)
    span = eph.time[-1] - eph.time[0]
    print(f"{out}: {len(eph.time)} samples, JD {eph.time[0]:.3f}..."
          f"{eph.time[-1]:.3f} ({span:.1f} d)"
          + (", with Earth positions (Einstein term enabled)"
             if eph.pos_earth is not None else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
