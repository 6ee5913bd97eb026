"""
CLI: create the catalog files of a sector on the port.

Port of ``photometry_tpu/cli/catalog_cmd.py`` (reference
run_make_catalog.py:69) without its download source: catalogs already in
the folder count as present, missing ones are built from a local TIC
extract (``--tic-source``, npz or whitespace table with
starid/ra/dec/pm_ra/pm_dec/tmag[/teff]); without one, the missing
(camera, ccd) pairs are reported and the command exits 1.  Host sqlite
only.

Usage:
    python -m photometry_tpu_torch.cli.catalog_cmd [options] sector [input_folder]
"""

from __future__ import annotations

import argparse
import os
import sys

from .common import add_logging_args, resolve_input_folder, setup_logging


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Create catalog files (PyTorch + CUDA photometry).")
    add_logging_args(parser)
    parser.add_argument("--camera", type=int, default=None, action="append",
                        choices=(1, 2, 3, 4))
    parser.add_argument("--ccd", type=int, default=None, action="append",
                        choices=(1, 2, 3, 4))
    parser.add_argument("-o", "--overwrite", action="store_true")
    parser.add_argument("--tic-source", default=None,
                        help="TIC extract file (.npz or whitespace table) to build the "
                             "missing catalogs from.")
    parser.add_argument("--buffer", type=float, default=0.2,
                        help="Coordinate buffer around the footprint, deg "
                             "(reference run_make_catalog.py --buffer).")
    parser.add_argument("sector", type=int,
                        help="TESS observing sector to generate catalogs for.")
    parser.add_argument("input_folder", nargs="?", default=None)
    args = parser.parse_args(argv)
    logger = setup_logging(args)
    input_folder = resolve_input_folder(args.input_folder)

    from ..catalog import catalog_filename, make_catalog

    missing = []
    for cam in args.camera or [1, 2, 3, 4]:
        for c in args.ccd or [1, 2, 3, 4]:
            path = os.path.join(input_folder, catalog_filename(args.sector, cam, c))
            if os.path.exists(path):
                if not args.overwrite:
                    continue
                os.remove(path)
            if args.tic_source:
                path = make_catalog(input_folder, args.sector, cam, c,
                                    tic_source=args.tic_source, overwrite=args.overwrite,
                                    coord_buffer=args.buffer)
                logger.info("Created %s", path)
            else:
                missing.append((cam, c))
    if missing:
        logger.error("No catalog source for %s: pass --tic-source <extract file>.",
                     ", ".join(f"camera={cam} ccd={c}" for cam, c in missing))
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
