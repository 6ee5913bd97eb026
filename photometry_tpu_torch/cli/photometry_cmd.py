"""
CLI: run photometry from the TODO list on the port.

Port of ``photometry_tpu/cli/photometry_cmd.py`` (reference run_tessphot.py):
select a task by --starid, --priority, --random or queue order, or drain
the whole queue with --all.  ``--method`` forces aperture, psf, linpsf or
halo; without it each task runs its own method (aperture with the automatic
halo and linPSF switches by default).

Usage:
    python -m photometry_tpu_torch.cli.photometry_cmd --version 1 [options] [input_folder]
"""

from __future__ import annotations

import argparse
import logging
import os
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Run TESS photometry (PyTorch + CUDA).")
    parser.add_argument("-d", "--debug", action="store_true", help="Print debug messages.")
    parser.add_argument("-q", "--quiet", action="store_true",
                        help="Only report warnings and errors.")
    parser.add_argument("-m", "--method", default=None,
                        choices=("aperture", "psf", "linpsf", "halo"))
    parser.add_argument("--starid", type=int, default=None)
    parser.add_argument("--priority", type=int, default=None)
    parser.add_argument("-r", "--random", action="store_true")
    parser.add_argument("--all", action="store_true", help="Process all pending tasks.")
    parser.add_argument("--batch-size", type=int, default=256)
    parser.add_argument("--datasource", default=None, choices=("ffi", "tpf"))
    parser.add_argument("--camera", type=int, default=None)
    parser.add_argument("--ccd", type=int, default=None)
    parser.add_argument("--version", type=int, required=True,
                        help="Data release version to put in output files.")
    parser.add_argument("-o", "--output", default=None,
                        help="Output directory (default: alongside input).")
    parser.add_argument("--device", default="cuda",
                        help="Torch device of the cubes and kernels (default: cuda).")
    parser.add_argument("input_folder", nargs="?", default=None)
    args = parser.parse_args(argv)

    level = logging.WARNING if args.quiet else logging.DEBUG if args.debug else logging.INFO
    logging.basicConfig(level=level, format="%(asctime)s - %(levelname)s - %(message)s")

    input_folder = args.input_folder or os.environ.get("TESSPHOT_INPUT")
    if not input_folder:
        raise SystemExit("Please specify an input folder (or set TESSPHOT_INPUT).")
    if not os.path.isdir(input_folder):
        raise SystemExit(f"Not a directory: {input_folder}")
    output_folder = args.output or os.environ.get("TESSPHOT_OUTPUT") or input_folder

    constraints = {k: v for k, v in (("starid", args.starid), ("priority", args.priority),
                                     ("datasource", args.datasource),
                                     ("camera", args.camera), ("ccd", args.ccd))
                   if v is not None}

    from ..core.drain import run_drain
    run_drain(
        input_folder, args.version,
        output_folder=output_folder,
        # None keeps the reference's default product layout under the input:
        products_folder=None if args.output is None else output_folder,
        all_tasks=args.all, random_task=args.random,
        batch_size=args.batch_size, method=args.method,
        constraints=constraints, device=args.device,
        summary=os.path.join(output_folder, "summary.json") if args.all else None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
