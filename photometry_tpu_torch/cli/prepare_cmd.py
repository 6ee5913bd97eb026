"""
CLI: prepare FFIs into image cubes on the port.

Port of ``photometry_tpu/cli/prepare_cmd.py`` (reference
run_prepare_photometry.py).  ``--device`` picks the torch device of the
background fit, the median filter and, with ``--movement-kernel``, the ECC
registration of the movement kernels (default: cuda).

Usage:
    python -m photometry_tpu_torch.cli.prepare_cmd [options] [input_folder]
"""

from __future__ import annotations

import argparse
import logging
import os
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Prepare FFIs for photometry (PyTorch + CUDA).")
    parser.add_argument("-d", "--debug", action="store_true", help="Print debug messages.")
    parser.add_argument("-q", "--quiet", action="store_true",
                        help="Only report warnings and errors.")
    parser.add_argument("--sector", type=int, default=None, action="append")
    parser.add_argument("--camera", type=int, default=None, action="append", choices=(1, 2, 3, 4))
    parser.add_argument("--ccd", type=int, default=None, action="append", choices=(1, 2, 3, 4))
    parser.add_argument("--movement-kernel", action="store_true",
                        help="Also compute ECC movement kernels.")
    parser.add_argument("-o", "--output", default=None)
    parser.add_argument("--process-id", type=int, default=None,
                        help="This host's index in a static multi-host split of the CCD list "
                             "(with --num-processes).")
    parser.add_argument("--num-processes", type=int, default=None,
                        help="Total hosts in a static multi-host split.")
    parser.add_argument("--device", default="cuda",
                        help="Torch device of the background fit, filters and registration "
                             "(default: cuda).")
    parser.add_argument("input_folder", nargs="?", default=None)
    args = parser.parse_args(argv)

    level = logging.WARNING if args.quiet else logging.DEBUG if args.debug else logging.INFO
    logging.basicConfig(level=level, format="%(asctime)s - %(levelname)s - %(message)s")

    input_folder = args.input_folder or os.environ.get("TESSPHOT_INPUT")
    if not input_folder:
        raise SystemExit("Please specify an input folder (or set TESSPHOT_INPUT).")
    if not os.path.isdir(input_folder):
        raise SystemExit(f"Not a directory: {input_folder}")

    from ..prepare import prepare_photometry
    paths = prepare_photometry(input_folder, output_folder=args.output, sectors=args.sector,
                               cameras=args.camera, ccds=args.ccd,
                               process_id=args.process_id, process_count=args.num_processes,
                               device=args.device, calc_movement_kernel=args.movement_kernel)
    for p in paths:
        print(p)
    return 0


if __name__ == "__main__":
    sys.exit(main())
