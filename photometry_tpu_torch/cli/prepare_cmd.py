"""
CLI: prepare FFIs into image cubes on the port.

Port of ``photometry_tpu/cli/prepare_cmd.py`` (reference
run_prepare_photometry.py).  ``--device`` picks the torch device of the
background fit, the median filter and, with ``--movement-kernel``, the ECC
registration of the movement kernels (default: cuda).  With
``PHOTOMETRY_TPU_TRACE_DIR`` set, the run is traced into it
(``utils.profiling.device_trace``, the program's spans among the kernels).

Usage:
    python -m photometry_tpu_torch.cli.prepare_cmd [options] [input_folder]
"""

from __future__ import annotations

import argparse
import sys

from .common import add_device_arg, add_logging_args, resolve_input_folder, setup_logging


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Prepare FFIs for photometry (PyTorch + CUDA).")
    add_logging_args(parser)
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
    add_device_arg(parser, "the background fit, filters and registration")
    parser.add_argument("input_folder", nargs="?", default=None)
    args = parser.parse_args(argv)

    setup_logging(args)
    input_folder = resolve_input_folder(args.input_folder)

    from ..prepare import prepare_photometry
    from ..utils.profiling import device_trace
    with device_trace():
        paths = prepare_photometry(input_folder, output_folder=args.output,
                                   sectors=args.sector, cameras=args.camera, ccds=args.ccd,
                                   process_id=args.process_id,
                                   process_count=args.num_processes, device=args.device,
                                   calc_movement_kernel=args.movement_kernel)
    for p in paths:
        print(p)
    return 0


if __name__ == "__main__":
    sys.exit(main())
