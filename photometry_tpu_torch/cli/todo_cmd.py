"""
CLI: build the todo.sqlite work queue on the port.

Port of ``photometry_tpu/cli/todo_cmd.py`` (reference run_make_todo.py).
Host code: it reads the prepared cubes (HDF5, through ``todolist.open_cube``),
the catalogs and the TPFs, and takes no device.

Usage:
    python -m photometry_tpu_torch.cli.todo_cmd [options] [input_folder]
"""

from __future__ import annotations

import argparse
import sys

from .common import add_logging_args, resolve_input_folder, setup_logging


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Create TODO file (PyTorch + CUDA photometry).")
    add_logging_args(parser)
    parser.add_argument("--sector", type=int, default=None, action="append")
    parser.add_argument("--camera", type=int, default=None, action="append", choices=(1, 2, 3, 4))
    parser.add_argument("--ccd", type=int, default=None, action="append", choices=(1, 2, 3, 4))
    parser.add_argument("-o", "--overwrite", action="store_true")
    parser.add_argument("--no-secondaries", dest="secondaries", action="store_false",
                        help="Skip secondary targets in TPF stamps.")
    parser.add_argument("--output", default=None)
    parser.add_argument("input_folder", nargs="?", default=None)
    args = parser.parse_args(argv)
    setup_logging(args)
    input_folder = resolve_input_folder(args.input_folder)

    from ..todolist import make_todo
    path = make_todo(input_folder, sectors=args.sector, cameras=args.camera,
                     ccds=args.ccd, overwrite=args.overwrite,
                     find_secondary_targets=args.secondaries,
                     output_file=args.output)
    if path:
        print(path)
        return 0
    return 1


if __name__ == "__main__":
    sys.exit(main())
