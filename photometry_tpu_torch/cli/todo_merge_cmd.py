"""
CLI: merge a corrections TODO back into the photometry TODO on the port.

Port of ``photometry_tpu/cli/todo_merge_cmd.py`` (reference
run_todo_merge.py); host sqlite only.

Usage:
    python -m photometry_tpu_torch.cli.todo_merge_cmd [-o] todo derived output
"""

from __future__ import annotations

import argparse
import sys

from .common import add_logging_args, setup_logging


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Merge TODO-files.")
    add_logging_args(parser)
    parser.add_argument("todo", help="Original photometry todo.sqlite")
    parser.add_argument("derived", help="Corrections-stage todo file")
    parser.add_argument("output", help="Merged output file")
    parser.add_argument("-o", "--overwrite", action="store_true")
    args = parser.parse_args(argv)
    setup_logging(args)
    from ..todo_merge import todo_merge
    print(todo_merge(args.todo, args.derived, args.output, overwrite=args.overwrite))
    return 0


if __name__ == "__main__":
    sys.exit(main())
