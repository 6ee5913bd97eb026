"""Shared CLI plumbing: logging setup, the input folder and the device.

The port's counterpart of ``photometry_tpu/cli/common.py``, without its
JAX-platform flag and compile cache: a torch entry point takes its device
from ``--device``.
"""

from __future__ import annotations

import argparse
import logging
import os


def add_logging_args(parser: argparse.ArgumentParser):
    parser.add_argument("-d", "--debug", action="store_true", help="Print debug messages.")
    parser.add_argument("-q", "--quiet", action="store_true",
                        help="Only report warnings and errors.")


def add_device_arg(parser: argparse.ArgumentParser, what: str):
    parser.add_argument("--device", default="cuda",
                        help=f"Torch device of {what} (default: cuda).")


def setup_logging(args) -> logging.Logger:
    level = logging.INFO
    if getattr(args, "quiet", False):
        level = logging.WARNING
    if getattr(args, "debug", False):
        level = logging.DEBUG
    logging.basicConfig(level=level, format="%(asctime)s - %(levelname)s - %(message)s")
    return logging.getLogger("photometry_tpu_torch")


def resolve_input_folder(arg) -> str:
    """Input folder from CLI arg or TESSPHOT_INPUT environment variable."""
    folder = arg or os.environ.get("TESSPHOT_INPUT")
    if not folder:
        raise SystemExit("Please specify an input folder (or set TESSPHOT_INPUT).")
    if not os.path.isdir(folder):
        raise SystemExit(f"Not a directory: {folder}")
    return folder
