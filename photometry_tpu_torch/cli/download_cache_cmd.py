"""
CLI: pre-populate the caches a fleet of workers shares.

Port of ``photometry_tpu/cli/download_cache_cmd.py`` (reference
run_download_cache.py): ``download_cache.download_cache``, which fetches
the ephemeris from a configured URL or writes a synthetic one; prints the
cache file's path.  Host only.

Usage:
    python -m photometry_tpu_torch.cli.download_cache_cmd [--testing]
"""

from __future__ import annotations

import argparse
import sys

from .common import add_logging_args, setup_logging


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Download/generate worker caches.")
    add_logging_args(parser)
    parser.add_argument("-t", "--testing", action="store_true",
                        help="Only cover the test sectors (1 and 27).")
    args = parser.parse_args(argv)
    setup_logging(args)
    from ..download_cache import download_cache
    print(download_cache(testing=args.testing))
    return 0


if __name__ == "__main__":
    sys.exit(main())
