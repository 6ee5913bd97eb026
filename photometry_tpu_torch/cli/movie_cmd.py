"""
CLI: render diagnostic movies of prepared cubes (counterpart of run_ffimovie.py).

Port of ``photometry_tpu/cli/movie_cmd.py``; ``--process-id`` and
``--num-processes`` split the cube list statically between processes
(``parallel.multihost.process_shard``, also inside a ``torch.distributed``
process group).  Reads the cubes with ``h5py``, on the host.

Usage:
    python -m photometry_tpu_torch.cli.movie_cmd [--combined] [--format gif|png|mp4] DIR
"""

from __future__ import annotations

import argparse
import sys

from .common import add_logging_args, resolve_input_folder, setup_logging


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Make diagnostic movies of image cubes.")
    add_logging_args(parser)
    parser.add_argument("--dataset", default="images",
                        choices=("images", "backgrounds", "pixelflags"))
    parser.add_argument("--fps", type=int, default=10)
    parser.add_argument("--frames", type=int, default=None, help="Limit frame count.")
    parser.add_argument("--format", dest="fmt", default="gif", choices=("gif", "png", "mp4"),
                        help="mp4 needs an ffmpeg binary on PATH "
                             "(reference run_ffimovie.py writes MP4)")
    parser.add_argument("--combined", action="store_true",
                        help="Render the 16-CCD focal-plane mosaic movie "
                             "instead of per-CCD movies.")
    parser.add_argument("--sector", type=int, default=None, action="append")
    parser.add_argument("--camera", type=int, default=None, action="append")
    parser.add_argument("--ccd", type=int, default=None, action="append")
    parser.add_argument("--process-id", type=int, default=None,
                        help="This host's index in a static multi-host split "
                             "of the cube list (with --num-processes); the "
                             "reference parallelizes run_ffimovie.py over a "
                             "local pool only.")
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("input_folder", nargs="?", default=None)
    args = parser.parse_args(argv)
    setup_logging(args)
    input_folder = resolve_input_folder(args.input_folder)

    from ..io import discovery
    from ..movie import make_movie, make_combined_movie
    from ..parallel import multihost

    def shard(items):
        if args.process_id is not None or args.num_processes is not None:
            if args.process_id is None or args.num_processes is None:
                parser.error("--process-id and --num-processes go together")
            return multihost.process_shard(items, args.process_id,
                                           args.num_processes)
        if multihost.is_initialized():
            return multihost.process_shard(items)
        return items

    if args.combined:
        from ..io.cube import ImageCube
        sectors = args.sector
        if not sectors:
            sectors = sorted({ImageCube(f).header.get("SECTOR", 1)
                              for f in discovery.find_cube_files(input_folder)})
        if not sectors:
            print("No cube files found.", file=sys.stderr)
            return 1
        for sector in shard(sorted(sectors)):
            print(make_combined_movie(input_folder, int(sector),
                                      dataset=args.dataset, fps=args.fps,
                                      max_frames=args.frames, fmt=args.fmt))
        return 0
    cubes = discovery.find_cube_files(
        input_folder,
        sector=args.sector[0] if args.sector else None,
        camera=args.camera if args.camera else None,
        ccd=args.ccd if args.ccd else None)
    if not cubes:
        print("No cube files found.", file=sys.stderr)
        return 1
    for cube in shard(cubes):
        print(make_movie(cube, dataset=args.dataset, fps=args.fps,
                         max_frames=args.frames, fmt=args.fmt))
    return 0


if __name__ == "__main__":
    sys.exit(main())
