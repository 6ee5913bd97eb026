"""
CLI: run photometry from the TODO list on the port.

Port of ``photometry_tpu/cli/photometry_cmd.py`` (reference run_tessphot.py):
select a task by --starid, --priority, --random or queue order, or drain
the whole queue with --all.  ``--method`` forces aperture, psf, linpsf or
halo; without it each task runs its own method (aperture with the automatic
halo and linPSF switches by default).  ``--plot`` renders each target's
diagnostic figures.  ``--mesh SPEC`` shards each FFI sector's cubes over
a device mesh (``time=4,targets=2``, a bare count, or ``auto``: every card
of ``--device``'s type; ``parallel/mesh.parse_mesh_spec``).  ``--cache
host`` keeps each FFI sector's cubes in host memory and streams them
through the card on every extraction, for a card that does not hold them
(``run_drain``'s ``cache``).  With
``PHOTOMETRY_TPU_TRACE_DIR`` set, the drain runs under
``utils.profiling.device_trace``: a Chrome trace of it, the program's
spans among the kernels, is written there.

Usage:
    python -m photometry_tpu_torch.cli.photometry_cmd --version 1 [options] [input_folder]
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

from .common import (add_cache_arg, add_device_arg, add_logging_args, resolve_input_folder,
                     setup_logging)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Run TESS photometry (PyTorch + CUDA).")
    add_logging_args(parser)
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
    parser.add_argument("-p", "--plot", action="store_true",
                        help="Render per-target diagnostic figures into "
                             "<output>/plots/<starid>/ (reference run_tessphot.py --plot; "
                             "needs matplotlib).")
    parser.add_argument("--mesh", default=None, metavar="SPEC",
                        help="Shard FFI cubes over a device mesh, e.g. 'time=4,targets=2' or "
                             "'auto' (every device of --device's type on the time axis).")
    add_cache_arg(parser)
    add_device_arg(parser, "the cubes and kernels")
    parser.add_argument("input_folder", nargs="?", default=None)
    args = parser.parse_args(argv)

    setup_logging(args)
    input_folder = resolve_input_folder(args.input_folder)
    output_folder = args.output or os.environ.get("TESSPHOT_OUTPUT") or input_folder

    constraints = {k: v for k, v in (("starid", args.starid), ("priority", args.priority),
                                     ("datasource", args.datasource),
                                     ("camera", args.camera), ("ccd", args.ccd))
                   if v is not None}

    mesh = None
    if args.mesh:
        from ..parallel.mesh import parse_mesh_spec
        mesh = parse_mesh_spec(args.mesh, device=args.device)
        logging.getLogger(__name__).info("Device mesh: %s", mesh)

    from ..core.drain import run_drain
    from ..utils.profiling import device_trace
    with device_trace():
        run_drain(
            input_folder, args.version,
            output_folder=output_folder,
            # None keeps the reference's default product layout under the input:
            products_folder=None if args.output is None else output_folder,
            all_tasks=args.all, random_task=args.random,
            batch_size=args.batch_size, method=args.method,
            constraints=constraints, plot=args.plot, device=args.device, mesh=mesh,
            cache=args.cache,
            summary=os.path.join(output_folder, "summary.json") if args.all else None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
