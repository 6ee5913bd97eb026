"""
CLI: several worker processes drain one todo list (the master/worker
task-pull scheduler, counterpart of run_tessphot_mpi.py).

Port of ``photometry_tpu/cli/scheduler_cmd.py``: ``--device`` takes the
place of the JAX-platform flag; ``--mesh SPEC`` makes each worker shard its
FFI cubes over a device mesh of ``--device``'s type, built in the worker;
``--cache host`` makes each worker keep them in host memory and stream
them through the card on every lease.
Exits 0 when the queue drained, 1 when tasks are left.

Usage:
    python -m photometry_tpu_torch.cli.scheduler_cmd --workers 2 --version 5 [input_folder]
    python -m photometry_tpu_torch.cli.scheduler_cmd --device cpu --workers 4 --version 5 DIR
"""

from __future__ import annotations

import argparse
import json
import sys

from .common import (add_cache_arg, add_device_arg, add_logging_args, resolve_input_folder,
                     setup_logging)

_EPILOG = """\
Each worker holds its own copy of a CCD's cubes on the card: 13 bytes a
pixel (float32 images, errors and backgrounds, uint8 flags), so 27.9 GB a
worker for a 2048x2048 CCD at T = 512 and 71.5 GB at T = 1,312 (a full
1,800-s sector).  Two workers fit on an 80 GB card at T = 512; not one
holds a full float32 sector.  With --cache host each worker keeps its cubes
in host memory instead (the host then needs their size once a worker) and
streams them through the card on every lease, in ~14 GB of card memory a
worker.  A worker that runs out of card memory, or
whose kernel fails, dies: its tasks go back to the queue, and once the
respawns are spent the command exits 1.
"""


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Distributed TESS photometry (master/worker pull scheduler, "
                    "PyTorch + CUDA).", epilog=_EPILOG,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    add_logging_args(parser)
    parser.add_argument("--workers", type=int, default=2)
    parser.add_argument("--batch-size", type=int, default=256)
    parser.add_argument("--version", type=int, required=True)
    parser.add_argument("--camera", type=int, default=None)
    parser.add_argument("--ccd", type=int, default=None)
    parser.add_argument("--datasource", default=None, choices=("ffi", "tpf"))
    parser.add_argument("-o", "--output", default=None)
    parser.add_argument("--listen", default=None, metavar="[HOST:]PORT",
                        help="Master for cross-host workers: accept --workers "
                             "TCP connections instead of spawning local ones.")
    parser.add_argument("--connect", default=None, metavar="HOST:PORT",
                        help="Run as a remote worker joining the master at "
                             "HOST:PORT (no master loop on this host).")
    parser.add_argument("--mesh", default=None, metavar="SPEC",
                        help="Run each worker's FFI extraction over a device mesh, e.g. "
                             "'time=4,targets=2' or 'auto'.")
    add_cache_arg(parser)
    add_device_arg(parser, "the workers' cubes and kernels")
    parser.add_argument("input_folder", nargs="?", default=None)
    args = parser.parse_args(argv)
    setup_logging(args)
    input_folder = resolve_input_folder(args.input_folder)

    if args.connect:
        host, port = args.connect.rsplit(":", 1)
        from ..parallel.scheduler import worker_remote
        worker_remote((host, int(port)), input_folder, output_folder=args.output,
                      version=args.version, device=args.device, mesh_spec=args.mesh,
                      cache=args.cache)
        return 0

    listen = None
    if args.listen:
        host, _, port = args.listen.rpartition(":")
        listen = (host or "0.0.0.0", int(port))

    from ..parallel.scheduler import run_distributed
    constraints = {k: v for k, v in (("camera", args.camera), ("ccd", args.ccd),
                                     ("datasource", args.datasource)) if v}
    summary = run_distributed(
        input_folder, n_workers=args.workers, version=args.version,
        output_folder=args.output, batch_size=args.batch_size, device=args.device,
        listen=listen, mesh_spec=args.mesh, cache=args.cache, **constraints)
    print(json.dumps(summary))
    return 0 if summary.get("drained", True) else 1


if __name__ == "__main__":
    sys.exit(main())
