"""
CLI: generate simulated TESS data on the port.

Port of ``photometry_tpu/cli/simulate_cmd.py`` (reference
run_simulateFITS.py): FFIs, a catalog and optional TPFs of one sector-CCD,
byte-equal to the JAX package's for the same arguments.  Host numpy only.

Usage:
    python -m photometry_tpu_torch.cli.simulate_cmd [options] output_folder
"""

from __future__ import annotations

import argparse
import sys

from .common import add_logging_args, setup_logging


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Simulate TESS FFIs/TPFs/catalog.")
    add_logging_args(parser)
    parser.add_argument("-s", "--stars", type=int, default=40)
    parser.add_argument("-t", "--times", type=int, default=48)
    parser.add_argument("--shape", type=int, default=128, help="Frame side length.")
    parser.add_argument("--sector", type=int, default=1)
    parser.add_argument("--camera", type=int, default=3)
    parser.add_argument("--ccd", type=int, default=2)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--tpf", type=int, default=0,
                        help="Also write TPFs for the N brightest stars.")
    parser.add_argument("output_folder")
    args = parser.parse_args(argv)
    setup_logging(args)

    from ..sim.simulator import SimConfig, simulate_sector
    sim = simulate_sector(SimConfig(
        sector=args.sector, camera=args.camera, ccd=args.ccd,
        shape=(args.shape, args.shape), n_times=args.times,
        n_stars=args.stars, seed=args.seed))
    sim.write_ffis(args.output_folder)
    sim.write_catalog(args.output_folder)
    for sid in sim.starid[:args.tpf]:
        sim.write_tpf(args.output_folder, int(sid))
    print(args.output_folder)
    return 0


if __name__ == "__main__":
    sys.exit(main())
