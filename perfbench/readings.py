#!/usr/bin/env python3
"""Readings that the limits of a cell's check are set from (PERF.md, section 2).

    python3 perfbench/readings.py --workload <cell> --seeds 1,2,3 --control-seeds 4,5,6 \
        --fault-seeds 7,8,9

In one process: for each seed of ``--seeds`` a sound run (set-up, one
drain at the cell's own load, the check) and for each of
``--control-seeds`` the control, each printed as one JSON line:

* ``program_bf16``, where the cell's driver has ``program_control`` (the
  program's own bfloat16 path; for the FFI drain a context of bfloat16
  planes cast from the seed's float32 draws, judged against the float32
  cube made again from the seed);
* ``reference_bf16`` (every cell): the reference on inputs rounded to
  bfloat16, put in the program's place, on the sound run's products;

and for each of ``--fault-seeds`` a run with every fault of the driver's
``faults()`` planted in the program at once (kind ``fault``): the upper
readings of the numbers that hold the products to the inputs' truth,
which no lower precision moves.

The benchmark's own runs never run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from perfbench import guard  # noqa: E402

guard.install()


def free(device):
    import torch
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def readings(name, seeds, control_seeds, device, seconds=0.0, config_override=None,
             traffic_override=None, out=sys.stdout, fault_seeds=()):
    """Yield one dict of readings per sound, control and fault seed."""
    import torch
    from perfbench import bench
    _, cfg, mix, limits = bench.cell(bench.spec(), name)
    cfg, mix = {**cfg, **(config_override or {})}, {**mix, **(traffic_override or {})}
    drv = bench.driver(mix)
    runs = [("sound", s) for s in seeds] + [("control", s) for s in control_seeds]
    runs += [("fault", s) for s in fault_seeds]
    for kind, seed in runs:
        work = tempfile.mkdtemp(prefix="perfbench-readings-")
        tic = time.perf_counter()
        try:
            rows = []
            if kind == "control" and hasattr(drv, "program_control"):
                values = drv.program_control(cfg, mix, seed, device, work, seconds)
                if values is not None:
                    rows.append(("program_bf16", values))
                free(device)
            with contextlib.ExitStack() as stack:
                if kind == "fault":
                    for plant in drv.faults().values():
                        stack.enter_context(plant())
                state = drv.setup(cfg, mix, seed, device, os.path.join(work, "run"))
                drv.window(state, seconds)
            rows.append((kind, drv.check(state)) if kind != "control" else
                        ("reference_bf16", drv.check(state, control=torch.bfloat16)))
            for what, values in rows:
                line = {"workload": name, "seed": seed, "kind": what,
                        "seconds": time.perf_counter() - tic, "values": values,
                        "pass": bench.judge(values, limits)[1]}
                print(json.dumps(line), file=out, flush=True)
                yield line
        finally:
            state = None
            shutil.rmtree(work, ignore_errors=True)
            free(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("readings need a CUDA card", file=sys.stderr)
        return 5
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = [int(s) for s in args.control_seeds.split(",") if s]
    faulty = [int(s) for s in args.fault_seeds.split(",") if s]
    list(readings(args.workload, seeds, control, torch.device("cuda", 0), fault_seeds=faulty))
    found = guard.loaded()
    if found:
        print(f"blocked modules were loaded: {', '.join(found)}", file=sys.stderr)
        return 4
    return 0


if __name__ == "__main__":
    sys.exit(main())
