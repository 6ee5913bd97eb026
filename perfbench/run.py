#!/usr/bin/env python3
"""Benchmark of photometry_tpu_torch on NVIDIA cards.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of BENCHMARK.json from the root of a checkout and prints one
JSON line last on stdout (perfbench/README.md).  Exits non-zero without a
result where CUDA is missing or has fewer cards than the cell asks for,
where the program cannot be imported, and where JAX or the JAX package was
loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from perfbench import guard  # noqa: E402

guard.install()
# Build and kernel caches inside the checkout, at fixed paths (the port's
# own nvcc builds go to photometry_tpu_torch/_build/):
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, "perfbench", "_cache", sub)
os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from perfbench import bench
    wl = next((w for w in bench.spec()["workloads"] if w["name"] == args.workload), None)
    if wl is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"{args.workload} needs {wl['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 5
    import photometry_tpu_torch  # noqa: F401  (the program; a checkout without it fails here)
    work = tempfile.mkdtemp(prefix="perfbench-")       # under $TMPDIR
    try:
        result, values, run = bench.run_cell(args.workload, args.seed, args.seconds,
                                             bool(args.trace), torch.device("cuda", 0), T_START,
                                             work=work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    found = guard.loaded()
    if found:
        print(f"blocked modules were loaded: {', '.join(found)}", file=sys.stderr)
        return 4
    print(f"card: {card_line()}", file=sys.stderr)
    # what the window did, for the record (the result line comes last)
    print("run: " + json.dumps({k: v for k, v in run.items() if k not in ("config", "mix", "trace")}
                               | {"counts": {k: v for k, v in values.items()
                                             if k.startswith("n_")}}), file=sys.stderr)
    bench.emit(result)
    return 0


def card_line() -> str:
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi not readable"


if __name__ == "__main__":
    sys.exit(main())
