#!/usr/bin/env python3
"""What the streamed host path (``cache="host"``) rests on, on the card's machine.

Prints the card's name and power limit, the host's memory and memlock
limit, and the rates a chunk pipeline between host and card can reach:
host-to-device and device-to-host copies from pinned and from pageable
memory (4 GiB), the host's own copy from pageable into pinned memory at 1,
4 and 8 threads, the cost of pinning 16 GiB of pageable memory in place
(cudaHostRegister) and the copy rate from it, and of allocating 16 GiB
pinned; then whether the native host runtime builds and links libdeflate.
Medians of 5 timed copies after one warm-up, host clock around a
synchronize.  Needs one CUDA card; exits non-zero without one.

Usage:  python3 chip_host_probe.py
"""

import os
import subprocess
import sys
import time


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"{sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{os.cpu_count()} cores, {torch.get_num_threads()} torch threads; {card}", flush=True)
    with open("/proc/meminfo") as fh:
        print("".join(ln for ln in fh if ln.split(":")[0] in ("MemTotal", "MemAvailable")),
              end="", flush=True)
    print("memlock limit:", subprocess.run("ulimit -l", shell=True, capture_output=True,
                                           text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")

    def rate(label, src, dst, reps=5):
        dst.copy_(src, non_blocking=True)
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            tic = time.perf_counter()
            dst.copy_(src, non_blocking=True)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - tic)
        med = sorted(times)[len(times) // 2]
        gb = src.numel() * src.element_size() / 1e9
        print(f"{label}: {gb:.2f} GB, median {med * 1e3:.1f} ms = {gb / med:.1f} GB/s "
              f"({card})", flush=True)

    n = 1 << 30                                   # 4 GiB of float32
    d = torch.empty(n, device=dev)
    tic = time.perf_counter()
    p = torch.empty(n, pin_memory=True)
    print(f"pinned allocation of 4 GiB: {time.perf_counter() - tic:.2f} s", flush=True)
    p.fill_(1.0)
    rate("host-to-device from pinned", p, d)
    rate("device-to-host into pinned", d, p)
    q = torch.empty(n)
    q.fill_(1.0)
    rate("host-to-device from pageable", q, d)
    rate("device-to-host into pageable", d, q)
    for threads in (1, 4, 8):
        torch.set_num_threads(threads)
        rate(f"host copy pageable -> pinned, {threads} threads", q, p)
    torch.set_num_threads(os.cpu_count())
    big = torch.empty(4 * n)                      # 16 GiB pageable
    tic = time.perf_counter()
    big.fill_(2.0)
    print(f"first touch of 16 GiB: {time.perf_counter() - tic:.2f} s", flush=True)
    cudart = torch.cuda.cudart()
    tic = time.perf_counter()
    rc = cudart.cudaHostRegister(big.data_ptr(), big.numel() * 4, 0)
    print(f"cudaHostRegister of 16 GiB: rc {rc}, {time.perf_counter() - tic:.2f} s, "
          f"is_pinned {big.is_pinned()}", flush=True)
    rate("host-to-device from registered", big[:n], d)
    tic = time.perf_counter()
    cudart.cudaHostUnregister(big.data_ptr())
    print(f"cudaHostUnregister: {time.perf_counter() - tic:.2f} s", flush=True)
    del big
    tic = time.perf_counter()
    p2 = torch.empty(4 * n, pin_memory=True)
    print(f"pinned allocation of 16 GiB: {time.perf_counter() - tic:.2f} s", flush=True)
    del p2
    from photometry_tpu_torch import native_ops
    print(f"native host runtime: loaded {native_ops.native_available()}, libdeflate linked "
          f"{native_ops.libdeflate_linked()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
