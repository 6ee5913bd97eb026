#!/usr/bin/env python3
"""Registration time and peak memory against the frame sub-batch, on one CUDA card.

Registers 32 frames of 2048x2048 (chip_smoke.py's star field with fresh
noise) against the first with ``MotionModel.calc_kernels_batch`` at several
values of ``core.motion.ECC_BUDGET_BYTES``, the device bytes a sub-batch of
frames may hold, and prints for each the sub-batch, the wall, the
milliseconds per frame and Gauss-Newton step, and the peak memory above what
was held.  This is the measurement behind the budget's value.  The first
budget is run twice, first and last, to show the spread between runs.

Usage:  python3 chip_ecc_budget.py [--frames N]
"""

import argparse
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
BUDGETS = (8e9, 4e9, 16e9, 8e9)
N_ITERS = 50


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--frames", type=int, default=32)
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from photometry_tpu_torch.core import motion
    from photometry_tpu_torch.core.motion import MotionModel

    dev = torch.device("cuda")
    card = cs.card_line()
    _, _, _, img0 = cs.make_field(np.random.default_rng(7))
    H, W = img0.shape
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    frames = torch.as_tensor(img0, device=dev)[None].repeat(args.frames, 1, 1)
    frames += 5.0 * torch.randn(frames.shape, device=dev, generator=gen)
    MotionModel("translation", frames[0]).calc_kernels_batch(frames[:2], n_iters=2, device=dev)
    for budget in BUDGETS:
        motion.ECC_BUDGET_BYTES = budget
        sub = min(args.frames, motion.ecc_sub_batch(H, W, "translation"))
        mm = MotionModel("translation", frames[0])
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        tic = time.perf_counter()
        kern = mm.calc_kernels_batch(frames, n_iters=N_ITERS, device=dev)
        wall = time.perf_counter() - tic
        peak = torch.cuda.max_memory_allocated() - base
        step_ms = wall / (args.frames * N_ITERS) * 1e3
        print(f"budget {budget / 1e9:.0f} GB: sub-batch {sub} frames of {H}x{W}; "
              f"{args.frames} frames in {wall:.3f} s = {step_ms:.4f} ms per frame-step; peak "
              f"{peak / 1e9:.3f} GB above the {base / 1e9:.3f} GB held = "
              f"{peak / (sub * 4 * H * W):.1f} float32 planes per frame; max |kernel| "
              f"{np.abs(kern).max():.4f} px ({card})", flush=True)
        if not np.abs(kern).max() < 0.05:
            print("FAIL: kernels of motionless frames above 0.05 px", flush=True)
            return 1
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
