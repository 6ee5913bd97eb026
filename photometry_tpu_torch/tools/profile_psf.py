"""Break down the sector-scale PSF fit cost on a torch device.

The port's copy of ``tools/profile_psf.py``.  BASELINE.md config 4 (the
PSF method at sector scale: T = 1,312 cadences, table PRF, 13 px stamps,
S = 4 stars, 96-target chunks) timed in pieces, so that kernel work aims
at the real bottleneck:

  full        ``psf_fit.fit_psf_timeseries_batch`` on one chunk (phase 1 +
              phase 2); on a card the fused route, two launches of
              ``ops/csrc/psf_warm_fit.cu`` a call
  phase2      the warm-start LM over all N*T cadences alone:
              ``psf_fused.fused_warm_fit`` on the N*T instances, one
              launch of the kernel on a card (its plain version on the CPU)
  render      ``PRF.render_separable_with_grads`` over the same (N, T, S)
              extent
  lm_algebra  the normal equations (einsum) and ``solve_spd_small`` on
              random (N, T, h*w, 3S) Jacobians, one LM iteration's algebra

The PRF is the Gaussian table (``PRF.gaussian`` without its closed form),
which the fused route takes.  Inputs are drawn from a ``torch.Generator``
seeded 5 on the device.  Each timing runs one warm-up call, then ``reps``
calls between ``torch.cuda.synchronize()`` calls (on a card).  Prints one
JSON line with the JAX tool's keys, the times in seconds unrounded.

Usage: python -m photometry_tpu_torch.tools.profile_psf [--chunk 96]
       [--T 1312] [--S 4] [--side 13] [--reps 3] [--device cuda|cpu]
"""

import argparse
import json
import time

import torch

from ..device import resolve_device
from ..models.prf import PRF
from ..models.psf_fit import LM_ITERS_WARM, fit_psf_timeseries_batch
from ..models.psf_fused import fused_warm_fit
from ..ops.smallsolve import solve_spd_small

SEED = 5


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Time the pieces of the sector-scale PSF fit.")
    ap.add_argument("--chunk", type=int, default=96)
    ap.add_argument("--T", type=int, default=1312)
    ap.add_argument("--S", type=int, default=4)
    ap.add_argument("--side", type=int, default=13)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda", help="Torch device (default: cuda).")
    return ap.parse_args(argv)


def make_inputs(N: int, T: int, S: int, h: int, device) -> dict:
    """The tool's seeded problem on ``device``: N targets x T cadences of
    (h, h) stamps, S stars each, the brightest near the centre of the first
    target's star field repeated in every stamp plus noise."""
    dev = resolve_device(device)
    g = PRF.gaussian(sigma=1.1, device=dev)
    prf = PRF(g.iprf, g.oversample, g.center_x, g.center_y, info={}, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)

    rows = 6.0 + uniform((N, S), -2.0, 2.0)
    cols = 6.0 + uniform((N, S), -2.0, 2.0)
    fluxes = 1000.0 + uniform((N, S), 0.0, 4000.0)
    base = prf.integrate_to_image(torch.stack([rows[0], cols[0], fluxes[0]], 1), (h, h), 5.0)
    imgs = (base.expand(N, T, h, h) + 1.0
            + 0.5 * torch.randn((N, T, h, h), generator=gen, device=dev))
    return {"prf": prf, "imgs": imgs, "bkgs": torch.zeros_like(imgs),
            "p0": torch.cat([rows, cols, fluxes], dim=1),
            "valid": torch.ones((N, S), dtype=torch.bool, device=dev),
            "mini": torch.ones((N, h, h), dtype=torch.bool, device=dev),
            "tidx": torch.zeros(N, dtype=torch.int64, device=dev),
            "gen": gen}


def profile(argv=None):
    """Run the four timings; prints the JSON line and returns ``(summary,
    full's output, the inputs)``."""
    args = parse_args(argv)
    N, T, S, h = args.chunk, args.T, args.S, args.side
    inp = make_inputs(N, T, S, h, args.device)
    prf, imgs, bkgs, p0, valid, mini, tidx = (inp[k] for k in ("prf", "imgs", "bkgs", "p0",
                                                               "valid", "mini", "tidx"))
    dev = imgs.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def timed(fn):
        out = fn()                                  # warm-up (and the kernel's build)
        sync()
        tic = time.perf_counter()
        for _ in range(args.reps):
            out = fn()
        sync()
        return (time.perf_counter() - tic) / args.reps, out

    # --- full chunk ----------------------------------------------------------
    t_full, full = timed(lambda: fit_psf_timeseries_batch(imgs, bkgs, 1.0, p0, valid, mini,
                                                          tidx, prf, (h, h), S))

    # --- phase 2 only: the warm LM over all N*T cadences, one launch ---------
    onehot = torch.nn.functional.one_hot(tidx, S).to(torch.float32)

    def flat(a):                                    # (N, ...) -> (N*T, ...)
        return torch.repeat_interleave(a, T, dim=0)

    warm = (imgs.reshape(N * T, h, h), bkgs.reshape(N * T, h, h), 1.0, flat(p0), flat(valid),
            flat(mini), flat(onehot), prf, (h, h), S, LM_ITERS_WARM)
    t_phase2, _ = timed(lambda: fused_warm_fit(*warm))

    # --- render only: the Jacobian pieces over the same (N, T, S) extent ------
    rows_t = p0[:, None, :S].expand(N, T, S)
    cols_t = p0[:, None, S:2 * S].expand(N, T, S)

    def render_all():
        q, qr, qc = prf.render_separable_with_grads(rows_t, cols_t, (h, h), 5.0)
        return q.sum() + qr.sum() + qc.sum()

    t_render, _ = timed(render_all)

    # --- LM algebra only: normal equations + solve ---------------------------
    gen = inp["gen"]
    J = torch.randn((N, T, h * h, 3 * S), generator=gen, device=dev)
    r = torch.randn((N, T, h * h), generator=gen, device=dev)
    eye = 1e-3 * torch.eye(3 * S, device=dev)

    def lm_algebra():
        JtJ = torch.einsum("ntpi,ntpj->ntij", J, J)
        Jtr = torch.einsum("ntpi,ntp->nti", J, r)
        return solve_spd_small(JtJ + eye, Jtr).sum()

    t_alg, _ = timed(lm_algebra)
    del J, r

    summary = {
        "config": {"chunk": N, "T": T, "S": S, "side": h, "backend": str(dev)},
        "full_s": t_full,
        "targets_per_s": N / t_full,
        "phase2_s": t_phase2,
        "phase1_s_approx": max(t_full - t_phase2, 0.0),
        "render_all_s": t_render,
        "lm_algebra_1iter_s": t_alg,
        "lm_algebra_x_warm_iters_s": t_alg * LM_ITERS_WARM,
    }
    print(json.dumps(summary), flush=True)
    return summary, full, inp


def main(argv=None) -> dict:
    return profile(argv)[0]


if __name__ == "__main__":
    main()
