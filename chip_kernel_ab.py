#!/usr/bin/env python3
"""Time the port's redesigned kernels against their first designs on one CUDA card.

The first designs of segment_hist and psf_warm_fit (a 512-thread block per
private table with one scalar sample per thread and step; a warp per PSF
instance with the normal equations in registers, a shuffle butterfly and a
per-lane Cholesky) are read from ``--first DIR``, which holds
``segment_hist.cu`` and ``psf_warm_fit.cu`` as git keeps them from before
the redesign::

    mkdir -p local/first
    for k in segment_hist psf_warm_fit; do
      git show aaf6824:photometry_tpu_torch/ops/csrc/$k.cu > local/first/$k.cu
    done

This script builds them beside the current sources in
``photometry_tpu_torch/ops/csrc/`` (one nvcc each, in parallel, the port's
flags), holds both designs to the plain versions, and times them in turns
(first, current, current, first) in this one process, at ``chip_smoke.py``'s
main shapes:

- segment_hist: 64 frames x 2^20 samples x 39 rings x 512 buckets, on
  synthetic and on real buckets (``chip_smoke.hist_cases``), beside one
  ``torch.bincount`` of the same cells;
- psf_warm_fit: 180 targets x 512 cadences of 15x15 stamps, S=5, K=3, 6
  iterations (the warm fits), and 180 instances at 12 iterations (a chunk's
  first-cadence fit);
- the PSF slice of chip_smoke's phase 4 (``extract_psf_batch`` on the 2,048
  brightest targets of its context) with either design behind the same
  wrapper: its wall, then again under torch.profiler for the kernel's
  device time and share.

Each time is the median over ``--reps`` runs of a loop of launches between
two CUDA events, divided by the loop's length; launches go straight to the
libraries with their arguments prepared once, so no wrapper's Python is
timed.  Prints one line per case, the card's name and power limit, and last
a JSON line of every time.  Exits non-zero without a CUDA card.

Usage:  python3 chip_kernel_ab.py [--first DIR] [--seed N] [--reps N]
"""

import argparse
import ctypes
import json
import os
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def loop_ms(cs, fn, reps, n):
    """chip_smoke.cuda_ms of ``n`` calls of ``fn`` in a row, per call."""
    return cs.cuda_ms(lambda: [fn() for _ in range(n)], reps=reps) / n


class _FirstDesign:
    """The first psf_warm_fit library behind the current wrapper's call,
    which passes the warps per block (the first design's blocks are fixed)."""

    def __init__(self, lib):
        self._lib = lib

    def psf_warm_fit(self, *args):
        return self._lib.psf_warm_fit(*args[:-2], args[-1])


# The ctypes signatures of the first designs' entry points.
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
_FIRST_PSF = {"psf_warm_fit": (_I, [_P] * 11 + [_L] + [_I] * 5 + [_I] * 4 + [_F] + [_I] * 4
                                + [_F] + [_I] + [_F] * 2 + [_P])}
_FIRST_HIST = {"segment_hist": (_I, [_P] * 5 + [_I, _L, _I, _I, _I, _P])}


def library(name, signatures, path):
    """The port's CudaLibrary (nvcc with its flags into its build
    directory, ctypes signatures, ptxas log) for a source outside csrc/."""
    from photometry_tpu_torch.ops._kernels import CudaLibrary
    return CudaLibrary(name, signatures, source=path)


def build(libs):
    """Build CudaLibrary objects in parallel, one nvcc each."""
    with ThreadPoolExecutor(8) as ex:
        for job in [ex.submit(lib.lib) for lib in libs]:
            job.result()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=7)
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--first", default=os.path.join(HERE, "local", "first"),
                        help="directory of the first designs' segment_hist.cu and "
                             "psf_warm_fit.cu")
    args = parser.parse_args()
    sources = {k: os.path.join(args.first, k + ".cu") for k in ("segment_hist", "psf_warm_fit")}
    missing = [p for p in sources.values() if not os.path.isfile(p)]
    if missing:
        print(f"first designs missing: {missing} (see the docstring)", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    sys.meta_path.insert(0, cs._Blocked())
    from photometry_tpu_torch.models import psf_fused
    from photometry_tpu_torch.models.prf import PRF
    from photometry_tpu_torch.models.psf_common import CUTOFF_RADIUS
    from photometry_tpu_torch.ops import seghist
    from photometry_tpu_torch.ops._kernels import PSF_WARM_FIT, SEGMENT_HIST, build_all

    dev = torch.device("cuda")
    card = cs.card_line()
    work = tempfile.mkdtemp(prefix="chip_kernel_ab_")
    tic = time.perf_counter()
    first = {"segment_hist": library("segment_hist_first", _FIRST_HIST,
                                     sources["segment_hist"]),
             "psf_warm_fit": library("psf_warm_fit_first", _FIRST_PSF,
                                     sources["psf_warm_fit"])}
    with ThreadPoolExecutor(1) as ex:
        job = ex.submit(build, first.values())
        build_all()
        job.result()
    loaded = "(loaded, built by an earlier process)"
    print(f"build: current and first designs in {time.perf_counter() - tic:.1f} s; registers/"
          f"spill stores: psf_warm_fit<S,K> current "
          f"{cs.ptxas_summary(PSF_WARM_FIT.build_log) or loaded}; "
          f"first {cs.ptxas_summary(first['psf_warm_fit'].build_log) or loaded}; segment_hist "
          f"current {cs.ptxas_regs(SEGMENT_HIST.build_log, ('segment_hist_kernel',)) or loaded}, "
          f"first {cs.ptxas_regs(first['segment_hist'].build_log, ('segment_hist_kernel',))}",
          flush=True)
    h1, p1 = first["segment_hist"].lib(), first["psf_warm_fit"].lib()
    h2, p2 = SEGMENT_HIST.lib(), PSF_WARM_FIT.lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    times = {}

    def turns(case, fns, n):
        """Time fns = {"first": f, "current": g, ...} in the order first,
        current, (others), current, first; store the medians."""
        order = ["first", "current"] + [k for k in fns if k not in ("first", "current")]
        got = {}
        for k in order + order[::-1]:
            got.setdefault(k, []).append(loop_ms(cs, fns[k], args.reps, n))
        times[case] = got
        print(f"{case}: " + "; ".join(f"{k} {' / '.join(f'{x:.4f}' for x in v)} ms"
                                      for k, v in got.items()) + f" ({card})", flush=True)

    # --- segment_hist ------------------------------------------------------------
    rng = np.random.default_rng(args.seed)
    rows, cols, tmag, img0 = cs.make_field(rng)
    seg_t, S, cases = cs.hist_cases(dev, rng, img0)
    nf, ns, nb = cs.HIST_MAIN
    counts = torch.empty(nf, S, nb, dtype=torch.int32, device=dev)
    out1 = torch.empty(nf, S, nb, device=dev)
    out2 = torch.empty(nf, S, nb, device=dev)
    resident = h2.segment_hist_resident_blocks(S, nb)
    per_frame2 = seghist.blocks_per_frame(nf, ns, resident)
    per_frame1 = max(1, min(-(-ns // 32768), -(-(4 * 132) // nf)))
    for what, b_t, good_t in cases:
        head = seghist.vector_head(seg_t.data_ptr(), b_t.data_ptr(), good_t.data_ptr(), nf, ns)
        ptrs = (seg_t.data_ptr(), b_t.data_ptr(), good_t.data_ptr())

        def v1():
            cs.check(h1.segment_hist(*ptrs, counts.data_ptr(), out1.data_ptr(), nf, ns, S, nb,
                                     per_frame1, stream) == 0, "first segment_hist launch")

        def v2():
            cs.check(h2.segment_hist(*ptrs, counts.data_ptr(), out2.data_ptr(), nf, ns, S, nb,
                                     per_frame2, head, stream) == 0, "segment_hist launch")

        ok = good_t & (seg_t >= 0)[None]
        flat = ((torch.arange(nf, device=dev)[:, None] * S + seg_t.long()[None]) * nb
                + b_t.long())[ok]
        v1(), v2()
        want = seghist.segment_histogram_plain(seg_t, b_t, good_t, S, nb)
        cs.check(torch.equal(out1, want) and torch.equal(out2, want),
                 f"segment_hist {what}: a design != plain")
        turns(f"segment_hist {what} ({nf} x {ns} x {S} x {nb}; blocks per frame: first "
              f"{per_frame1}, current {per_frame2}; head {head})",
              {"first": v1, "current": v2,
               "bincount": lambda: torch.bincount(flat, minlength=nf * S * nb)}, 20)
        del b_t, good_t, flat
    del cases, counts, out1, out2

    # --- psf_warm_fit ------------------------------------------------------------
    pm = cs.PSF_MAIN
    prf = cs.table_prf(PRF, work, pm["K"], dev)
    (bu_lo, bu_hi, L0u, Fu), (bv_lo, bv_hi, L0v, Fv) = psf_fused._kernel_tables(prf, pm["h"],
                                                                               pm["h"])
    rng_fit = np.random.default_rng([args.seed, 2])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for what, B, n_iters in (("warm fits", pm["N"] * cs.T, pm["n_iters"]),
                             ("first-cadence fit", pm["N"], 12)):
        inputs = cs.psf_instances(rng_fit, prf, B, pm["S"], pm["h"], pm["h"], n_cfg=pm["N"],
                                  nan_frac=0.001)
        img, bkg, p0, valid, mini, onehot = (torch.as_tensor(a, device=dev) for a in inputs)
        valid8, mini8 = valid.to(torch.uint8), mini.to(torch.uint8)
        outs = {k: [torch.empty(B, 3 * pm["S"], device=dev), torch.empty(B, device=dev),
                    torch.empty(B, device=dev)] for k in ("first", "current")}

        def call(lib, k, extra):
            head_args = [img.data_ptr(), bkg.data_ptr(), mini8.data_ptr(), p0.data_ptr(),
                         valid8.data_ptr(), onehot.data_ptr(), Fu.data_ptr(), Fv.data_ptr(),
                         *(o.data_ptr() for o in outs[k]), B, pm["h"], pm["h"], pm["S"],
                         Fu.shape[1], int(round(prf.oversample)), bu_lo, bu_hi, L0u, Fu.shape[0],
                         prf.center_y, bv_lo, bv_hi, L0v, Fv.shape[0], prf.center_x, n_iters,
                         1.0, CUTOFF_RADIUS, *extra, stream]
            return lambda: cs.check(lib.psf_warm_fit(*head_args) == 0, f"{k} psf launch")

        fns = {"first": call(p1, "first", []),
               "current": call(p2, "current", [psf_fused.warps_per_block(B, sms)])}
        fns["first"](), fns["current"]()
        want = psf_fused.fused_warm_fit_plain(img, bkg, 1.0, p0, valid, mini, onehot, prf,
                                              (pm["h"], pm["h"]), pm["S"], n_iters)
        for k in fns:
            cs.psf_fit_check(dict(zip(("params", "flux_ap", "fluxvar_target"), outs[k])), want,
                             inputs[3], pm["S"], "crowded", f"{k} design, {what}")
        turns(f"psf_warm_fit {what} ({B} instances of {pm['h']}x{pm['h']}, S={pm['S']}, "
              f"K={pm['K']}, {n_iters} iterations)", fns, 3 if B > 1000 else 20)

    # --- the PSF slice (chip_smoke phase 4) with either design ---------------------
    del img, bkg, p0, valid, mini, onehot, valid8, mini8, outs, want, inputs
    from photometry_tpu_torch.models import psf_fit
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    _, _, ctx = cs.photometry_context(work, rows, cols, tmag, cs.make_cubes(img0, gen, dev), dev)
    ctx._context_prf = prf                     # as psf_common.context_prf memoizes it
    sids = list(range(1, cs.N_PSF + 1))        # the brightest (tmag sorted)
    walls = {}
    for design in ("first", "current", "current", "first"):
        with mock.patch.object(PSF_WARM_FIT, "_lib", p2 if design == "current"
                               else _FirstDesign(p1)):
            torch.cuda.synchronize()
            tic = time.perf_counter()
            psf_fit.extract_psf_batch(ctx, sids)
            torch.cuda.synchronize()
            walls.setdefault(design, []).append((time.perf_counter() - tic) * 1e3)
            cs.psf_profile(ctx, sids, walls[design][-1] / 1e3, card,
                           f"PSF slice, {design} design")
    times["psf slice wall"] = walls
    print(f"PSF slice of {cs.N_PSF} targets: wall " + "; ".join(
        f"{k} {' / '.join(f'{x:.1f}' for x in v)} ms" for k, v in walls.items())
          + f" ({card})", flush=True)

    print(card)
    print(json.dumps({"card": card, "times_ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
