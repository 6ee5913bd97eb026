#!/usr/bin/env python3
"""Time the port's redesigned kernels against the designs they replaced on one CUDA card.

The earlier designs are read from ``--first DIR``, as git keeps them from
before each redesign; the script times every pair whose earlier source it
finds there::

    mkdir -p local/first
    for k in median15 band_extract; do          # redesigned after b07d001
      git show b07d001:photometry_tpu_torch/ops/csrc/$k.cu > local/first/$k.cu
    done
    for k in segment_hist psf_warm_fit; do      # redesigned after aaf6824
      git show aaf6824:photometry_tpu_torch/ops/csrc/$k.cu > local/first/$k.cu
    done
    git show 1ae214a:photometry_tpu_torch/ops/csrc/stamp_flux.cu \
        > local/first/stamp_flux.cu                 # redesigned after 1ae214a

It builds them beside the current sources in ``photometry_tpu_torch/ops/csrc/``
(one nvcc each, in parallel, the port's flags), holds both designs to the
plain versions, and times them in turns (first, current, current, first) in
this one process, at ``chip_smoke.py``'s main shapes:

- median15 (the first design bisects each pixel's keys alone): (8, 2048,
  2048) frames of chip_smoke's phase 2c, and one 64-frame prepare chunk of
  residual-like frames (phase 3's star field with fresh noise, no sky),
  bit for bit against each other and against the plain version at 8 frames;
- band_extract (the first design: a warp per cadence over each target's
  bounding box): chip_smoke's phase 2 main shape (1,024 targets of 17x17,
  30% masks, on the (512, 2048, 2048) cube), and the main path's own launch
  (the 10,240 targets of phase 3's ``extract_aperture_batch``, its masks,
  windows and corners recorded from that call);
- stamp_flux (the first design: a block per target and 64 cadences, a warp
  per cadence over the target's pixel offsets): chip_smoke's phase 2d main
  shape (the 10,240 targets of phase 3, one 17x17 window each with its K2P2
  mask, on the (512, 2048, 2048) cube), in turns: the first design on the
  caller's order, the first design on frame order, the current design (on
  frame order, as its wrapper launches it) twice; then both behind
  ``stamp_flux_cuda``, which sorts the targets and puts the rows back;
- segment_hist: 64 frames x 2^20 samples x 39 rings x 512 buckets, on
  synthetic and on real buckets (``chip_smoke.hist_cases``), beside one
  ``torch.bincount`` of the same cells;
- psf_warm_fit: 180 targets x 512 cadences of 15x15 stamps, S=5, K=3, 6
  iterations (the warm fits), and 180 instances at 12 iterations (a chunk's
  first-cadence fit), then the PSF slice of chip_smoke's phase 4
  (``extract_psf_batch`` on the 2,048 brightest targets of its context) with
  either design behind the same wrapper: its wall, then again under
  torch.profiler for the kernel's device time and share.

Each time is the median over ``--reps`` runs of a loop of launches between
two CUDA events, divided by the loop's length; launches go straight to the
libraries with their arguments prepared once, so no wrapper's Python is
timed.  Prints one line per case, the card's name and power limit, and last
a JSON line of every time.  Exits non-zero without a CUDA card or without
any earlier design.

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
_FIRST_MEDIAN = {"median15": (_I, [_P] * 2 + [_I] * 3 + [_P])}
_FIRST_BAND = {"band_extract_sums": (_I, [_P] * 9 + [_I] * 6 + [_P])}
_FIRST_STAMP = {"stamp_flux": (_I, [_P] * 5 + [_I] * 6 + [_P]), "stamp_flux_max_pixels": (_I, [])}
SIGNATURES = {"segment_hist": _FIRST_HIST, "psf_warm_fit": _FIRST_PSF,
              "median15": _FIRST_MEDIAN, "band_extract": _FIRST_BAND,
              "stamp_flux": _FIRST_STAMP}


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
                        help="directory of the earlier designs' sources (see the docstring)")
    args = parser.parse_args()
    sources = {k: os.path.join(args.first, k + ".cu") for k in SIGNATURES}
    sources = {k: p for k, p in sources.items() if os.path.isfile(p)}
    if not sources:
        print(f"no earlier design in {args.first} (see the docstring)", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    sys.meta_path.insert(0, cs._Blocked())
    from photometry_tpu_torch.ops._kernels import (BAND_EXTRACT, MEDIAN15, PSF_WARM_FIT,
                                                   SEGMENT_HIST, STAMP_FLUX, build_all)

    dev = torch.device("cuda")
    card = cs.card_line()
    work = tempfile.mkdtemp(prefix="chip_kernel_ab_")
    tic = time.perf_counter()
    first = {k: library(f"{k}_first", SIGNATURES[k], p) for k, p in sources.items()}
    with ThreadPoolExecutor(1) as ex:
        job = ex.submit(build, list(first.values()))
        build_all()
        job.result()
    loaded = "(loaded, built by an earlier process)"
    current = {"segment_hist": SEGMENT_HIST, "psf_warm_fit": PSF_WARM_FIT, "median15": MEDIAN15,
               "band_extract": BAND_EXTRACT, "stamp_flux": STAMP_FLUX}
    names = {"segment_hist": ("segment_hist_kernel",), "median15": ("median15_kernel",),
             "band_extract": ("band_extract_kernel",), "stamp_flux": ("stamp_flux_kernel",)}
    regs = []
    for k, lib in first.items():
        if k == "psf_warm_fit":
            now, then = cs.ptxas_summary(PSF_WARM_FIT.build_log), cs.ptxas_summary(lib.build_log)
        else:
            now = cs.ptxas_regs(current[k].build_log, names[k])
            then = cs.ptxas_regs(lib.build_log, names[k])
        regs.append(f"{k} current {now or loaded}, first {then or loaded}")
    print(f"build: current and first designs in {time.perf_counter() - tic:.1f} s; registers/"
          f"spill stores: " + "; ".join(regs), flush=True)
    stream = torch.cuda.current_stream(dev).cuda_stream
    times = {}

    def turns(case, fns, n, order=None):
        """Time fns = {"first": f, "current": g, ...} in ``order`` (first,
        current, the others), then in reverse; store the medians."""
        order = order or ["first", "current"] + [k for k in fns if k not in ("first", "current")]
        got = {}
        for k in order + order[::-1]:
            got.setdefault(k, []).append(loop_ms(cs, fns[k], args.reps, n))
        times[case] = got
        print(f"{case}: " + "; ".join(f"{k} {' / '.join(f'{x:.4f}' for x in v)} ms"
                                      for k, v in got.items()) + f" ({card})", flush=True)

    rng = np.random.default_rng(args.seed)
    rows, cols, tmag, img0 = cs.make_field(rng)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)

    # --- median15 ----------------------------------------------------------------
    if "median15" in first:
        from photometry_tpu_torch.ops import median15 as m15
        m1, m2 = first["median15"].lib(), MEDIAN15.lib()
        nf, H, W = cs.MEDIAN_MAIN
        x8 = 100.0 + 30.0 * torch.randn(nf, H, W, device=dev, generator=gen)
        idx = torch.randint(0, x8.numel(), (4000,), device=dev, generator=gen)
        x8.view(-1)[idx] = torch.finfo(torch.float32).max
        base = torch.as_tensor(img0, device=dev)
        sigma = torch.sqrt(torch.clamp(base, min=0.0) + 25.0)
        x64 = base + sigma * torch.randn(64, H, W, device=dev, generator=gen)
        for what, x in ((f"phase 2c frames {tuple(x8.shape)}", x8),
                        (f"one prepare chunk of residual-like frames {tuple(x64.shape)}", x64)):
            outs = {k: torch.empty_like(x) for k in ("first", "current")}

            def call(lib, k, x=x, outs=outs):
                return lambda: cs.check(lib.median15(x.data_ptr(), outs[k].data_ptr(),
                                                     *x.shape, stream) == 0, f"{k} median launch")

            fns = {"first": call(m1, "first"), "current": call(m2, "current")}
            fns["first"](), fns["current"]()
            torch.cuda.synchronize()
            cs.check(cs.bit_equal(outs["first"], outs["current"]),
                     f"median15 {what}: the designs differ")
            if x.shape[0] <= 8:
                cs.check(cs.bit_equal(outs["current"], m15.median_filter_plain(x)),
                         f"median15 {what}: current != plain")
            turns(f"median15 {what}, bit-equal", fns, 3 if x.shape[0] <= 8 else 1)
        del x8, x64, outs, base, sigma

    # --- the photometry cube (band_extract, the PSF slice) --------------------------
    ctx = captured = results = None
    if first.keys() & {"band_extract", "psf_warm_fit", "stamp_flux"}:
        from photometry_tpu_torch.core.engine import extract_aperture_batch
        from photometry_tpu_torch.ops import bandext
        cube = cs.make_cubes(img0, gen, dev)
        _, _, ctx = cs.photometry_context(work, rows, cols, tmag, cube, dev)
    if "band_extract" in first:
        captured = []
        band_sums = bandext.band_sums

        def recording(*a, **kw):
            captured.append(a[:7] + (a[7] if len(a) > 7 else kw.get("windows"),))
            return band_sums(*a, **kw)

        with mock.patch.object(bandext, "band_sums", recording):
            results = extract_aperture_batch(ctx, list(range(1, cs.N_TARGETS + 1)))
        b1 = first["band_extract"].lib()
        hw = 17
        rng_b = np.random.default_rng([args.seed, 3])
        r0s = rng_b.integers(0, cs.H - hw, cs.N_PLAIN).astype(np.int32)
        c0s = rng_b.integers(0, cs.W - hw, cs.N_PLAIN).astype(np.int32)
        masks = rng_b.uniform(size=(cs.N_PLAIN, hw, hw)) < 0.3
        phase2 = tuple(cube) + tuple(torch.as_tensor(a, device=dev) for a in (masks, r0s, c0s))
        for what, (im, er, bk, fl, mk, r0, c0, win) in (
                (f"phase 2 main shape ({cs.N_PLAIN} targets {hw}x{hw})", phase2 + (None,)),
                (f"the main path's launch ({captured[0][4].shape[0]} targets "
                 f"{captured[0][4].shape[1]}x{captured[0][4].shape[2]})", captured[0])):
            T_ = im.shape[0]
            launch_args = ((im, er, bk, fl), mk, r0, c0, win)
            v1, out1 = cs.band_launcher(*launch_args, lib=b1)
            v2, out2 = cs.band_launcher(*launch_args)
            v1(), v2()
            want = bandext.band_sums_plain(im, er, bk, fl, mk, r0, c0, win)
            e1 = cs.band_sums_err(out1, want, f"first band design, {what}")
            e2 = cs.band_sums_err(out2, want, f"current band design, {what}")
            bound = cs.band_bytes(mk.cpu().numpy(), T_, None if win is None
                                  else win.cpu().numpy()) / cs.PEAK_BYTES * 1e3
            fns = {"first": v1, "current": v2}
            turns(f"band_extract {what}, T={T_}, kernel alone (vs plain: first {e1:.3g}, "
                  f"current {e2:.3g}; bytes bound {bound:.3f} ms)", fns, 10)
            # The same through band_sums_cuda (its layout work, targets in frame order):
            fns = {}
            for k, lib in (("first", b1), ("current", BAND_EXTRACT.lib())):
                def wrapped(lib=lib):
                    with mock.patch.object(BAND_EXTRACT, "_lib", lib):
                        bandext.band_sums_cuda(im, er, bk, fl, mk, r0, c0, win)
                fns[k] = wrapped
            turns(f"band_extract {what}, T={T_}, through band_sums_cuda",
                  fns, 10)
        del phase2, out1, out2, want, captured, v1, v2

    # --- stamp_flux ----------------------------------------------------------------
    if "stamp_flux" in first:
        stamp_ab(cs, dev, cube[0], results or extract_aperture_batch(
            ctx, list(range(1, cs.N_TARGETS + 1))), rows, cols, first["stamp_flux"].lib(),
                 STAMP_FLUX, turns)

    # --- segment_hist --------------------------------------------------------------
    if "segment_hist" in first:
        from photometry_tpu_torch.ops import seghist
        h1, h2 = first["segment_hist"].lib(), SEGMENT_HIST.lib()
        seg_t, S, cases = cs.hist_cases(dev, rng, img0)
        nf, ns, nb = cs.HIST_MAIN
        counts = torch.empty(nf, S, nb, dtype=torch.int32, device=dev)
        out1 = torch.empty(nf, S, nb, device=dev)
        out2 = torch.empty(nf, S, nb, device=dev)
        resident = h2.segment_hist_resident_blocks(S, nb)
        per_frame2 = seghist.blocks_per_frame(nf, ns, resident)
        per_frame1 = max(1, min(-(-ns // 32768), -(-(4 * 132) // nf)))
        for what, b_t, good_t in cases:
            head = seghist.vector_head(seg_t.data_ptr(), b_t.data_ptr(), good_t.data_ptr(), nf,
                                       ns)
            ptrs = (seg_t.data_ptr(), b_t.data_ptr(), good_t.data_ptr())

            def v1():
                cs.check(h1.segment_hist(*ptrs, counts.data_ptr(), out1.data_ptr(), nf, ns, S,
                                         nb, per_frame1, stream) == 0, "first segment_hist launch")

            def v2():
                cs.check(h2.segment_hist(*ptrs, counts.data_ptr(), out2.data_ptr(), nf, ns, S,
                                         nb, per_frame2, head, stream) == 0,
                         "segment_hist launch")

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

    # --- psf_warm_fit ----------------------------------------------------------------
    if "psf_warm_fit" in first:
        psf_ab(cs, args, dev, work, first["psf_warm_fit"].lib(), PSF_WARM_FIT, ctx, stream,
               card, times, turns)

    print(card)
    print(json.dumps({"card": card, "times_ms": times}))
    return 0


def stamp_ab(cs, dev, images, results, rows, cols, s1, STAMP_FLUX, turns):
    """stamp_flux's two designs at phase 2d's main shape, alone and behind
    stamp_flux_cuda, each held to the plain version and run twice bit-equal."""
    import torch
    from photometry_tpu_torch.ops import bandext
    from photometry_tpu_torch.ops import stamp_flux as sf
    T_, H_, W_ = images.shape
    masks, r0s, c0s = cs.stamp_windows(results, rows, cols, H_, W_)
    m_t, r_t, c_t = (torch.as_tensor(a, device=dev) for a in (masks, r0s, c0s))
    order = bandext._frame_order(r_t, c_t, W_)
    want = sf.stamp_flux_plain(images, m_t, r_t, c_t)
    sorted_args = (m_t[order], r_t[order], c_t[order])
    launchers = {"first": cs.stamp_launcher(images, m_t, r_t, c_t, lib=s1),
                 "first, frame order": cs.stamp_launcher(images, *sorted_args, lib=s1),
                 "current": cs.stamp_launcher(images, *sorted_args)}
    errs = {}
    for k, (launch, out) in launchers.items():
        launch()
        torch.cuda.synchronize()
        got = out.clone() if k == "first" else torch.empty_like(out).index_copy_(0, order, out)
        launch()
        torch.cuda.synchronize()
        cs.check(cs.bit_equal(got if k == "first" else got[order], out),
                 f"stamp_flux {k} design: two runs differ")
        errs[k] = cs.stamp_err(got, want, f"stamp_flux {k} design")
    bound = cs.stamp_bytes(masks, T_) / cs.PEAK_BYTES * 1e3
    sector = cs.stamp_sector_bytes(masks, r0s, c0s, T_, W_, H_) / cs.PEAK_BYTES * 1e3
    what = (f"stamp_flux phase 2d main shape ({len(masks)} targets, 17x17 windows, T={T_}; "
            f"bounds {bound:.4f} ms by bytes, {sector:.4f} ms by 32-byte sectors)")
    turns(f"{what}, kernel alone (vs plain: "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()) + ")",
          {k: launch for k, (launch, _) in launchers.items()}, 10,
          order=["first", "first, frame order", "current"])
    wrapped = {}
    for k, lib in (("first", s1), ("current", STAMP_FLUX.lib())):
        def call(lib=lib):
            with mock.patch.object(STAMP_FLUX, "_lib", lib):
                sf.stamp_flux_cuda(images, m_t, r_t, c_t)
        wrapped[k] = call
    turns(f"{what}, through stamp_flux_cuda (frame order)", wrapped, 10)


def psf_ab(cs, args, dev, work, p1, PSF_WARM_FIT, ctx, stream, card, times, turns):
    """psf_warm_fit's two designs at the main shapes, then the PSF slice with each."""
    import torch
    from photometry_tpu_torch.models import psf_fit, psf_fused
    from photometry_tpu_torch.models.prf import PRF
    from photometry_tpu_torch.models.psf_common import CUTOFF_RADIUS
    p2 = PSF_WARM_FIT.lib()
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
        del img, bkg, p0, valid, mini, onehot, valid8, mini8, outs, want, inputs

    # The PSF slice (chip_smoke phase 4) with either design:
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


if __name__ == "__main__":
    sys.exit(main())
