#!/usr/bin/env python3
"""Smoke run of photometry_tpu_torch on one CUDA card.

Drives the port's FFI aperture path through the entry points a user calls,
with JAX and h5py blocked from import:

1. device: the card's name and power limit; the band-extraction kernel is
   built with nvcc for sm_90a from ``photometry_tpu_torch/ops/csrc/``.
2. kernel vs its plain torch version on the card: adversarial inputs (NaN
   pixels, an all-zero frame, NaN err/background, shenanigans flags, stamps
   straddling 64x128 cells), then the main path's shape (2048x2048 CCD,
   T=512, 1,024 targets of 17x17 and 33x33) with median times.
3. the slice at full CCD size: a seeded 12,000-star field (Tmag 7.5-13),
   cubes on the card (T=512, ~28 GB), ``SectorContext.from_arrays``,
   ``extract_aperture_batch`` on the 10,240 brightest targets (the kernel's
   launch count must rise), 1,024 of them re-extracted by the plain path,
   then ``photometry_batch`` on one 256-task lease with products read back.

Prints a JSON line of per-kernel results, the card's name and power limit,
and last ``{"ok": true, "device": {...}}``.  Exits non-zero on any failure,
without a result, and when no CUDA card is present.

Usage:  python3 chip_smoke.py [--seed N]
"""

import argparse
import importlib.abc
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
RTOL, ATOL = 1e-4, 1e-3        # float32 sums in another order (tests/test_bandext.py:41)
H = W = 2048
T = 512                        # sector T=1312 needs ~72 GB of cubes: cut to fit one card
N_STARS, N_TARGETS, N_PLAIN, N_LEASE = 12000, 10240, 1024, 256
KERNEL_SOURCE = "photometry_tpu_torch/ops/csrc/band_extract.cu"
REPLACES = "photometry_tpu/ops/bandext.py:258"


class _Blocked(importlib.abc.MetaPathFinder):
    """Refuse jax, jaxlib and h5py: the port must run without them."""

    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "h5py"):
            raise ImportError(f"{name} is blocked in the smoke run")
        return None


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=5):
    """Median milliseconds of ``fn()`` on the card (CUDA events, after one warm-up)."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def max_err(got, want, what):
    """Max |got - want| of the extraction outputs; fails outside RTOL/ATOL."""
    worst = 0.0
    for name, a, b in zip(["flux", "ferr", "fbkg", "cent", "shen"], got, want):
        a, b = np.asarray(a), np.asarray(b)
        if b.dtype == bool:
            check(np.array_equal(a, b), f"{what}: {name} differs")
            continue
        check(np.array_equal(np.isnan(a), np.isnan(b)), f"{what}: {name} NaN pattern differs")
        fin = ~np.isnan(b)
        d = np.abs(a[fin] - b[fin])
        check(bool(np.all(d <= ATOL + RTOL * np.abs(b[fin]))),
              f"{what}: {name} off by up to {d.max():.3g}")
        worst = max(worst, float(d.max()) if d.size else 0.0)
    return worst


def host(xs):
    return [x.cpu().numpy() for x in xs]


def adversarial_inputs(rng, T=16, H=128, W=256, N=14, h=17, w=17):
    imgs = rng.normal(100, 5, (T, H, W)).astype(np.float32)
    imgs[1, 10, 10] = np.nan
    imgs[3] = 0.0
    errs = (np.sqrt(np.abs(imgs)) + 1.0).astype(np.float32)
    errs[2, 20, 20] = np.nan
    bkgs = rng.normal(20, 1, (T, H, W)).astype(np.float32)
    bkgs[4, 30, 30] = np.nan
    flags = (rng.uniform(size=(T, H, W)) < 0.01).astype(np.uint8) * 4
    r0s = rng.integers(0, H - h, N).astype(np.int32)
    c0s = rng.integers(0, W - w, N).astype(np.int32)
    r0s[:3], c0s[:3] = [56, 10, 63], [120, 112, 127]       # across 64x128 cell edges
    masks = rng.uniform(size=(N, h, w)) < 0.4
    masks[:, h // 2, w // 2] = True
    return imgs, errs, bkgs, flags, masks, r0s, c0s


def make_field(rng):
    """Seeded sum-image star field (bench.make_field): rows, cols, tmag, image."""
    rows = rng.uniform(10, H - 10, N_STARS)
    cols = rng.uniform(10, W - 10, N_STARS)
    tmag = np.sort(rng.uniform(7.5, 13.0, N_STARS))
    flux = np.clip(10 ** (-0.4 * (tmag - 20.451)), 0, None)
    img0 = rng.normal(0.0, 1.5, (H, W)).astype(np.float32)
    win = 7
    yy, xx = np.mgrid[-win:win + 1, -win:win + 1]
    for r, c, f in zip(rows, cols, flux):
        ri, ci = int(r), int(c)
        g = f * np.exp(-0.5 * ((yy + ri - r) ** 2 + (xx + ci - c) ** 2) / 1.2 ** 2)
        g *= 1.0 / (2 * np.pi * 1.2 ** 2)
        r0, r1 = max(ri - win, 0), min(ri + win + 1, H)
        c0, c1 = max(ci - win, 0), min(ci + win + 1, W)
        img0[r0:r1, c0:c1] += g[(r0 - ri + win):(r1 - ri + win), (c0 - ci + win):(c1 - ci + win)]
    return rows, cols, tmag, img0


def make_cubes(img0, gen, dev):
    """(T, H, W) images, err, background, flags on the card, made there in T-chunks."""
    import torch
    base = torch.as_tensor(img0, device=dev)
    sigma = torch.sqrt(torch.clamp(base, min=0.0) + 25.0)
    images = torch.empty(T, H, W, device=dev)
    errs = torch.empty(T, H, W, device=dev)
    bkgs = torch.empty(T, H, W, device=dev)
    flags = torch.empty(T, H, W, device=dev, dtype=torch.uint8)
    for t0 in range(0, T, 64):
        n = min(64, T - t0)
        images[t0:t0 + n] = base + sigma * torch.randn(n, H, W, device=dev, generator=gen)
        errs[t0:t0 + n] = sigma
        bkgs[t0:t0 + n] = 20.0 + torch.randn(n, H, W, device=dev, generator=gen)
        flags[t0:t0 + n] = (torch.rand(n, H, W, device=dev, generator=gen) < 1e-4).to(torch.uint8) * 4
    for cube in (images, errs, bkgs):            # scattered NaN pixels
        idx = torch.randint(0, T * H * W, (2000,), device=dev, generator=gen)
        cube.view(-1)[idx] = float("nan")
    return images, errs, bkgs, flags


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=7)
    args = parser.parse_args()
    try:
        import torch
    except ImportError:
        print("torch is not importable", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA card: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "photometry_tpu_torch")):
        print("photometry_tpu_torch/ not found beside chip_smoke.py", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    present = {m: importlib.util.find_spec(m) is not None for m in ("jax", "h5py")}
    sys.meta_path.insert(0, _Blocked())
    print(f"phase 0 imports: jax and h5py blocked (installed here: {present})", flush=True)

    from photometry_tpu.catalog import make_catalog_from_arrays
    from photometry_tpu.core.status import STATUS
    from photometry_tpu.io import fits as pf
    from photometry_tpu_torch.core.dispatcher import photometry_batch
    from photometry_tpu_torch.core.engine import (SectorContext, extract_aperture_batch,
                                                  extract_flux_core)
    from photometry_tpu_torch.io.wcs import TanWCS
    from photometry_tpu_torch.ops import bandext
    from photometry_tpu_torch.ops._kernels import BAND_EXTRACT

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"phase 1 device: {card}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    BAND_EXTRACT.lib()
    print(f"phase 1 build: {KERNEL_SOURCE} -> sm_90a in {BAND_EXTRACT.build_seconds:.2f} s",
          flush=True)

    # --- phase 2: kernel vs plain -----------------------------------------
    rng = np.random.default_rng(args.seed)
    arrs = adversarial_inputs(rng)
    t_args = [torch.as_tensor(a, device=dev) for a in arrs]
    h, w = arrs[4].shape[1:]
    win = torch.zeros_like(t_args[4])
    win[:, 1:-1, 2:] = True
    for windows in (None, win):
        got = host(bandext.band_extract_flux_batch(*t_args, h, w, windows=windows))
        want = host(extract_flux_core(*t_args, h, w, windows=windows))
        err = max_err(got, want, "adversarial")
    print(f"phase 2 adversarial: kernel == plain (max |diff| {err:.3g})", flush=True)

    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    rows, cols, tmag, img0 = make_field(rng)
    tic = time.perf_counter()
    images, errs, bkgs, flags = make_cubes(img0, gen, dev)
    torch.cuda.synchronize()
    gb = sum(x.numel() * x.element_size() for x in (images, errs, bkgs, flags)) / 1e9
    print(f"phase 3 cubes: ({T}, {H}, {W}) x4 on the card, {gb:.1f} GB, made in "
          f"{time.perf_counter() - tic:.1f} s", flush=True)

    kern_ms, plain_ms, main_err = {}, {}, 0.0
    for hw in (17, 33):
        r0s = rng.integers(0, H - hw, N_PLAIN).astype(np.int32)
        c0s = rng.integers(0, W - hw, N_PLAIN).astype(np.int32)
        r0s[:64] = (np.arange(64) * 64 + 56) % (H - hw)        # straddling cell edges
        c0s[:64] = (np.arange(64) * 128 + 120) % (W - hw)
        masks = rng.uniform(size=(N_PLAIN, hw, hw)) < 0.3
        m_args = [torch.as_tensor(a, device=dev) for a in (masks, r0s, c0s)]
        cube = (images, errs, bkgs, flags)

        def kern():
            return bandext.band_extract_flux_batch(*cube, *m_args, hw, hw)

        def plain():
            return extract_flux_core(*cube, *m_args, hw, hw)

        main_err = max(main_err, max_err(host(kern()), host(plain()), f"main shape {hw}x{hw}"))
        kern_ms[hw], plain_ms[hw] = cuda_ms(kern), cuda_ms(plain)
        print(f"phase 2 main shape ({T}, {H}, {W}), {N_PLAIN} targets {hw}x{hw}: kernel "
              f"{kern_ms[hw]:.3f} ms, plain {plain_ms[hw]:.3f} ms (median of 5; {card})",
              flush=True)

    # --- phase 3: the slice -----------------------------------------------
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    wcs = TanWCS(crpix=[W / 2 + 0.5, H / 2 + 0.5], crval=[95.0, -60.0],
                 cd=[[-21.0 / 3600, 0.0], [0.0, 21.0 / 3600]])
    ra, dec = wcs.radec_of_rowcol(rows, cols)
    starid = np.arange(1, N_STARS + 1)
    cat = make_catalog_from_arrays(work, 1, 1, 1, starid=starid, ra_j2000=ra, dec_j2000=dec,
                                   pm_ra=np.zeros(N_STARS), pm_dec=np.zeros(N_STARS),
                                   tmag=tmag, reference_time=2458340.0)
    ctx = SectorContext.from_arrays(
        images=images, images_err=errs, backgrounds=bkgs, pixelflags=flags,
        sumimage=torch.nanmean(images, dim=0).cpu().numpy(),
        time=1325.3 + np.arange(T) / 48.0, timecorr=np.zeros(T, np.float32),
        cadenceno=np.arange(T, dtype=np.int32), quality=np.zeros(T, np.int32),
        catalog_path=cat, wcs=wcs, sector=1, camera=1, ccd=1, input_folder=work, device=dev)
    check(ctx.images.data_ptr() == images.data_ptr(), "from_arrays copied the cube")
    sids = [int(s) for s in starid[:N_TARGETS]]           # the brightest (tmag sorted)

    torch.cuda.synchronize()
    BAND_EXTRACT.launches = 0
    tic = time.perf_counter()
    results = extract_aperture_batch(ctx, sids)
    torch.cuda.synchronize()
    wall = time.perf_counter() - tic
    launches = BAND_EXTRACT.launches
    check(launches > 0, "the slice did not launch the band kernel")
    print(f"phase 3 slice: {N_TARGETS} targets in {wall:.2f} s = {N_TARGETS / wall:.1f} "
          f"targets/s ({card}); band kernel launches {launches}", flush=True)

    good = [r for r in results if r.status in (STATUS.OK, STATUS.WARNING)]
    n_ok = sum(r.status == STATUS.OK for r in results)
    print(f"phase 3 statuses: {n_ok} OK, {len(good) - n_ok} WARNING, "
          f"{len(results) - len(good)} other", flush=True)
    check(len(good) >= 0.9 * N_TARGETS, "fewer than 90% of targets OK or WARNING")
    for r in good:
        check(r.lightcurve["flux"].shape == (T,), f"TIC {r.starid}: flux shape")
        check(np.isfinite(r.lightcurve["flux"]).mean() > 0.99, f"TIC {r.starid}: flux not finite")

    # 1,024 of them again through the plain path on the card:
    sub = good[:N_PLAIN]
    hh = max(r.mask.shape[0] for r in sub)
    ww = max(r.mask.shape[1] for r in sub)
    masks = np.zeros((len(sub), hh, ww), bool)
    windows = np.zeros_like(masks)
    r0s = np.array([min(r.stamp[0], H - hh) for r in sub], np.int32)
    c0s = np.array([min(r.stamp[2], W - ww) for r in sub], np.int32)
    for i, r in enumerate(sub):
        dr, dc = r.stamp[0] - r0s[i], r.stamp[2] - c0s[i]
        masks[i, dr:dr + r.mask.shape[0], dc:dc + r.mask.shape[1]] = r.mask
        windows[i, dr:dr + r.mask.shape[0], dc:dc + r.mask.shape[1]] = True
    plain = host(extract_flux_core(
        *(images, errs, bkgs, flags), *(torch.as_tensor(a, device=dev) for a in
                                        (masks, r0s, c0s)), hh, ww,
        windows=torch.as_tensor(windows, device=dev)))
    keys = ("flux", "flux_err", "flux_background", "pos_centroid", "shenanigans_any")
    got = [np.stack([r.lightcurve[k] for r in sub]) for k in keys]
    slice_err = max_err(got, plain, "slice vs plain")
    print(f"phase 3 plain re-extraction of {len(sub)} targets agrees "
          f"(max |diff| {slice_err:.3g})", flush=True)

    # One lease through the dispatcher, products written and read back:
    tasks = [{"priority": i + 1, "starid": sid, "sector": 1, "camera": 1, "ccd": 1,
              "cadence": 1800, "datasource": "ffi", "tmag": float(tmag[sid - 1]),
              "method": "aperture"} for i, sid in enumerate(sids[:N_LEASE])]
    out_dir = os.path.join(work, "products")
    tic = time.perf_counter()
    lease = photometry_batch(ctx, tasks, output_folder=out_dir, version=1, save=True)
    print(f"phase 3 lease: {N_LEASE} tasks with products in "
          f"{time.perf_counter() - tic:.2f} s ({card})", flush=True)
    saved = [r for r in lease if r.details.get("filepath_lightcurve")]
    check(len(saved) >= 0.9 * N_LEASE, "fewer than 90% of the lease wrote products")
    for r in saved[:3]:
        lc = pf.read_fits(r.details["filepath_lightcurve"])[1].data
        check(np.allclose(lc["FLUX_RAW"], r.lightcurve["flux"], rtol=1e-6, equal_nan=True),
              f"TIC {r.starid}: FLUX_RAW in the product differs")
    print(f"phase 3 products: {len(saved)} written, 3 read back and equal", flush=True)
    ctx.close()

    print(json.dumps({"kernels": [{
        "name": "band_extract", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches,
        "max_abs_err": max(err, main_err, slice_err),
        "ms": kern_ms[17], "plain_ms": plain_ms[17]}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
