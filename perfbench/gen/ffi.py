"""One CCD of a sector of full-frame images, made on the card from the seed.

The calibrated cube a drain reads (images, errors, backgrounds, pixel
flags; T frames of H x W) is the seeded field of ``field.make_field`` with
the mix's stars injected, on TESS-like noise: per cadence Gaussian noise
of variance (flux + sky) / exptime, backgrounds 20 + N(0, 1) e-/s with
scattered NaN pixels, and one pixel in 10,000 flagged (bit 4).  It is made
64 frames at a time in float32 on the card and stored in ``dtype``, so a
float32 cube and a bfloat16 cube of one seed hold the same draws.
"""

import os

import numpy as np
import torch

from . import field as fld
from .todo import write_todo

BLOCK = 64


def layout(cfg, mix):
    """Host draws: the field (with its sum image) and the mix's stars, from
    the configuration's ``field_seed``: every run seed gets the same work."""
    rng = np.random.default_rng(cfg["field_seed"])
    H, W = cfg["rows"], cfg["cols"]
    rows, cols, tmag, img0 = fld.make_field(rng, cfg["field"], H, W)
    lay = fld.layout(rng, rows, cols, mix, H, W)
    return rows, cols, tmag, img0, lay


def cube(cfg, mix, seed, device, dtype=torch.float32, host=None):
    """The (images, errors, backgrounds, flags) cube of a seed on ``device``
    in ``dtype`` (flags uint8), the float32 sum image (mean over time of the
    float32 images) and the bright stars' phases.  ``host``: the ``layout``
    if already drawn.  The seed draws the noise, the flags, the NaN pixels
    and the phases."""
    rows, cols, tmag, img0, lay = host or layout(cfg, mix)
    H, W, T = cfg["rows"], cfg["cols"], cfg["n_times"]
    noise = cfg["noise"]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    inj = fld.Injector(lay, mix, T, H, W, cfg["field"]["psf_sigma_px"], noise["saturation"],
                       noise["exptime_s"], gen, device)
    base = torch.as_tensor(img0, device=device)
    sigma = torch.sqrt((torch.clamp(base, min=0.0) + noise["sky"]) / noise["exptime_s"])
    planes = [torch.empty(T, H, W, device=device, dtype=dtype) for _ in range(3)]
    flags = torch.empty(T, H, W, device=device, dtype=torch.uint8)
    total = torch.zeros(H, W, device=device, dtype=torch.float64)
    n_nan = noise["nan_pixels"]
    for t0 in range(0, T, BLOCK):
        n = min(BLOCK, T - t0)
        img = base + sigma * torch.randn(n, H, W, device=device, generator=gen)
        err = sigma.expand(n, H, W).clone()
        bkg = 20.0 + torch.randn(n, H, W, device=device, generator=gen)
        flg = (torch.rand(n, H, W, device=device, generator=gen) < 1e-4).to(torch.uint8) * 4
        k = n_nan * (t0 + n) // T - n_nan * t0 // T
        idx = torch.randint(0, n * H * W, (k,), device=device, generator=gen)
        bkg.view(-1)[idx] = float("nan")
        inj.add(img, err, t0)
        total += img.sum(dim=0, dtype=torch.float64)
        for p, x in zip(planes, (img, err, bkg)):
            p[t0:t0 + n] = x
        flags[t0:t0 + n] = flg
        del img, err, bkg, flg
    return planes + [flags], (total / T).float().cpu().numpy(), inj.phases.cpu().numpy()


def sector(cfg, mix, seed, device, work, dtype=torch.float32):
    """Everything a drain of the seed needs: the cube, the catalog in
    ``work``, the todo list's tasks, the context's keyword arguments, and
    the truth the check holds products to (every star's position and
    magnitude, the bright stars' phases)."""
    from photometry_tpu_torch.catalog import make_catalog_from_arrays
    host = layout(cfg, mix)
    rows, cols, tmag, _, lay = host
    H, W, T = cfg["rows"], cfg["cols"], cfg["n_times"]
    cubes, sumimage, phases = cube(cfg, mix, seed, device, dtype, host)
    nb, npair, n0 = len(lay["b_tmag"]), len(lay["p_tmag"]), len(rows)
    all_rows = np.concatenate([rows, lay["b_rows"], lay["p_rows"]])
    all_cols = np.concatenate([cols, lay["b_cols"], lay["p_cols"]])
    all_tmag = np.concatenate([tmag, lay["b_tmag"], lay["p_tmag"]])
    sids = np.arange(1, len(all_rows) + 1)
    wcs = fld.field_wcs(H, W)
    ra, dec = wcs.radec_of_rowcol(all_rows, all_cols)
    os.makedirs(work, exist_ok=True)
    cat = make_catalog_from_arrays(work, 1, 1, 1, starid=sids, ra_j2000=ra, dec_j2000=dec,
                                   pm_ra=np.zeros(len(sids)), pm_dec=np.zeros(len(sids)),
                                   tmag=all_tmag, reference_time=2458340.0)
    field_first = [int(s) + 1 for s in np.argsort(tmag, kind="stable")]
    todo = ([int(s) for s in sids[n0:n0 + nb]] + [int(s) for s in sids[n0 + nb:]]
            + field_first[:mix["todo"] - nb - npair])
    cadence = cfg["cadence_s"]
    ctx_kw = dict(images=cubes[0], images_err=cubes[1], backgrounds=cubes[2],
                  pixelflags=cubes[3], sumimage=sumimage,
                  time=1325.3 + np.arange(T) * cadence / 86400.0,
                  timecorr=np.zeros(T, np.float32), cadenceno=np.arange(T, dtype=np.int32),
                  quality=np.zeros(T, np.int32), catalog_path=cat, wcs=wcs, sector=1, camera=1,
                  ccd=1, header=dict(cfg["header"]), device=device)
    if dtype != torch.float32:
        ctx_kw["cube_dtype"] = dtype
    return {"ctx_kw": ctx_kw, "todo": todo, "tmag": all_tmag, "n_bright": nb, "n_pairs": npair,
            "crpix": fld.crpix(H, W),
            "truth": {"rows": all_rows, "cols": all_cols, "n_field": n0, "phases": phases,
                      "n_times": T, "psf_sigma_px": cfg["field"]["psf_sigma_px"]}}


def write_tasks(folder, tasks, tmag, cadence):
    """The todo list of FFI ``tasks`` (star ids; ``tmag`` of every star)."""
    return write_todo(folder, tasks, tmag[np.asarray(tasks) - 1], cadences=[cadence] * len(tasks))
