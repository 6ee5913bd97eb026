"""One CCD of FFIs drawn with a table PRF, and the PRF file a deployment loads.

A configuration's ``prf`` block states the PRF as a density, a sum of
axis-aligned Gaussians ``terms`` of (weight, sigma_row, sigma_col) in
pixels, sampled ``oversample`` times a pixel on ``samples`` points an axis
(the SPOC characterized-PRF tables' sampling) at one sub-PRF position.
``write_prf_dir`` writes that table as a TESS ``.mat`` file in the
reference's ``data/psf`` layout (``start_s0001/`` for sectors 1-3,
``start_s0004/`` after), with scipy alone; ``settings_file`` writes a copy
of the program's settings whose ``[psf] prf_dir`` names the folder.

The field holds the stars ``field.make_field`` draws from the
configuration's ``field_seed`` (the same positions and magnitudes, the
same static noise) and the traffic's blended pairs (``field.layout``),
each star's light integrated exactly over every pixel of a window around
it: the terms are separable, so a pixel's share is a sum of products of
erf differences.  The cube is then made on the card by ``ffi.cube``, with
nothing left for its injector to add.
"""

import configparser
import os

import numpy as np

from . import ffi
from . import field as fld

HALF = 9                 #: the window a star is drawn in: 2 * HALF + 1 px a side
EMPTY_LAYOUT = {k: np.zeros(0) for k in ("b_rows", "b_cols", "b_tmag", "route", "p_rows",
                                         "p_cols", "p_tmag")}


def table(prf: dict) -> tuple:
    """(offsets of the samples in px, one axis; the density on the grid,
    rows the first axis)."""
    n = prf["samples"]
    offs = (np.arange(n) - (n - 1) / 2) / prf["oversample"]
    g = sum(a * np.exp(-0.5 * (offs[:, None] / sr) ** 2 - 0.5 * (offs[None, :] / sc) ** 2)
            for a, sr, sc in prf["terms"])
    return offs, g


def write_prf_dir(folder: str, cfg: dict) -> str:
    """The configuration's PRF as ``<folder>/start_s000N/tess..-<camera>-<ccd>-
    characterized-prf.mat`` (a 1x1 ``prfStruct``: prfColumn, prfRow,
    values, ccdColumn, ccdRow).  Returns ``folder``."""
    from scipy.io import savemat
    prf = cfg["prf"]
    offs, g = table(prf)
    sub = os.path.join(folder, "start_s0004" if cfg["sector"] >= 4 else "start_s0001")
    os.makedirs(sub, exist_ok=True)
    dt = [(k, "O") for k in ("prfColumn", "prfRow", "values", "ccdColumn", "ccdRow")]
    arr = np.zeros((1, 1), dtype=dt)
    col, row = prf["sub_prf_position"]
    arr[0, 0] = (offs[:, None], offs[:, None], g, float(col), float(row))
    name = f"{prf['file_prefix']}-{cfg['camera']}-{cfg['ccd']}-characterized-prf.mat"
    savemat(os.path.join(sub, name), {"prfStruct": arr})
    return folder


def settings_file(folder: str, prf_dir: str) -> str:
    """A copy of the program's settings with ``[psf] prf_dir`` set; its path."""
    from photometry_tpu_torch.io.settings import data_dir
    settings = configparser.ConfigParser()
    with open(os.path.join(data_dir(), "settings.ini")) as fh:
        settings.read_file(fh)
    if not settings.has_section("psf"):
        settings.add_section("psf")
    settings.set("psf", "prf_dir", prf_dir)
    path = os.path.join(folder, "settings.ini")
    with open(path, "w") as fh:
        settings.write(fh)
    return path


def pixel_shares(prf: dict, rows, cols, half: int = HALF) -> tuple:
    """(r0, c0, shares): each star's window corner (its pixel less ``half``)
    and the share of its light in each pixel of the (2 half + 1)^2 window,
    the untruncated density integrated over the pixel."""
    from scipy.special import erf
    rows, cols = np.asarray(rows, np.float64), np.asarray(cols, np.float64)
    r0 = rows.astype(np.int64) - half
    c0 = cols.astype(np.int64) - half
    k = np.arange(2 * half + 1)
    dy = (r0[:, None] + k) - rows[:, None]            # pixel centres less the star
    dx = (c0[:, None] + k) - cols[:, None]
    shares, total = 0.0, 0.0
    for a, sr, sc in prf["terms"]:
        mass = a * 2 * np.pi * sr * sc
        py = 0.5 * (erf((dy + 0.5) / (np.sqrt(2) * sr)) - erf((dy - 0.5) / (np.sqrt(2) * sr)))
        px = 0.5 * (erf((dx + 0.5) / (np.sqrt(2) * sc)) - erf((dx - 0.5) / (np.sqrt(2) * sc)))
        shares = shares + mass * py[:, :, None] * px[:, None, :]
        total += mass
    return r0, c0, shares / total


def add_stars(img, prf: dict, rows, cols, flux, chunk: int = 4096):
    """Add the stars' light to ``img`` (H, W) in place, clipped to the frame."""
    H, W = img.shape
    k = np.arange(2 * HALF + 1)
    for i in range(0, len(rows), chunk):
        r0, c0, shares = pixel_shares(prf, rows[i:i + chunk], cols[i:i + chunk])
        rr = np.broadcast_to((r0[:, None] + k)[:, :, None], shares.shape)
        cc = np.broadcast_to((c0[:, None] + k)[:, None, :], shares.shape)
        ok = (rr >= 0) & (rr < H) & (cc >= 0) & (cc < W)
        light = shares * np.asarray(flux[i:i + chunk], np.float64)[:, None, None]
        np.add.at(img, (rr[ok], cc[ok]), light[ok].astype(img.dtype))


def layout(cfg: dict, mix: dict) -> tuple:
    """rows, cols, tmag of the field; the (H, W) sum image of the field and
    the pairs, drawn with the table PRF; the pairs' layout (no bright
    stars)."""
    rng = np.random.default_rng(cfg["field_seed"])
    H, W = cfg["rows"], cfg["cols"]
    rows, cols, tmag, _ = fld.make_field(rng, {**cfg["field"], "psf_sigma_px": None}, H, W,
                                         image=False)
    img0 = rng.normal(0.0, 1.5, (H, W)).astype(np.float32)   # make_field's static noise
    lay = fld.layout(rng, rows, cols, {**mix, "bright": 0, "tail": 0}, H, W)
    add_stars(img0, cfg["prf"], rows, cols, fld.mag2flux(tmag))
    add_stars(img0, cfg["prf"], lay["p_rows"], lay["p_cols"], fld.mag2flux(lay["p_tmag"]))
    return rows, cols, tmag, img0, lay


def sector(cfg, mix, seed, device, work, dtype=None):
    """What a drain of the seed needs, as ``ffi.sector`` gives it: the cube
    (the pairs drawn into the sum image with the field, constant), the
    catalog in ``work``, the todo list's tasks (the pairs, then the
    brightest field stars), the context's keyword arguments and the
    truth."""
    import torch
    from photometry_tpu_torch.catalog import make_catalog_from_arrays
    rows, cols, tmag, img0, lay = layout(cfg, mix)
    H, W, T = cfg["rows"], cfg["cols"], cfg["n_times"]
    dtype = dtype or torch.float32
    cubes, sumimage, _ = ffi.cube({**cfg, "field": {"psf_sigma_px": None}}, {"tail": 0}, seed,
                                  device, dtype, (rows, cols, tmag, img0, EMPTY_LAYOUT))
    n0, npair = len(rows), len(lay["p_tmag"])
    all_rows = np.concatenate([rows, lay["p_rows"]])
    all_cols = np.concatenate([cols, lay["p_cols"]])
    all_tmag = np.concatenate([tmag, lay["p_tmag"]])
    sids = np.arange(1, len(all_rows) + 1)
    wcs = fld.field_wcs(H, W)
    ra, dec = wcs.radec_of_rowcol(all_rows, all_cols)
    os.makedirs(work, exist_ok=True)
    cat = make_catalog_from_arrays(work, cfg["sector"], cfg["camera"], cfg["ccd"], starid=sids,
                                   ra_j2000=ra, dec_j2000=dec, pm_ra=np.zeros(len(sids)),
                                   pm_dec=np.zeros(len(sids)), tmag=all_tmag,
                                   reference_time=2458340.0)
    field_first = [int(s) + 1 for s in np.argsort(tmag, kind="stable")]
    todo = [int(s) for s in sids[n0:]] + field_first[:mix["todo"] - npair]
    cadence = cfg["cadence_s"]
    ctx_kw = dict(images=cubes[0], images_err=cubes[1], backgrounds=cubes[2],
                  pixelflags=cubes[3], sumimage=sumimage,
                  time=cfg["tstart"] + np.arange(T) * cadence / 86400.0,
                  timecorr=np.zeros(T, np.float32), cadenceno=np.arange(T, dtype=np.int32),
                  quality=np.zeros(T, np.int32), catalog_path=cat, wcs=wcs,
                  sector=cfg["sector"], camera=cfg["camera"], ccd=cfg["ccd"],
                  header=dict(cfg["header"]), device=device)
    if dtype != torch.float32:
        ctx_kw["cube_dtype"] = dtype
    return {"ctx_kw": ctx_kw, "todo": todo, "tmag": all_tmag, "n_bright": 0, "n_pairs": npair,
            "crpix": fld.crpix(H, W),
            "truth": {"rows": all_rows, "cols": all_cols, "tmag": all_tmag, "n_field": n0,
                      "n_times": T}}
