"""Plain reference of what a drain writes: statuses, each product's light
curve worked out again in float64 from the benchmark's own inputs, and the
products held to the truth of the field the benchmark made.

Nothing here imports the program or JAX.  A product is read with
``fitsread``.  Two kinds of numbers:

* re-sums: the light curve against float64 sums over the benchmark's cube
  or pixel file, over the APERTURE image (the photometric mask, bits 2|8)
  at the stamp corner (the field's reference pixel minus the stamp WCS's
  CRPIX), or for a halo product over its WEIGHTMAP table.  They catch the
  arithmetic, not the choice of mask or weights;
* truth: the mask against the star it was made for (how much of the
  star's own light it misses: a mask without the star's pixel misses 7%
  or more), a linPSF flux against the
  flux the benchmark injected, and a halo light curve against the shape
  of the star's injected variation.  They catch a wrong mask, a wrong star, a wrong fit.

A gap is the largest absolute difference over cadences, as a share of the
median absolute reference value of that column and target; a NaN where
the other side is finite is a gap of ``NO_MATCH``.
"""

import os
import sqlite3

import numpy as np
import torch

from . import fitsread

# The program's status codes (its core/status.py): final ones end a task.
OK, ERROR, WARNING, SKIPPED = 1, 2, 3, 5
FINAL = (OK, ERROR, WARNING, SKIPPED)
#: The gap of a NaN where the other side is finite, or of a kind of product
#: that never came (a finite number, so that the result line stays JSON).
NO_MATCH = 1e300
ZERO_POINT = 20.451              #: Tmag of 1 e-/s


def mag2flux(tmag) -> float:
    return float(10 ** (-0.4 * (float(tmag) - ZERO_POINT)))


def todo_rows(folder: str) -> list:
    """(priority, starid, datasource, status, method_used, lightcurve path) of a todo list."""
    with sqlite3.connect(os.path.join(folder, "todo.sqlite")) as conn:
        return conn.execute(
            "SELECT t.priority, t.starid, t.datasource, t.status, d.method_used, d.lightcurve "
            "FROM todolist t LEFT JOIN diagnostics d ON t.priority = d.priority "
            "ORDER BY t.priority").fetchall()


def product_path(folder: str, path):
    if not path:
        return None
    return path if os.path.isabs(path) else os.path.join(folder, path)


def delivered(folder: str) -> list:
    """Rows whose status is OK or WARNING and whose product is on disk."""
    return [r for r in todo_rows(folder) if r[3] in (OK, WARNING)
            and r[5] and os.path.exists(product_path(folder, r[5]))]


def unfinished(folder: str) -> int:
    """Rows left without a final status, and OK/WARNING rows without a product."""
    bad = 0
    for r in todo_rows(folder):
        if r[3] not in FINAL:
            bad += 1
        elif r[3] in (OK, WARNING) and not (r[5] and os.path.exists(product_path(folder, r[5]))):
            bad += 1
    return bad


def gap(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape or not np.array_equal(np.isfinite(got), np.isfinite(want)):
        return NO_MATCH
    ok = np.isfinite(want)
    if not ok.any():
        return 0.0
    scale = max(float(np.median(np.abs(want[ok]))), 1e-30)
    return float(np.max(np.abs(got[ok] - want[ok]))) / scale


def _round(x: torch.Tensor, dtype) -> torch.Tensor:
    """The reference's inputs in float64, first rounded to ``dtype`` when given
    (the control: the reference on inputs of a lower precision)."""
    return (x if dtype is None else x.to(dtype)).double()


def stamp_of(product: dict, crpix) -> tuple:
    """(APERTURE image, r0, c0, LIGHTCURVE columns) of a read product."""
    ap = fitsread.hdu(product, "APERTURE")
    hdr = ap["header"]
    if crpix is None:                      # a TPF product: the stamp is the whole pixel file
        r0 = c0 = 0
    else:
        c0 = int(round(crpix[0] - hdr["CRPIX1"]))
        r0 = int(round(crpix[1] - hdr["CRPIX2"]))
    return np.asarray(ap["data"]), r0, c0, fitsread.hdu(product, "LIGHTCURVE")["data"]


def _stack(planes, lc, r0, c0, h, w, t_index, dtype, which=(0, 1, 2)):
    idx = torch.as_tensor(t_index(lc["CADENCENO"]), device=planes[0].device)
    return [_round(planes[k][idx, r0:r0 + h, c0:c0 + w], dtype) for k in which]


def _compare(product_cols, lc, want, got):
    """The largest gap over ``product_cols`` between the reference's columns
    ``want`` and ``got``: the product's own, or the control's (a dict)."""
    got = got if got is not None else {k: lc[k] for k in product_cols}
    return max(gap(got[k], want[k]) for k in product_cols)


def aperture_columns(planes, aperture, r0, c0, lc, t_index, dtype=None) -> dict:
    """FLUX_RAW, FLUX_RAW_ERR and FLUX_BKG of a mask, summed in float64."""
    h, w = aperture.shape
    img, err, bkg = _stack(planes, lc, r0, c0, h, w, t_index, dtype)
    m = torch.as_tensor((aperture & 2) != 0, device=img.device)[None]
    fin = m & torch.isfinite(img)
    bad = (fin.sum(dim=(1, 2)) == 0) | ((m & (img == 0)).sum(dim=(1, 2)) >= int(m.sum()))
    nan = torch.tensor(float("nan"), dtype=torch.float64, device=img.device)
    err2 = torch.where(m & torch.isfinite(err), err * err, 0.0).sum(dim=(1, 2))
    mb = m & torch.isfinite(bkg)
    cols = {"FLUX_RAW": torch.where(bad, nan, torch.where(fin, img, 0.0).sum(dim=(1, 2))),
            "FLUX_RAW_ERR": torch.where(bad, nan, torch.sqrt(err2)),
            "FLUX_BKG": torch.where(mb.sum(dim=(1, 2)) > 0,
                                    torch.where(mb, bkg, 0.0).sum(dim=(1, 2)), nan)}
    return {k: v.cpu().numpy() for k, v in cols.items()}


def aperture_gap(planes, product, crpix, t_index, control=None) -> float:
    """An aperture product (FFI or TPF) against float64 sums over its mask.

    ``planes`` = (images, errors, backgrounds) of (T, H, W), on any device;
    ``t_index`` maps the product's CADENCENO to frame indices.  With
    ``control`` (a dtype), the reference on inputs rounded to that dtype
    takes the product's place."""
    aperture, r0, c0, lc = stamp_of(product, crpix)
    args = (planes, aperture, r0, c0, lc, t_index)
    return _compare(("FLUX_RAW", "FLUX_RAW_ERR", "FLUX_BKG"), lc, aperture_columns(*args),
                    None if control is None else aperture_columns(*args, dtype=control))


def halo_columns(planes, wm, r0, c0, lc, t_index, tmag, dtype=None) -> dict:
    cad = np.asarray(lc["CADENCENO"])
    dev = planes[0].device
    weights = torch.as_tensor(np.asarray(wm["WEIGHTMAP"], np.float64), device=dev)  # (seg, h, w)
    h, w = weights.shape[1:]
    img, err = _stack(planes, lc, r0, c0, h, w, t_index, dtype, which=(0, 1))
    med = torch.nanmedian(img, dim=0).values
    img = torch.where(torch.isnan(img), med[None], img)
    norm = 10 ** (-0.4 * (float(tmag) - 20.451))
    flux = np.full(len(cad), np.nan)
    ferr = np.full(len(cad), np.nan)
    for k in range(weights.shape[0]):
        sel = (cad >= int(wm["CADENCENO1"][k])) & (cad <= int(wm["CADENCENO2"][k]))
        sel_d = torch.as_tensor(sel, device=dev)
        wk = weights[k][None]
        flux[sel] = (norm * (wk * img[sel_d]).sum(dim=(1, 2))).cpu().numpy()
        ferr[sel] = (abs(norm) * torch.sqrt(torch.nansum(wk ** 2 * err[sel_d] ** 2,
                                                         dim=(1, 2)))).cpu().numpy()
    return {"FLUX_RAW": flux, "FLUX_RAW_ERR": ferr}


def halo_gap(planes, product, crpix, t_index, tmag, control=None) -> float:
    """A halo product against its weight map applied to the raw pixels in
    float64: flux = mag2flux(Tmag) * sum_p w_p f_tp (a NaN pixel counts as
    its median over time, as the halo's normalised fluxes do), flux_err =
    mag2flux(Tmag) * sqrt(sum_p w_p^2 e_tp^2), segment by segment."""
    _, r0, c0, lc = stamp_of(product, crpix)
    args = (planes, fitsread.hdu(product, "WEIGHTMAP")["data"], r0, c0, lc, t_index, tmag)
    return _compare(("FLUX_RAW", "FLUX_RAW_ERR"), lc, halo_columns(*args),
                    None if control is None else halo_columns(*args, dtype=control))


def linpsf_columns(planes, aperture, r0, c0, lc, t_index, var_const, dtype=None) -> dict:
    h, w = aperture.shape
    img, bkg = _stack(planes, lc, r0, c0, h, w, t_index, dtype, which=(0, 2))
    m = torch.as_tensor((aperture & 2) != 0, device=img.device)[None]
    var = torch.nansum(torch.where(m, torch.abs(img + bkg) + var_const, 0.0), dim=(1, 2))
    return {"FLUX_BKG": torch.nansum(torch.where(m, bkg, 0.0), dim=(1, 2)).cpu().numpy(),
            "FLUX_RAW_ERR": torch.sqrt(var).cpu().numpy()}


def linpsf_gap(planes, product, crpix, t_index, var_const, control=None) -> float:
    """A linPSF product's background and flux error against float64 sums
    over its minimum aperture (APERTURE bits 2|8): FLUX_BKG = sum of the
    background, FLUX_RAW_ERR = sqrt(sum |image + background| + the
    read-noise constant), NaN pixels left out.  Its FLUX_RAW, the fit
    itself, is held to the injected flux instead (``constant_gap``, on the
    injected pairs)."""
    aperture, r0, c0, lc = stamp_of(product, crpix)
    args = (planes, aperture, r0, c0, lc, t_index, var_const)
    return _compare(("FLUX_BKG", "FLUX_RAW_ERR"), lc, linpsf_columns(*args),
                    None if control is None else linpsf_columns(*args, dtype=control))


# -- the truth of the field -------------------------------------------------

def own_light_lost(aperture, r0, c0, row, col, sigma, shape) -> float:
    """The share of a field star's own light that falls outside its
    photometric aperture: its Gaussian of ``sigma``, point-sampled on the
    15x15 window (clipped to the CCD of ``shape``) the field was made with."""
    H, W = shape
    ri, ci = int(row), int(col)
    yy, xx = np.mgrid[max(ri - 7, 0):min(ri + 8, H), max(ci - 7, 0):min(ci + 8, W)]
    g = np.exp(-0.5 * ((yy - row) ** 2 + (xx - col) ** 2) / sigma ** 2)
    h, w = aperture.shape
    i, j = yy - r0, xx - c0
    inside = (i >= 0) & (i < h) & (j >= 0) & (j < w)
    held = np.zeros(g.shape, bool)
    held[inside] = (aperture[i[inside], j[inside]] & 2) != 0
    return float(g[~held].sum() / g.sum())


def constant_gap(flux, want: float) -> float:
    """A light curve against a constant flux: the largest |flux - want| over
    cadences as a share of ``want``; any NaN is ``NO_MATCH``."""
    f = np.asarray(flux, np.float64)
    if not np.isfinite(f).all():
        return NO_MATCH
    return float(np.max(np.abs(f - want))) / abs(want)


def shape_gap(flux, truth) -> float:
    """How far a light curve is from following the true one: 1 - their
    correlation over cadences.  A halo light curve may damp a variation
    (the weights favour pixels that vary less) but follows its shape; one
    of another star, or a flat or noisy one, does not."""
    f, t = np.asarray(flux, np.float64), np.asarray(truth, np.float64)
    if f.shape != t.shape or not np.array_equal(np.isfinite(f), np.isfinite(t)):
        return NO_MATCH
    ok = np.isfinite(t)
    if ok.sum() < 3 or not np.std(f[ok]) > 0:
        return NO_MATCH
    return float(1.0 - np.corrcoef(f[ok], t[ok])[0, 1])
