"""PSF photometry with a table PRF named by ``[psf] prf_dir``, on the CPU,
held to the benchmark's plain reference (``perfbench/reference/psf.py``).

A seeded 64x64 field of T = 6 frames: ten isolated stars and one pair
3.5 px apart, drawn with a K=3 table PRF (three axis-aligned Gaussians)
integrated exactly over each pixel, its table written as a SPOC
``.mat`` file in the reference's ``data/psf`` layout.  One background
pixel inside a star's minimum aperture is NaN at one cadence.

- ``run_drain(method="psf")`` (the plain fitter on the CPU) and
  ``extract_psf_batch(..., fused=True)`` (the kernel's plain function)
  each against the reference: FLUX_RAW of the one-star fits, FLUX_BKG of
  every product.
- ``[psf] prf_dir``: empty keeps the Gaussian of PSFSIGMA; set, the table
  (3 SVD terms); set with no table for the CCD, FileNotFoundError.
"""

import os
import types

import numpy as np
import pytest
import torch

from perfbench.gen import prf as gprf
from perfbench.gen.todo import write_todo
from perfbench.reference import drain as ref
from perfbench.reference import psf as rpsf
from photometry_tpu_torch.catalog import make_catalog_from_arrays
from photometry_tpu_torch.core import dispatcher
from photometry_tpu_torch.core.drain import run_drain
from photometry_tpu_torch.core.engine import SectorContext
from photometry_tpu_torch.io.settings import load_settings
from photometry_tpu_torch.io.wcs import TanWCS
from photometry_tpu_torch.models import psf_common, psf_fit
from photometry_tpu_torch.utils.profiling import StageTimer

CFG = {"sector": 1, "camera": 1, "ccd": 1,
       "prf": {"terms": [[0.7, 1.1, 1.1], [0.3, 2.0, 2.0], [0.2, 1.6, 1.3]], "oversample": 9,
               "samples": 117, "sub_prf_position": [1024.0, 1024.0],
               "file_prefix": "tess2018243163600", "svd_terms": 3}}
H = W = 64
T = 6
HEADER = {"PSFSIGMA": 1.2, "CADENCE": 1800, "NUM_FRM": 900, "READNOIS": 10.0, "GAIN": 100.0}
VAR_CONST = 900 * 10.0 ** 2 / 100.0 ** 2
# FLUX_RAW, port against reference: the program's table is the box-filtered
# (midpoint rule, 9 samples a pixel) integral of the samples, the
# reference's the exact integral of their cubic spline; the first is wider
# by h^2/12 ~ 1e-3 px^2, which moves a fit by ~1e-4 of its flux (the
# benchmark's CPU rehearsal: <= 2.1e-4), and the program fits in float32 in
# 12 and 6 steps.  A Gaussian PRF in the table's place misses by ~0.2.
FLUX_RTOL = 1e-3
# FLUX_BKG: float32 sums of 9 values near 20 against float64 sums.
BKG_RTOL = 1e-6


@pytest.fixture
def use_settings(monkeypatch, tmp_path):
    """Point the program at a copy of its settings with ``[psf] prf_dir``
    set, its cache of the settings cleared before and after."""
    def use(prf_dir):
        monkeypatch.setenv("PHOTOMETRY_TPU_SETTINGS", gprf.settings_file(str(tmp_path), prf_dir))
        load_settings.cache_clear()
    yield use
    monkeypatch.undo()
    load_settings.cache_clear()


@pytest.fixture(scope="module")
def field(tmp_path_factory):
    work = tmp_path_factory.mktemp("psf_table")
    rng = np.random.default_rng(2024)
    grid = [(r, c) for r in (10, 25, 40, 54) for c in (10, 25, 40, 54)]
    picks = rng.permutation(len(grid))[:11]
    rows = [grid[i][0] + rng.uniform(-0.5, 0.5) for i in picks[:10]]
    cols = [grid[i][1] + rng.uniform(-0.5, 0.5) for i in picks[:10]]
    r, c = grid[picks[10]]
    rows += [r - 1.2, r - 1.2 + 3.5 * 0.7]
    cols += [c - 1.2, c - 1.2 + 3.5 * 0.714]
    rows, cols = np.array(rows), np.array(cols)
    tmag = np.concatenate([rng.uniform(9.0, 10.0, 10), [10.0, 10.3]])
    img0 = np.zeros((H, W))
    gprf.add_stars(img0, CFG["prf"], rows, cols, rpsf.mag2flux(tmag))
    sigma = np.sqrt((img0 + 100.0) / 1425.6)
    images = (img0 + sigma * rng.normal(size=(T, H, W))).astype(np.float32)
    bkg = (20.0 + rng.normal(size=(T, H, W))).astype(np.float32)
    bkg[3, int(round(rows[0])), int(round(cols[0]))] = np.nan      # inside star 1's aperture
    wcs = TanWCS(crpix=[W / 2 + 0.5, H / 2 + 0.5], crval=[95.0, -60.0],
                 cd=[[-21.0 / 3600, 0.0], [0.0, 21.0 / 3600]])
    ra, dec = wcs.radec_of_rowcol(rows, cols)
    sids = np.arange(1, len(rows) + 1)
    cat = make_catalog_from_arrays(str(work), 1, 1, 1, starid=sids, ra_j2000=ra,
                                   dec_j2000=dec, pm_ra=np.zeros(len(sids)),
                                   pm_dec=np.zeros(len(sids)), tmag=tmag,
                                   reference_time=2458340.0)
    ctx_kw = dict(images=images, images_err=np.broadcast_to(sigma, (T, H, W)).astype(np.float32),
                  backgrounds=bkg, pixelflags=np.zeros((T, H, W), np.uint8),
                  sumimage=images.mean(axis=0), time=1325.3 + np.arange(T) / 48.0,
                  timecorr=np.zeros(T, np.float32), cadenceno=np.arange(T, dtype=np.int32),
                  quality=np.zeros(T, np.int32), catalog_path=cat, wcs=wcs, sector=1, camera=1,
                  ccd=1, header=dict(HEADER), device="cpu")
    prf_dir = gprf.write_prf_dir(str(work / "psf"), CFG)
    return {"work": work, "rows": rows, "cols": cols, "tmag": tmag, "ctx_kw": ctx_kw,
            "prf_dir": prf_dir, "sids": sids, "images": torch.as_tensor(images),
            "bkg": torch.as_tensor(bkg), "references": {}}


def _namespace(ccd=1):
    return types.SimpleNamespace(shape=(H, W), sector=1, camera=1, ccd=ccd, header=dict(HEADER),
                                 device=torch.device("cpu"))


def test_prf_dir_empty_keeps_the_gaussian(field, use_settings):
    use_settings("")
    prf = psf_common.context_prf(_namespace())
    assert prf.info == {"sigma": 1.2}


def test_prf_dir_set_loads_the_table(field, use_settings):
    use_settings(field["prf_dir"])
    prf = psf_common.context_prf(_namespace())
    assert prf.info["file"].startswith(field["prf_dir"] + os.sep)
    assert prf._grid_separable and prf._svd_factors()[0].shape[1] == 3


@pytest.mark.parametrize("where", ["no table for the CCD", "no such folder"])
def test_prf_dir_set_without_a_table_raises(field, use_settings, where):
    use_settings(field["prf_dir"] if where == "no table for the CCD" else str(field["work"] / "x"))
    with pytest.raises(FileNotFoundError, match="prf_dir"):
        psf_common.context_prf(_namespace(ccd=2 if where == "no table for the CCD" else 1))


def _references(field, stamps):
    """FLUX_RAW of the reference's fit of each one-star target on its stamp,
    {(starid, r0, c0, h, w): (T,)}, computed once for the module."""
    rows, cols, tmag = field["rows"], field["cols"], field["tmag"]
    cache = field["references"]
    todo = [st for st in stamps if st not in cache]
    for h, w in {st[3:] for st in todo}:
        group = [st for st in todo if st[3:] == (h, w)]
        k = np.array([st[0] - 1 for st in group])
        assert all(len(rpsf.select_stars(i, rows, cols, tmag)) == 1 for i in k)
        r0 = np.array([st[1] for st in group])
        c0 = np.array([st[2] for st in group])
        img, bkg = (torch.stack([x[:, a:a + h, b:b + w] for a, b in zip(r0, c0)]).double()
                    for x in (field["images"], field["bkg"]))
        mini = np.stack([rpsf.minimum_aperture((h, w), rows[i] - a, cols[i] - b)
                         for i, a, b in zip(k, r0, c0)])
        spline = rpsf.SplinePRF(CFG["prf"], "cpu")
        with rpsf.float64_only():
            flux, _, steps = rpsf.fit(spline, img, bkg, VAR_CONST, (rows[k] - r0)[:, None],
                                      (cols[k] - c0)[:, None], rpsf.mag2flux(tmag[k])[:, None],
                                      0, mini)
        assert steps < rpsf.MAX_ITERS
        cache.update(zip(group, flux))
    return {st: cache[st] for st in stamps}


def _bkg_sums(field, aperture, r0, c0):
    h, w = aperture.shape
    b = field["bkg"][:, r0:r0 + h, c0:c0 + w].double()
    m = torch.as_tensor((aperture & 2) != 0)[None]
    return torch.nansum(torch.where(m, b, 0.0), dim=(1, 2)).numpy()


def _held(field, products):
    """Each product's FLUX_BKG, and FLUX_RAW of each one-star fit, against
    the reference; ``products`` holds (starid, flux, flux_bkg, aperture,
    r0, c0)."""
    single = [(sid, r0, c0, *ap.shape) for sid, _, _, ap, r0, c0 in products if sid <= 10]
    assert len(single) == 10
    want = _references(field, single)
    for sid, flux, fbkg, aperture, r0, c0 in products:
        np.testing.assert_allclose(fbkg, _bkg_sums(field, aperture, r0, c0), rtol=BKG_RTOL)
        if sid <= 10:
            ref_flux = want[(sid, r0, c0, *aperture.shape)]
            assert np.isfinite(flux).all()
            assert np.max(np.abs(flux - ref_flux)) <= FLUX_RTOL * np.median(np.abs(ref_flux)), sid


def test_run_drain_psf_matches_the_reference(field, use_settings, monkeypatch, tmp_path):
    use_settings(field["prf_dir"])
    monkeypatch.setattr(dispatcher, "open_context",
                        lambda *a, **kw: SectorContext.from_arrays(**field["ctx_kw"]))
    folder = tmp_path / "input"
    folder.mkdir()
    write_todo(str(folder), field["sids"], field["tmag"])
    assert run_drain(str(folder), 1, products_folder=str(tmp_path / "products"), method="psf",
                     device="cpu") == len(field["sids"])
    crpix = np.array([W / 2 + 0.5, H / 2 + 0.5])
    done = ref.delivered(str(folder))
    assert len(done) == len(field["sids"]) and {r[4] for r in done} == {"psf"}
    products = []
    for r in done:
        aperture, r0, c0, lc = ref.stamp_of(ref.fitsread.read(ref.product_path(str(folder), r[5])),
                                            crpix)
        products.append((r[1], np.asarray(lc["FLUX_RAW"], np.float64),
                         np.asarray(lc["FLUX_BKG"], np.float64), aperture, r0, c0))
    _held(field, products)


def test_fused_function_matches_the_reference(field, use_settings):
    use_settings(field["prf_dir"])
    ctx = SectorContext.from_arrays(**field["ctx_kw"])
    recorder = StageTimer()
    with recorder.recording():
        out = psf_fit.extract_psf_batch(ctx, [int(s) for s in field["sids"]], fused=True)
    assert recorder.timings["psf_fused_instances"] == recorder.timings["psf_instances"] > 0
    _held(field, [(res.starid, np.asarray(res.lightcurve["flux"], np.float64),
                    np.asarray(res.lightcurve["flux_background"], np.float64),
                    res.aperture_image, res.stamp[0], res.stamp[2]) for res in out])
