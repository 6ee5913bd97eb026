"""Port parity of the prepare stage (FFI FITS -> sector-CCD cube), end to end on CPU.

One simulated sector (96x96, 16 frames at 1800 s, 25 stars, one TPF, a
catalog, and a saturated patch in one frame for the shenanigans flags) is
prepared by the JAX package and by the port (``device="cpu"``)
into two folders, and the cubes are compared dataset by dataset:

- exact: time, timecorr, cadenceno, quality, time_start/time_stop, the
  WCS strings, the attributes (header, stage markers, WCS_REF_FRAME, ...),
  the datasets' dtypes, shapes, chunks and compression, the sum image's
  NaN pattern, images_err, and the NotUsedForBackground / ManualExclude
  flags;
- BackgroundShenanigans: equal except where |residual - robust mean| lies
  within EPS_SHEN of the 40 e-/s threshold (the residuals inherit the
  backgrounds' float32 differences);
- backgrounds and images: rtol 1e-3 + atol 0.05 e-/s, the tolerance
  tests/test_prepare.py:145 allows between two chunkings of one package
  (measured max 0.03 e-/s: log10 and summation order, see
  tests/test_torch_prepare_ops.py); the sum image the same.

The cube is the state this stage hands on: each package opens the other's
cube, and the port's aperture ``photometry_batch`` runs on both.

Stage 6 (movement kernels, ``calc_movement_kernel=True``) runs on the
six-frame jittered sim of tests/test_prepare.py:172 through both packages:
the ``movement_kernel`` datasets agree within 2e-5 px (float32 ECC sums in
another order; tests/test_torch_registration.py), track the injected
jitter to that test's 0.08 px, and give the same per-cadence jitter in
either package's ``SectorContext``.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from chip_smoke import DictCube
from torch_parity import ATOL, RTOL

from photometry_tpu.core.engine import SectorContext as JaxContext
from photometry_tpu.core.pixelflags import shenanigans_residual as jax_resid
from photometry_tpu.io.cube import ImageCube as JaxCube
from photometry_tpu.prepare import prepare_photometry as jax_prepare
from photometry_tpu.prepare import quality_from_tpf as jax_quality_from_tpf
from photometry_tpu.sim.simulator import SimConfig, simulate_sector
from photometry_tpu_torch import prepare as prep
from photometry_tpu_torch.cli import prepare_cmd
from photometry_tpu_torch.core.dispatcher import photometry_batch
from photometry_tpu_torch.core.engine import SectorContext
from photometry_tpu_torch.core.status import STATUS
from photometry_tpu_torch.io.cube import ImageCube
from photometry_tpu_torch.ops.filters import time_moving_nanmean
from photometry_tpu_torch.quality import PixelQualityFlags, TESSQualityFlags

BKG_RTOL, BKG_ATOL = 1e-3, 0.05
EPS_SHEN = 0.5          #: e-/s around the 40 e-/s shenanigans threshold
KERNEL_ATOL = 2e-5      #: px, movement kernels port vs JAX


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    base = tmp_path_factory.mktemp("torch_prepare")
    d = str(base / "in")
    sim = simulate_sector(SimConfig(shape=(96, 96), n_times=16, n_stars=25, seed=11))
    # A saturated 22x22 patch in one frame: excluded from its background fit
    # (above flux_cutoff), so the shenanigans detector flags it.
    sim.images[6, 40:62, 50:72] += 1e5
    sim.write_ffis(d)
    tpf = sim.write_tpf(d, int(sim.starid[0]), n_times=200)
    sim.write_catalog(d)
    out = {}
    for name in ("jax", "torch"):
        out[name] = str(base / name)
        sim.write_catalog(out[name])          # photometry on the cube needs the catalog
    (pj,) = jax_prepare(d, output_folder=out["jax"])
    (pt,) = prep.prepare_photometry(d, output_folder=out["torch"], device="cpu")
    return sim, d, tpf, out, pj, pt


def test_vectors_wcs_attrs_and_layout_equal(prepared):
    *_, pj, pt = prepared
    with JaxCube(pj) as a, ImageCube(pt) as b:
        for k in ("time", "timecorr", "cadenceno", "quality"):
            np.testing.assert_array_equal(getattr(b, k), getattr(a, k), err_msg=k)
        for k in ("time_start", "time_stop", "bkg_pixels_used"):
            np.testing.assert_array_equal(np.asarray(b.h5[k]), np.asarray(a.h5[k]), err_msg=k)
        assert b.wcs_strings() == a.wcs_strings() and all(a.wcs_strings())
        assert dict(b.h5.attrs) .keys() == dict(a.h5.attrs).keys()
        for k, v in a.h5.attrs.items():
            np.testing.assert_array_equal(b.h5.attrs[k], v, err_msg=k)
        assert b.h5.attrs["_stages_done"] == ",".join(sorted(prep.STAGES))
        assert sorted(b.h5.keys()) == sorted(a.h5.keys())
        for k in a.h5.keys():
            da, db = a.h5[k], b.h5[k]
            assert (db.dtype, db.shape, db.chunks, db.compression, db.shuffle) == \
                (da.dtype, da.shape, da.chunks, da.compression, da.shuffle), k


def test_images_backgrounds_sumimage(prepared):
    *_, pj, pt = prepared
    with JaxCube(pj) as a, ImageCube(pt) as b:
        np.testing.assert_array_equal(b.images_err(), a.images_err())
        for k in ("backgrounds", "images"):
            np.testing.assert_allclose(getattr(b, k)(), getattr(a, k)(), rtol=BKG_RTOL,
                                       atol=BKG_ATOL, equal_nan=True, err_msg=k)
        np.testing.assert_array_equal(np.isnan(b.sumimage), np.isnan(a.sumimage))
        np.testing.assert_allclose(b.sumimage, a.sumimage, rtol=BKG_RTOL, atol=BKG_ATOL,
                                   equal_nan=True)


def test_pixel_flags(prepared):
    *_, pj, pt = prepared
    with JaxCube(pj) as a, ImageCube(pt) as b:
        fa, fb = a.pixelflags(), b.pixelflags()
        images, sumimage = a.images(), a.sumimage
    for bit in (PixelQualityFlags.NotUsedForBackground, PixelQualityFlags.ManualExclude):
        np.testing.assert_array_equal(fb & bit, fa & bit)
    # The JAX stage's residual and robust mean, to find pixels near the threshold:
    resid = jax_resid(np.nan_to_num(images), sumimage.astype(np.float32))
    order = np.random.default_rng(0).permutation(len(resid))
    meds = [np.nanmedian(resid[np.sort(order[k:k + 25])], axis=0)
            for k in range(0, len(resid), 25)]
    mean_she = np.mean([np.nan_to_num(m).astype(np.float64) for m in meds], axis=0)
    margin = np.abs(np.abs(resid - mean_she) - 40.0)
    bit = PixelQualityFlags.BackgroundShenanigans
    differ = (fa & bit) != (fb & bit)
    assert not np.any(differ & (margin > EPS_SHEN)), int(differ.sum())
    assert (fa & bit).any()


def test_quality_from_tpf_matches_jax(prepared):
    sim, _, tpf, *_ = prepared
    t0, t1 = sim.time - 900 / 86400, sim.time + 900 / 86400
    np.testing.assert_array_equal(prep.quality_from_tpf(tpf, t0, t1),
                                  jax_quality_from_tpf(tpf, t0, t1))


def _aperture(folder, sids):
    ctx = SectorContext(folder, 1, 3, 2, device="cpu")
    tasks = [{"priority": i + 1, "starid": s, "method": "aperture", "datasource": "ffi"}
             for i, s in enumerate(sids)]
    try:
        return photometry_batch(ctx, tasks, save=False)
    finally:
        ctx.close()


def test_cube_is_read_by_both_packages(prepared):
    """The JAX package opens the port's cube and the port the JAX one; the
    port's aperture photometry gives the same statuses and light curves on
    both cubes, to tests/test_torch_slice.py's flux tolerance."""
    sim, _, _, out, pj, pt = prepared
    with JaxCube(pt) as a, ImageCube(pj) as b:
        assert a.is_done("wcs_ref") and b.is_done("wcs_ref")
        np.testing.assert_array_equal(a.reference_wcs().crpix, b.reference_wcs().crpix)
        np.testing.assert_array_equal(a.pixelflags().shape, b.pixelflags().shape)
    sids = [int(s) for s in sim.starid[:12]]
    on_jax, on_torch = _aperture(out["jax"], sids), _aperture(out["torch"], sids)
    n_ok = 0
    for g, w in zip(on_torch, on_jax):
        assert g.status == w.status, g.starid
        if w.status not in (STATUS.OK, STATUS.WARNING):
            continue
        n_ok += 1
        np.testing.assert_array_equal(g.mask, w.mask, err_msg=str(g.starid))
        for k in ("flux", "flux_err", "flux_background"):
            np.testing.assert_allclose(g.lightcurve[k], w.lightcurve[k], rtol=RTOL, atol=ATOL,
                                       equal_nan=True, err_msg=f"{g.starid} {k}")
    assert n_ok >= 9


@pytest.mark.parametrize("window,chunk", [(3, 4), (9, 5), (9, 64)])
def test_streamed_smoothing_matches_single_shot(window, chunk):
    """The port's counterpart of test_smooth_backgrounds_in_place_matches_global,
    on the in-memory store chip_smoke.py runs the stage into: block k's
    result overwrites the raw frames block k+1 needs as its left halo, so
    those are carried; only float32 running-sum order differs."""
    rng = np.random.default_rng(5)
    raw = (100 + 10 * rng.standard_normal((17, 24, 24))).astype(np.float32)
    raw[3, 5, 5] = np.nan
    cube = DictCube(raw.shape[0], raw.shape[1:])
    cube.write_block("backgrounds", 0, raw)
    prep.smooth_backgrounds(cube, window, chunk, "cpu")
    want = time_moving_nanmean(torch.from_numpy(raw), window).numpy()
    np.testing.assert_allclose(cube.backgrounds(), want, rtol=2e-6, atol=1e-4)


def test_streamed_chunks_match_single_shot(tmp_path):
    """prepare_one with chunk 4 (< T) matches one chunk: halos, carries and the
    scratch stack cross chunk boundaries (tests/test_prepare.py:145)."""
    small = simulate_sector(SimConfig(shape=(64, 64), n_times=14, n_stars=12, seed=21))
    cubes = {}
    for chunk in (4, 64):
        d = str(tmp_path / f"chunk{chunk}")
        small.write_ffis(d)
        cubes[chunk] = prep.prepare_one(d, 1, 3, 2, chunk=chunk, device="cpu")
    with ImageCube(cubes[4]) as a, ImageCube(cubes[64]) as b:
        np.testing.assert_allclose(a.backgrounds(), b.backgrounds(), rtol=1e-3, atol=0.05)
        np.testing.assert_array_equal(a.pixelflags(), b.pixelflags())
        np.testing.assert_allclose(np.nan_to_num(a.images()), np.nan_to_num(b.images()),
                                   rtol=1e-3, atol=0.05)
        assert "_scratch_resid" not in a.h5


def test_cli_resumes_and_refuses_movement_kernels(prepared, tmp_path, capsys, monkeypatch):
    """The CLI resumes a prepared cube; ``--movement-kernel`` then runs only
    stage 6 on it (stages 1-5 are not re-run), and a second run resumes
    without registering again."""
    _, d, _, out, _, pt = prepared
    mtime = os.path.getmtime(pt)
    assert prepare_cmd.main(["-q", "--device", "cpu", "-o", out["torch"], d]) == 0
    assert capsys.readouterr().out.split() == [pt]
    with ImageCube(pt) as cube:
        assert all(cube.is_done(s) for s in prep.STAGES) and not cube.is_done("movement")
    assert os.path.getmtime(pt) >= mtime

    resumed = str(tmp_path / os.path.basename(pt))
    shutil.copyfile(pt, resumed)

    def refuse(*a, **k):
        raise AssertionError("a finished stage ran again")

    monkeypatch.setattr(prep, "background_flags", refuse)
    assert prepare_cmd.main(["-q", "--device", "cpu", "--movement-kernel", "-o",
                             str(tmp_path), d]) == 0
    assert capsys.readouterr().out.split() == [resumed]
    with ImageCube(resumed) as cube:
        assert cube.is_done("movement")
        k = np.asarray(cube.h5["movement_kernel"])
        ref = int(cube.h5["movement_kernel"].attrs["ref_frame"])
        assert k.shape == (16, 2) and k.dtype == np.float64
        assert ref == int(cube.attrs["WCS_REF_FRAME"])
        assert np.abs(k[ref]).max() < 0.005 and np.abs(k).max() < 0.5
    monkeypatch.setattr(prep.MotionModel, "calc_kernels_batch", refuse)
    assert prepare_cmd.main(["-q", "--device", "cpu", "--movement-kernel", "-o",
                             str(tmp_path), d]) == 0
    with ImageCube(resumed) as cube:
        np.testing.assert_array_equal(np.asarray(cube.h5["movement_kernel"]), k)


@pytest.fixture(scope="module")
def moved(tmp_path_factory):
    """tests/test_prepare.py:172's sim prepared with movement kernels by both packages."""
    base = tmp_path_factory.mktemp("torch_movement")
    sim = simulate_sector(SimConfig(shape=(64, 64), n_times=6, n_stars=15, seed=3,
                                    jitter_amp=0.3))
    d = str(base / "in")
    sim.write_ffis(d)
    out = {}
    for name in ("jax", "torch"):
        out[name] = str(base / name)
        sim.write_catalog(out[name])
    (pj,) = jax_prepare(d, output_folder=out["jax"], calc_movement_kernel=True)
    (pt,) = prep.prepare_photometry(d, output_folder=out["torch"], device="cpu",
                                    calc_movement_kernel=True)
    return sim, out, pj, pt


def test_movement_kernel_stage_matches_jax(moved):
    sim, _, pj, pt = moved
    with JaxCube(pj) as a, ImageCube(pt) as b:
        da, db = a.h5["movement_kernel"], b.h5["movement_kernel"]
        assert (db.dtype, db.shape) == (da.dtype, da.shape) == (np.float64, (6, 2))
        assert dict(db.attrs) == dict(da.attrs)
        assert db.attrs["warpmode"] == "translation"
        ref = int(db.attrs["ref_frame"])
        assert ref == int(b.attrs["WCS_REF_FRAME"])
        assert b.h5.attrs["_stages_done"] == a.h5.attrs["_stages_done"] == \
            ",".join(sorted(prep.STAGES + ("movement",)))
        k = np.asarray(db)
        np.testing.assert_allclose(k, np.asarray(da), rtol=0, atol=KERNEL_ATOL)
    # tests/test_prepare.py:172's bounds against the injected jitter:
    np.testing.assert_allclose(k[ref], [0, 0], atol=0.02)
    np.testing.assert_allclose(k[:, 0], sim.jitter[:, 1] - sim.jitter[ref, 1], atol=0.08)
    np.testing.assert_allclose(k[:, 1], sim.jitter[:, 0] - sim.jitter[ref, 0], atol=0.08)


def test_movement_kernel_cubes_give_jax_jitter(moved):
    """Either package opens the other's cube with its kernel series
    (``motion_mode`` other than "wcs"), and the port's SectorContext gives
    the JAX SectorContext's per-cadence jitter on both cubes."""
    sim, out, *_ = moved
    rng = np.random.default_rng(2)
    cols, rows = rng.uniform(0, 64, 7), rng.uniform(0, 64, 7)
    for mine, theirs in (("torch", "jax"), ("jax", "torch"), ("torch", "torch")):
        tctx = SectorContext(out[mine], 1, 3, 2, motion_mode="kernel", device="cpu")
        jctx = JaxContext(out[theirs], 1, 3, 2, motion_mode="kernel")
        try:
            assert tctx.motion.warpmode == jctx.motion.warpmode == "translation"
            tt = tctx.time - tctx.timecorr
            got = tctx.motion.jitter_batch(tt, cols, rows)
            want = jctx.motion.jitter_batch(jctx.time - jctx.timecorr, cols, rows)
            assert got.shape == (6, 7, 2)
            np.testing.assert_allclose(got, want, rtol=0, atol=KERNEL_ATOL + 1e-6)
        finally:
            tctx.close()
            jctx.close()


def test_prepare_photometry_process_split(monkeypatch):
    files = [f"ffi_1_{cam}_{ccd}.fits" for cam in (1, 2) for ccd in (1, 2)]
    monkeypatch.setattr(prep.discovery, "find_ffi_files", lambda d: files)
    monkeypatch.setattr(prep.discovery, "parse_ffi_filename",
                        lambda f: dict(zip(("sector", "camera", "ccd"),
                                           map(int, f[:-5].split("_")[1:]))))
    seen = []

    def fake_prepare_one(inp, sector, camera, ccd, output_folder=None, device=None, **kw):
        seen.append((sector, camera, ccd))
        return f"{sector}-{camera}-{ccd}"

    monkeypatch.setattr(prep, "prepare_one", fake_prepare_one)
    out0 = prep.prepare_photometry("x", process_id=0, process_count=2)
    out1 = prep.prepare_photometry("x", process_id=1, process_count=2)
    assert out0 == ["1-1-1", "1-2-1"] and out1 == ["1-1-2", "1-2-2"]
    assert sorted(seen) == [(1, 1, 1), (1, 1, 2), (1, 2, 1), (1, 2, 2)]
    for bad in ({"process_id": 0}, {"process_id": 2, "process_count": 2},
                {"process_id": 0, "process_count": 0}):
        with pytest.raises(ValueError):
            prep.prepare_photometry("x", **bad)
    seen.clear()
    assert prep.prepare_photometry("x", cameras=[2]) == ["1-2-1", "1-2-2"]


def test_prepare_one_without_ffis_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        prep.prepare_one(str(tmp_path), 1, 3, 2, device="cpu")
    shutil.rmtree(tmp_path, ignore_errors=True)


# -- Stage 2 against the frame-by-frame numpy arithmetic, bit for bit ---------

#: Each case: the chunk size and what its frames carry.  The sim has 7 frames.
IMAGE_CASES = {
    "one_chunk": dict(chunk=7),
    "partial_last_chunk": dict(chunk=3),
    "backapp": dict(chunk=4, backapp=(2, 5)),
    "no_uncert": dict(chunk=4, no_uncert=(1, 6)),
    "bad_quality": dict(chunk=4, quality={1: 4, 3: 128, 4: 2048}),
    "nan_and_manual_exclude": dict(chunk=3, nan=True),
    "all_at_once": dict(chunk=2, backapp=(2,), no_uncert=(1, 6), quality={4: 4}, nan=True),
}


@pytest.fixture(scope="module")
def image_files(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("images_stage"))
    sim = simulate_sector(SimConfig(shape=(24, 32), n_times=7, n_stars=6, seed=3))
    sim.write_ffis(d)
    from photometry_tpu_torch.io.discovery import find_ffi_files
    return find_ffi_files(d)


def _image_inputs(files, case):
    """The case's frames (read from the sim's files, then altered), and the
    backgrounds and pixel flags stage 1 would have stored."""
    from photometry_tpu_torch.io.tess import read_ffi
    frames = [read_ffi(f) for f in files]
    T, (H, W) = len(frames), frames[0].data.shape
    rng = np.random.default_rng(len(case) + case["chunk"])
    bkg = (80 + 5 * rng.standard_normal((T, H, W))).astype(np.float32)
    flags = (rng.random((T, H, W)) < 0.3).astype(np.uint8) * PixelQualityFlags.NotUsedForBackground
    flags |= (rng.random((T, H, W)) < 0.05).astype(np.uint8) * PixelQualityFlags.ManualExclude
    # a pixel whose float64 sum depends on the order of its additions:
    for k, f in enumerate(frames):
        f.data[0, 5] = (2.0 ** 57, 1, -2.0 ** 57, 1, 2.0 ** 55, 3, -2.0 ** 55)[k]
        flags[k, 0, 5] = 0
    for k in case.get("backapp", ()):
        frames[k].header["BACKAPP"] = True
    for k in case.get("no_uncert", ()):
        frames[k].uncertainty = None
        frames[k].data[0, :4] = [-3.5, np.nan, -0.0, np.inf]     # sqrt(|x|) of each
    for k, q in case.get("quality", {}).items():
        frames[k].header["DQUALITY"] = q
    if case.get("nan"):
        for k, f in enumerate(frames):
            f.data[rng.random((H, W)) < 0.05] = np.nan
            f.data[k, 3] = np.inf
        bkg[3, 5, 7] = np.nan                                    # a CAL pixel it is taken from
        flags[2, :, :5] |= PixelQualityFlags.ManualExclude
        flags[5] |= PixelQualityFlags.ManualExclude              # a whole frame
    return frames, bkg, flags


def _images_numpy(frames, bkg, flags, threshold):
    """The stage's arithmetic as numpy did it, one frame at a time."""
    T, (H, W) = len(frames), frames[0].data.shape
    images, errors = np.empty((T, H, W), np.float32), np.empty((T, H, W), np.float32)
    quality = np.zeros(T, np.int32)
    sumimage, n_img = np.zeros((H, W), np.float64), np.zeros((H, W), np.int32)
    used_in_bkg = np.zeros((H, W), np.int64)
    wcs = []
    for k, frame in enumerate(frames):
        hdr = frame.header
        quality[k] = hdr.get("DQUALITY", hdr.get("QUAL_BIT", 0))
        flux = frame.data.astype(np.float32)
        err = (frame.uncertainty if frame.uncertainty is not None
               else np.sqrt(np.abs(flux))).astype(np.float32)
        if not hdr.get("BACKAPP", False):
            flux = flux - bkg[k]
        excl = ~PixelQualityFlags.filter(flags[k])
        flux[excl] = np.nan
        err[excl] = np.nan
        images[k], errors[k] = flux, err
        ok = frame.wcs is not None and prep._wcs_roundtrip_ok(frame.wcs, (H, W))
        wcs.append(frame.wcs.to_header().to_bytes().decode("ascii") if ok else "")
        if TESSQualityFlags.filter(quality[k]):
            finite = np.isfinite(flux)
            n_img += finite
            sumimage += np.where(finite, flux, 0.0)
        used_in_bkg += (flags[k] & PixelQualityFlags.NotUsedForBackground) == 0
    with np.errstate(invalid="ignore"):
        sumimage /= n_img
    hdrs = [f.header for f in frames]
    return {"images": images, "images_err": errors, "sumimage": sumimage,
            "pixels_used": (used_in_bkg / T > threshold).astype(np.uint8), "wcs": wcs,
            "quality": quality,
            "cadenceno": np.array([h["FFIINDEX"] for h in hdrs], np.int32),
            "timecorr": np.array([h.get("BARYCORR", 0) for h in hdrs], np.float32),
            "time_start": np.array([h["TSTART"] for h in hdrs], np.float64),
            "time_stop": np.array([h["TSTOP"] for h in hdrs], np.float64),
            "time": np.array([0.5 * (h["TSTART"] + h["TSTOP"]) for h in hdrs], np.float64)}


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view({1: np.uint8, 4: np.uint32, 8: np.uint64}[a.dtype.itemsize])


@pytest.mark.parametrize("case", list(IMAGE_CASES))
def test_images_stage_equals_frame_by_frame_numpy_bit_for_bit(image_files, case, monkeypatch):
    """Stage 2's chunked torch arithmetic writes the bytes the frame-by-frame
    numpy formulation makes: images, errors (NaN in the same places, with
    the same bits), the float64 sum image added in frame order, the pixels
    used, the vectors and the WCS strings."""
    spec = IMAGE_CASES[case]
    frames, bkg, flags = _image_inputs(image_files, spec)
    want = _images_numpy(frames, bkg, flags, 0.5)
    T, (H, W) = len(frames), frames[0].data.shape
    cube = DictCube(T, (H, W))
    cube.write_block("backgrounds", 0, bkg)
    cube.write_block("pixelflags", 0, flags)
    monkeypatch.setattr(prep, "iter_frames", lambda files: iter(frames))
    prep._images_stage(cube, image_files, frames[0], 1, 3, 2, spec["chunk"], 0.5,
                       torch.device("cpu"))
    for k in ("images", "images_err"):
        np.testing.assert_array_equal(_bits(cube.arrays[k]), _bits(want[k]), err_msg=k)
    np.testing.assert_array_equal(_bits(cube.sumimage), _bits(want["sumimage"]))
    np.testing.assert_array_equal(cube.pixels_used, want["pixels_used"])
    assert 0 < want["pixels_used"].sum() < H * W                # both answers occur
    assert cube.wcs_strings() == want["wcs"] and all(want["wcs"])
    start, stop = cube.time_bounds()
    attrs = {"DATA_REL": 99, "PROCVER": frames[0].header.get("PROCVER"), "CAMERA": 3, "CCD": 2}
    for k, got in (("quality", cube.quality), ("cadenceno", cube.cadenceno),
                   ("timecorr", cube.timecorr), ("time_start", start), ("time_stop", stop),
                   ("time", cube.time)):
        ref = want[k]
        if k.startswith("time") and k != "timecorr":
            pos = {"time": "mid", "time_start": "start", "time_stop": "end"}[k]
            ref = prep.time_offset(ref, attrs, datatype="ffi", timepos=pos)
        np.testing.assert_array_equal(_bits(got), _bits(ref), err_msg=k)
    assert "images" in cube.stages and "TIME_OFFSET_CORRECTED" in cube.attrs
