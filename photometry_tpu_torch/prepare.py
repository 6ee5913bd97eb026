"""
Prepare stage: FFI FITS files -> one image cube per sector-CCD, on torch.

Port of ``photometry_tpu/prepare.py`` (reference photometry/prepare.py:79-706):

1. backgrounds: each chunk of frames is fit in one batched device program
   (``ops/background.py``; the ring-mode histograms run the
   segment-histogram kernel on a card) and flagged NotUsedForBackground /
   ManualExclude; the backgrounds are then smoothed in time by a moving
   nanmean, streamed through the cube with halos (prepare.py:309-338);
2. images: background-subtracted flux and errors, computed on the device a
   chunk at a time from pinned staging planes, time vectors, per-frame WCS
   (round-trip validated), the sum image of quality-good frames;
3. Background Shenanigans: every frame's residual against the sum image is
   15 x 15 median filtered (the median kernel on a card) into a scratch
   stack, compared with a robust mean image (the mean of medians over
   shuffled 25-frame blocks) and flagged beyond 40 e-/s (prepare.py:514-622);
4. quality flags transferred from up to 5 TPFs (prepare.py:629-654);
5. the WCS reference frame: the quality-good frame nearest the sector's
   reference time (prepare.py:661-676);
6. optional (``calc_movement_kernel``): movement kernels, one ECC
   translation per frame against the reference frame, registered on the
   device in frame sub-batches (``core/motion.py``, ``ops/registration.py``;
   prepare.py:678-698).

:func:`prepare_one` opens the HDF5 cube (``io/cube.py``; ``h5py`` is
imported there, lazily) and hands it to :func:`prepare_cube`, which runs
the stages through the cube's methods only, so any object with those
methods can stand in for the file.  The device work of a chunk sits in
:func:`background_flags`, :func:`smooth_backgrounds` and
:func:`shenanigans_flags`, which take and return tensors on the given
device.
"""

from __future__ import annotations

import contextlib
import logging
import os
import sqlite3
from typing import Optional

import numpy as np
import torch

from .core.motion import MotionModel
from .core.pixelflags import manual_exclude_mask, shenanigans_residual
from .device import resolve_device
from .fixes import time_offset
from .io import discovery
from .io.loader import iter_frames
from .io.settings import sector_info
from .io.tess import read_ffi, read_tpf
from .ops.background import estimate_background, radial_coordinates
from .ops.filters import time_moving_nanmean
from .quality import PixelQualityFlags, TESSQualityFlags
from .utils.mathutils import nanmedian
from .utils.profiling import StageTimer, count, span

logger = logging.getLogger(__name__)

__all__ = ["prepare_photometry", "prepare_one", "prepare_cube", "quality_from_tpf",
           "background_flags", "smooth_backgrounds", "shenanigans_flags", "STAGES"]

#: Stage markers of a prepared cube, in the order they are set (stage 6,
#: optional, adds "movement").
STAGES = ("backgrounds", "images", "shenanigans", "quality_tpf", "wcs_ref")

_SHEN_BLOCK = 25       #: frames per block of the robust mean (prepare.py:549-573)


def quality_from_tpf(tpffile: str, time_start, time_end) -> np.ndarray:
    """Transfer FFI-relevant quality flags from one TPF to FFI time bins."""
    tpf = read_tpf(tpffile)
    t = tpf.time - tpf.timecorr
    q = tpf.quality
    n = len(time_start)
    out = np.zeros(n, np.int32)
    order = np.argsort(t)
    t = t[order]
    q = q[order]
    lo = np.searchsorted(t, time_start, side="right")
    hi = np.searchsorted(t, time_end, side="left")
    for k in range(n):
        if hi[k] > lo[k]:
            out[k] = np.bitwise_or.reduce(q[lo[k]:hi[k]])
    return out & TESSQualityFlags.FFI_RELEVANT_BITMASK


def _catalog_source_mask(input_folder: str, sector: int, camera: int, ccd: int, shape, wcs,
                         tmag_limit: float = 15.0) -> Optional[np.ndarray]:
    """Boolean (H, W) mask of catalog-star footprints, True = exclude.

    Bright-star wings inside the SExtractor-mode tiles bias the background
    low; known catalog sources are masked with a brightness-scaled radius
    (1.5-16 px) and the mesh's NaN-tile fill bridges over-masked tiles.
    None when no catalog or usable WCS is available (the reference's
    behaviour then).
    """
    cats = discovery.find_catalog_files(input_folder, sector=sector, camera=camera, ccd=ccd)
    if not cats or wcs is None:
        return None
    try:
        with contextlib.closing(sqlite3.connect("file:%s?mode=ro" % cats[0], uri=True)) as conn:
            rows = conn.execute("SELECT ra, decl, tmag FROM catalog WHERE tmag < ?",
                                (tmag_limit,)).fetchall()
    except sqlite3.Error:
        return None
    if not rows:
        return None
    arr = np.asarray(rows, np.float64)
    row, col = wcs.rowcol_of_radec(arr[:, 0], arr[:, 1])
    flux = np.maximum(10.0 ** (-0.4 * (arr[:, 2] - 20.54)), 10.0)
    rad = np.clip(1.5 * np.sqrt(np.log10(flux)), 1.5, 16.0)
    H, W = shape
    mask = np.zeros((H, W), bool)
    for r0, c0, rr in zip(row, col, rad):
        if not (np.isfinite(r0) and np.isfinite(c0)):
            continue
        if r0 < -rr or r0 > H - 1 + rr or c0 < -rr or c0 > W - 1 + rr:
            continue
        y0, y1 = max(0, int(r0 - rr)), min(H, int(r0 + rr) + 2)
        x0, x1 = max(0, int(c0 - rr)), min(W, int(c0 + rr) + 2)
        yy, xx = np.ogrid[y0:y1, x0:x1]
        mask[y0:y1, x0:x1] |= ((yy - r0) ** 2 + (xx - c0) ** 2) < rr * rr
    return mask


def _wcs_roundtrip_ok(wcs, shape) -> bool:
    """Validate a WCS by projecting a corner out and back (prepare.py:433-447)."""
    if wcs is None:
        return False
    try:
        ra, dec = wcs.pixel_to_world(np.array([1.0]), np.array([1.0]))
        x, y = wcs.world_to_pixel(ra, dec)
        return bool(np.isfinite(x[0]) and np.isfinite(y[0])
                    and abs(x[0] - 1.0) < 0.1 and abs(y[0] - 1.0) < 0.1)
    except (ValueError, FloatingPointError, np.linalg.LinAlgError):
        return False


def _cube_header(first, sector: int, camera: int, ccd: int) -> dict:
    """The cube's header attributes, from the first frame's header."""
    hdr0 = first.header
    return {
        "SECTOR": sector, "CAMERA": camera, "CCD": ccd,
        "CADENCE": sector_info(sector).ffi_cadence,
        "DATA_REL": hdr0.get("DATA_REL", 99),
        "PROCVER": hdr0.get("PROCVER", ""),
        "NUM_FRM": hdr0.get("NUM_FRM", 900),
        "READNOIS": hdr0.get("READNOIS", 10.0),
        "GAIN": hdr0.get("GAIN", 5.2),
        "NREADOUT": hdr0.get("NREADOUT", 0),
        # PSF width hint of the analytic-Gaussian PRF; absent on SPOC FFIs:
        "PSFSIGMA": hdr0.get("PSFSIGMA"),
        "PIXEL_OFFSET_ROW": 0,
        "PIXEL_OFFSET_COLUMN": 44 if first.is_tess else 0,
    }


# ---------------------------------------------------------------------------
# Device work of a chunk
# ---------------------------------------------------------------------------

def background_flags(stack: torch.Tensor, manex: torch.Tensor, source_mask=None,
                     radius_image=None, tile: int = 64, flux_cutoff: float = 8e4,
                     hist_stride: Optional[int] = None, plain: bool = False):
    """Backgrounds and flags of a (F, H, W) chunk, on its device.

    ``manex`` (F, H, W) bool: manual excludes; ``source_mask`` (H, W) bool:
    catalog footprints.  Returns the float32 backgrounds and the uint8
    NotUsedForBackground | ManualExclude flags.  ``plain`` runs the plain
    versions of the kernels (comparisons on the card).
    """
    exclude = manex if source_mask is None else (manex | source_mask)
    bkg, mask_used = estimate_background(stack, mask=exclude, flux_cutoff=flux_cutoff,
                                         radius_image=radius_image, tile=tile,
                                         hist_stride=hist_stride, plain=plain)
    flags = (torch.where(mask_used, PixelQualityFlags.NotUsedForBackground, 0)
             | torch.where(manex, PixelQualityFlags.ManualExclude, 0)).to(torch.uint8)
    return bkg, flags


def smooth_backgrounds(cube, window: int, chunk: int, device) -> None:
    """Time-smooth the cube's backgrounds in place, streamed chunk by chunk.

    The moving nanmean with shrinking edge windows runs per chunk with full
    ``window // 2``-frame halos, so it matches smoothing the whole stack at
    once up to float32 running-sum rounding.  Writing chunk k's result
    overwrites the raw frames chunk k+1 needs as its left halo, so those
    are carried in host memory; the right halo is read from the tail not
    yet overwritten.  Host memory stays O(chunk H W).
    """
    T = cube.n_times
    H, W = cube.shape
    half = window // 2
    left = np.empty((0, H, W), np.float32)
    for t0 in range(0, T, chunk):
        t1 = min(t0 + chunk, T)
        mid = cube.backgrounds(t0, t1)
        right = cube.backgrounds(t1, min(T, t1 + half)) if t1 < T and half > 0 else mid[:0]
        blk = np.concatenate([left, mid, right], axis=0)
        sm = time_moving_nanmean(torch.from_numpy(blk).to(device), window).cpu().numpy()
        off = left.shape[0]
        cube.write_block("backgrounds", t0, sm[off:off + (t1 - t0)])
        carry = np.concatenate([left, mid], axis=0)
        left = carry[-half:] if half > 0 else carry[:0]


def shenanigans_flags(flags: torch.Tensor, resid: torch.Tensor, mean_she: torch.Tensor,
                      threshold: float) -> torch.Tensor:
    """BackgroundShenanigans set where |residual - robust mean| > threshold
    (float64, as numpy compares float32 residuals with the float64 mean)."""
    she = torch.abs(resid.to(torch.float64) - mean_she) > threshold
    bit = PixelQualityFlags.BackgroundShenanigans
    return (flags & ~np.uint8(bit)) | torch.where(she, bit, 0).to(torch.uint8)


# ---------------------------------------------------------------------------
# The stages
# ---------------------------------------------------------------------------

def prepare_cube(cube, files, input_folder: str, sector: int, camera: int, ccd: int,
                 device="cuda", calc_movement_kernel: bool = False, chunk: int = 64,
                 backgrounds_pixels_threshold: float = 0.5, bkgshe_threshold: float = 40.0,
                 flux_cutoff: float = 8e4, tile: Optional[int] = None,
                 hist_stride: Optional[int] = None) -> dict:
    """Run stages 1-5, and stage 6 with ``calc_movement_kernel``, on an open
    cube (or a stand-in with its methods).

    ``files`` are the sector-CCD's FFIs in time order.  Returns the wall
    seconds of each stage this call ran (``backgrounds_fit``,
    ``backgrounds_smooth``, ``images``, ``shenanigans``, ``quality_tpf``,
    ``movement``), the seconds stages 1 and 2 waited on the frame loader
    (``frames.read``), the bytes of HDU data read from FITS files
    (``fits_bytes``; ``fits_table_bytes`` those of numeric table columns,
    stage 4's TPF) and the frames whose stage-2 arithmetic ran on the torch
    device (``images_device_frames``): the spans and counters
    (``utils.profiling``) of the recorder this call opens on the dict it
    returns.
    """
    dev = resolve_device(device)
    T = len(files)
    cadence = sector_info(sector).ffi_cadence
    time_smooth = {1800: 3, 600: 9, 200: 27}.get(cadence, 3)
    walls = {}
    with StageTimer(walls).recording():
        first = read_ffi(files[0])
        H, W = first.data.shape

        radius_image = None
        if camera is not None and ccd is not None:
            # Flight frames carry the +44 column offset; simulated/cropped ones
            # are in science coordinates.  Sub-CCD frames get the corner-ring
            # fallback of estimate_background.
            radius_image = radial_coordinates((H, W), camera, ccd,
                                              col_offset=44 if first.is_tess else 0)
        if tile is None:
            # 64 px tiles on full CCDs; at least ~6x6 tiles on smaller frames.
            tile = int(min(64, max(8, min(H, W) // 6)))
        source_mask = _catalog_source_mask(
            input_folder, sector, camera, ccd, (H, W),
            first.wcs if _wcs_roundtrip_ok(first.wcs, (H, W)) else None)
        if source_mask is not None:
            logger.info("Masking %.1f%% of pixels as catalog sources for the background fit.",
                        100.0 * source_mask.mean())
            source_mask = torch.from_numpy(source_mask).to(dev)

        # -- Stage 1: backgrounds and NotUsedForBackground / ManualExclude flags --
        if not cube.is_done("backgrounds"):
            logger.info("Fitting backgrounds for %d frames...", T)
            with span("backgrounds_fit"):
                frames = iter_frames(files)
                for t0 in range(0, T, chunk):
                    t1 = min(t0 + chunk, T)
                    stack = np.empty((t1 - t0, H, W), np.float32)
                    manex = np.zeros((t1 - t0, H, W), bool)
                    for i in range(t1 - t0):
                        with span("frames.read"):
                            frame = next(frames)
                        stack[i] = frame.data
                        manex[i] = manual_exclude_mask(frame.data, frame.header, frame.is_tess)
                    bkg, flags = background_flags(
                        torch.from_numpy(stack).to(dev), torch.from_numpy(manex).to(dev),
                        source_mask, radius_image=radius_image, tile=tile,
                        flux_cutoff=flux_cutoff, hist_stride=hist_stride)
                    cube.write_block("backgrounds", t0, bkg.cpu().numpy())
                    cube.write_block("pixelflags", t0, flags.cpu().numpy())
            logger.info("Smoothing backgrounds in time (window %d)...", time_smooth)
            with span("backgrounds_smooth"):
                smooth_backgrounds(cube, time_smooth, chunk, dev)
                cube.attrs["time_smooth"] = time_smooth
                cube.attrs["bkgshe_threshold"] = bkgshe_threshold
                cube.mark_done("backgrounds")

        # -- Stage 2: images, vectors, WCS, sumimage ----------------------------
        if not cube.is_done("images"):
            logger.info("Processing individual images...")
            with span("images"):
                _images_stage(cube, files, first, sector, camera, ccd, chunk,
                              backgrounds_pixels_threshold, dev)

        # -- Stage 3: Background Shenanigans ------------------------------------
        if not cube.is_done("shenanigans"):
            logger.info("Detecting background shenanigans...")
            with span("shenanigans"):
                _shenanigans_stage(cube, chunk, bkgshe_threshold, dev)

        # -- Stage 4: quality transfer from TPFs --------------------------------
        if not cube.is_done("quality_tpf"):
            with span("quality_tpf"):
                tpffiles = discovery.find_tpf_files(input_folder, sector=sector,
                                                    camera=camera, ccd=ccd, findmax=5)
                if tpffiles:
                    quality = cube.quality.copy()
                    timecorr = cube.timecorr
                    time_start, time_stop = cube.time_bounds()
                    q_tpf = np.zeros(T, np.int32)
                    for f in tpffiles:
                        q_tpf |= quality_from_tpf(f, time_start - timecorr,
                                                  time_stop - timecorr)
                    cube.write_vectors(quality=quality | q_tpf)
                else:
                    logger.warning("No TPF files found; quality flags not propagated.")
                cube.mark_done("quality_tpf")

        # -- Stage 5: WCS reference frame ---------------------------------------
        if not cube.is_done("wcs_ref"):
            ref_tjd = sector_info(sector).reference_time - 2457000
            time = cube.time
            wcs_ok = np.array([bool(s.strip()) for s in cube.wcs_strings()])
            good = (cube.quality == 0) & wcs_ok
            if not np.any(good):
                raise RuntimeError("No good frames for WCS reference")
            cand = np.where(good)[0]
            cube.attrs["WCS_REF_FRAME"] = int(cand[np.argmin(np.abs(time[cand] - ref_tjd))])
            cube.mark_done("wcs_ref")

        # -- Stage 6: movement kernels (optional) -------------------------------
        if calc_movement_kernel and not cube.is_done("movement"):
            logger.info("Calculating image movement kernels (batched ECC)...")
            with span("movement"):
                refindx = int(cube.attrs["WCS_REF_FRAME"])
                ref_img = np.nan_to_num(cube.images(refindx, refindx + 1)[0])
                mm = MotionModel(warpmode="translation", image_ref=ref_img)
                kernels = np.empty((T, mm.n_params), np.float64)
                for t0 in range(0, T, chunk):
                    t1 = min(t0 + chunk, T)
                    imgs = np.nan_to_num(cube.images(t0, t1), copy=False)
                    kernels[t0:t1] = mm.calc_kernels_batch(imgs, device=dev)
                cube.write_movement_kernel(kernels, "translation", refindx)
                cube.mark_done("movement")
    return walls


def _images_stage(cube, files, first, sector, camera, ccd, chunk,
                  backgrounds_pixels_threshold, dev) -> None:
    """Stage 2: subtract the backgrounds, blank excluded pixels, store the
    time vectors, WCS strings and the sum image of quality-good frames.

    As each frame arrives, its header's vectors and WCS string are taken and
    its CAL and UNCERT copied into two staging planes of ``chunk`` frames
    (pinned on a card), allocated once a call and reused by every chunk.
    Each chunk is uploaded once and its arithmetic runs on ``dev`` in one
    batch (:func:`_images_chunk`); its images and errors come back into the
    same planes for ``cube.write_block``, which copies them.  The sum image,
    the frame counts and the background-pixel counts stay on ``dev`` until
    the end.
    """
    T = len(files)
    H, W = first.data.shape
    time = np.empty(T, np.float64)
    timecorr = np.empty(T, np.float32)
    time_start = np.empty(T, np.float64)
    time_stop = np.empty(T, np.float64)
    cadenceno = np.empty(T, np.int32)
    quality = np.zeros(T, np.int32)
    sums = {"sumimage": torch.zeros((H, W), dtype=torch.float64, device=dev),
            "n_img": torch.zeros((H, W), dtype=torch.int32, device=dev),
            "used_in_bkg": torch.zeros((H, W), dtype=torch.int64, device=dev)}
    staged = [torch.empty((min(chunk, T), H, W), dtype=torch.float32,
                          pin_memory=dev.type == "cuda") for _ in range(2)]
    flux_blk, err_blk = (s.numpy() for s in staged)

    frames = iter_frames(files)
    for t0 in range(0, T, chunk):
        t1 = min(t0 + chunk, T)
        subtract = np.zeros(t1 - t0, bool)
        good = np.zeros(t1 - t0, bool)
        for i, k in enumerate(range(t0, t1)):
            with span("frames.read"):
                frame = next(frames)
            hdr = frame.header
            time_start[k] = hdr["TSTART"]
            time_stop[k] = hdr["TSTOP"]
            time[k] = 0.5 * (hdr["TSTART"] + hdr["TSTOP"])
            timecorr[k] = hdr.get("BARYCORR", 0)
            quality[k] = hdr.get("DQUALITY", hdr.get("QUAL_BIT", 0))
            if "FFIINDEX" in hdr:
                cadenceno[k] = hdr["FFIINDEX"]
            elif frame.is_tess:
                raise RuntimeError("Could not determine CADENCENO for TESS data")
            else:
                cadenceno[k] = k + 1
            subtract[i] = not hdr.get("BACKAPP", False)
            good[i] = TESSQualityFlags.filter(quality[k])

            np.copyto(flux_blk[i], frame.data)
            if frame.uncertainty is not None:
                np.copyto(err_blk[i], frame.uncertainty)
            else:
                # no UNCERT HDU: sqrt(|CAL|), made as the plane is staged
                np.sqrt(np.abs(flux_blk[i], out=err_blk[i]), out=err_blk[i])

            wcs_str = ""
            if frame.wcs is not None and _wcs_roundtrip_ok(frame.wcs, (H, W)):
                wcs_str = frame.wcs.to_header().to_bytes().decode("ascii")
            cube.write_frame(k, wcs_str=wcs_str)

        _images_chunk(cube, t0, t1, [s[:t1 - t0] for s in staged], subtract, good, sums, dev)
        count("images_device_frames", t1 - t0)
        cube.write_block("images", t0, flux_blk[:t1 - t0])
        cube.write_block("images_err", t0, err_blk[:t1 - t0])

    sumimage, n_img, used_in_bkg = (sums[k].cpu().numpy()
                                    for k in ("sumimage", "n_img", "used_in_bkg"))
    with np.errstate(invalid="ignore"):
        sumimage /= n_img

    # Time-offset fixes (early data releases):
    hdr0 = first.header
    attributes = {"DATA_REL": hdr0.get("DATA_REL", 99), "PROCVER": hdr0.get("PROCVER", "") or None,
                  "CAMERA": camera, "CCD": ccd}
    time_start = time_offset(time_start, attributes, datatype="ffi", timepos="start")
    time_stop = time_offset(time_stop, attributes, datatype="ffi", timepos="end")
    time, fixed_offset = time_offset(time, attributes, datatype="ffi", timepos="mid",
                                     return_flag=True)
    cube.attrs["TIME_OFFSET_CORRECTED"] = fixed_offset
    cube.write_vectors(time=time, timecorr=timecorr, cadenceno=cadenceno, quality=quality)
    cube.write_time_bounds(time_start, time_stop)
    cube.write_sumimage(sumimage, pixels_used=(used_in_bkg / T > backgrounds_pixels_threshold))
    cube.mark_done("images")


def _images_chunk(cube, t0, t1, staged, subtract, good, sums, dev) -> None:
    """One chunk of stage 2 on ``dev``: ``staged`` (its CAL and UNCERT host
    planes) becomes its images and errors, in place; the chunk's frames are
    added into ``sums``.

    Images are CAL less the backgrounds on the frames where ``subtract``
    holds, errors UNCERT; both NaN where ManualExclude is set.  A NaN
    operand of the subtraction is passed on with its bits, as the host's
    float32 arithmetic passes it (a card's gives its own NaN).  The sum
    image is added in float64 one frame at a time, in frame order, so each
    addition is the one a frame-by-frame sum on the host makes.
    """
    flux, err = (s.to(dev, non_blocking=True) for s in staged)
    bkg = torch.from_numpy(cube.backgrounds(t0, t1)).to(dev)
    flags = torch.from_numpy(cube.pixelflags(t0, t1)).to(dev)
    sub = torch.from_numpy(subtract).to(dev)[:, None, None]
    diff = torch.where(torch.isnan(bkg), bkg, flux - bkg)
    flux = torch.where(sub & ~torch.isnan(flux), diff, flux)
    del diff, bkg
    excl = ~PixelQualityFlags.filter(flags)
    flux.masked_fill_(excl, np.nan)
    err.masked_fill_(excl, np.nan)
    for i in np.flatnonzero(good):
        finite = torch.isfinite(flux[i])
        sums["n_img"] += finite
        sums["sumimage"] += torch.where(finite, flux[i], 0.0)
    sums["used_in_bkg"] += ((flags & PixelQualityFlags.NotUsedForBackground) == 0).sum(dim=0)
    for s, out in zip(staged, (flux, err)):
        s.copy_(out)


def _shenanigans_stage(cube, chunk: int, threshold: float, dev) -> None:
    """Stage 3: median-filtered residuals into the cube's scratch stack, the
    robust mean image, then the flags.  The residuals are needed twice, so
    they spill to the store rather than host memory (~21 GB at full-CCD
    scale); the median filter runs once per frame."""
    T = cube.n_times
    sumimage = torch.from_numpy(cube.sumimage.astype(np.float32)).to(dev)
    cube.create_scratch()
    for t0 in range(0, T, chunk):
        t1 = min(t0 + chunk, T)
        imgs = torch.from_numpy(cube.images(t0, t1)).to(dev)
        resid = shenanigans_residual(torch.nan_to_num(imgs), sumimage)
        cube.write_scratch(t0, resid.cpu().numpy())
    # Robust mean: mean of medians over shuffled blocks of 25 (prepare.py:549-573):
    order = np.random.default_rng(0).permutation(T)
    mean_she = torch.zeros(cube.shape, dtype=torch.float64, device=dev)
    nblocks = 0
    for k in range(0, T, _SHEN_BLOCK):
        idx = np.sort(order[k:k + _SHEN_BLOCK])      # h5py wants increasing indices
        med = nanmedian(torch.from_numpy(cube.read_scratch(idx)).to(dev), dim=0)
        mean_she += torch.nan_to_num(med).to(torch.float64)
        nblocks += 1
    mean_she /= max(nblocks, 1)
    for t0 in range(0, T, chunk):
        t1 = min(t0 + chunk, T)
        flags = torch.from_numpy(cube.pixelflags(t0, t1)).to(dev)
        resid = torch.from_numpy(cube.read_scratch(slice(t0, t1))).to(dev)
        cube.write_block("pixelflags", t0,
                         shenanigans_flags(flags, resid, mean_she, threshold).cpu().numpy())
    cube.delete_scratch()
    cube.mark_done("shenanigans")


def prepare_one(input_folder: str, sector: int, camera: int, ccd: int,
                output_folder: Optional[str] = None, device="cuda", **kw) -> str:
    """Prepare one (sector, camera, ccd) into an image cube file; returns its path.

    Keyword arguments go to :func:`prepare_cube`.
    """
    from .io.cube import ImageCube, cube_filename
    output_folder = output_folder or input_folder
    files = discovery.find_ffi_files(input_folder, sector=sector, camera=camera, ccd=ccd)
    if not files:
        raise FileNotFoundError(f"No FFI files for sector={sector}, camera={camera}, ccd={ccd}")
    first = read_ffi(files[0])
    path = os.path.join(output_folder, cube_filename(sector, camera, ccd))
    os.makedirs(output_folder, exist_ok=True)
    cube = ImageCube.create(path, len(files), first.data.shape,
                            header=_cube_header(first, sector, camera, ccd))
    try:
        prepare_cube(cube, files, input_folder, sector, camera, ccd, device=device, **kw)
        cube.flush()
    finally:
        cube.close()
    logger.info("Prepared %s", path)
    return path


def prepare_photometry(input_folder: str, output_folder: Optional[str] = None,
                       sectors=None, cameras=None, ccds=None,
                       process_id: Optional[int] = None, process_count: Optional[int] = None,
                       device="cuda", **kw) -> list:
    """Prepare every discovered (sector, camera, ccd), each by :func:`prepare_one`.

    Counterpart of reference prepare.py:79-206.  A fleet of hosts splits the
    CCD list statically: pass ``process_id``/``process_count`` together, or
    join a process group first (``parallel.multihost.initialize``) and each
    process takes its round-robin shard, ``combos[rank::world_size]``
    (``multihost.process_shard``).
    """
    combos = set()
    for f in discovery.find_ffi_files(input_folder):
        info = discovery.parse_ffi_filename(f)
        if sectors is not None and info["sector"] not in np.atleast_1d(sectors):
            continue
        if cameras is not None and info["camera"] not in np.atleast_1d(cameras):
            continue
        if ccds is not None and info["ccd"] not in np.atleast_1d(ccds):
            continue
        combos.add((info["sector"], info["camera"], info["ccd"]))
    combos = sorted(combos)
    from .parallel import multihost
    if process_count is not None or process_id is not None:
        if process_count is None or process_id is None:
            raise ValueError("process_id and process_count must be given together")
        combos = multihost.process_shard(combos, process_id, process_count)
    elif multihost.is_initialized():
        combos = multihost.process_shard(combos)
    return [prepare_one(input_folder, sector, camera, ccd, output_folder=output_folder,
                        device=device, **kw)
            for sector, camera, ccd in combos]
