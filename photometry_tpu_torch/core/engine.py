"""
The batched photometry engine, on torch tensors.

Port of ``photometry_tpu/core/engine.py``:

- :class:`SectorContext` holds one sector-CCD's image cubes as tensors on
  an explicit device, in float32 or (``cube_dtype=torch.bfloat16``) in
  bfloat16, or (``cache="host"``) on the host as stored, plus the catalog,
  WCS and motion model.  Both its file constructor and
  :func:`context_from_jax` go through :meth:`SectorContext.from_arrays`.
- :class:`TpfContext` presents a Target Pixel File with the same
  interface: the postage stamp is the "CCD", its WCS stamp-relative.
- :func:`extract_aperture_batch` runs K2P2 aperture photometry for a batch
  of targets, with the reference's stamp-resize retry loop (one round on a
  TPF, whose stamp is the whole postage stamp), stamp and catalog bucket
  ladders, contamination, crowding and statuses, line for line in
  behaviour.  Final extraction goes through
  ``ops.bandext.band_extract_flux_batch`` — the CUDA kernel on the card
  (its float32 or bfloat16 instantiation), the plain gather formulation on
  the CPU — or, for a host cube, through :func:`_extract_flux_streamed`,
  which streams it through the device in chunks of frames, or, for a
  context on a device mesh (``mesh=``, ``parallel/mesh.py``), through
  :func:`_extract_flux_sharded`, which runs the same extraction once per
  (time shard, target shard) block of the mesh.
- :func:`extract_flux_core` is that plain formulation on any device.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..catalog import StarCatalog
from ..device import resolve_device
from ..fixes import time_offset
from ..io import discovery
from ..io.cube import ImageCube
from ..io.settings import load_settings
from ..io.tess import read_tpf
from ..io.wcs import TanWCS
from ..models.k2p2 import K2P2Params, build_masks_batch
from ..ops.bandext import _extract, band_extract_flux_batch, band_sums_plain, band_sums_streamed
from ..parallel.mesh import TARGET_AXIS, TIME_AXIS, make_mesh, shard_cube
from ..parallel.sharded import pad_to_multiple, sharded_band_extract, sharded_extract_flux
from ..quality import TESSQualityFlags
from ..utils.mathutils import mag2flux
from ..utils.profiling import span
from .metrics import compute_metrics_batch, crowding_metrics_batch
from .motion import MotionModel
from .status import STATUS

__all__ = ["SectorContext", "TpfContext", "TargetResult", "extract_aperture_batch",
           "extract_flux_core", "default_stamp_size", "aperture_image", "context_from_jax",
           "DEFAULT_K2P2_PARAMS"]

#: Production K2P2 parameters (reference photometry/AperturePhotometry defaults).
DEFAULT_K2P2_PARAMS = K2P2Params(thresh=0.8, min_no_pixels_in_mask=4,
                                 min_for_cluster=4, ws_blur=0.5, ws_thres=0.0,
                                 ws_footprint=3, segmentation=True,
                                 extend_overflow=True)

#: Tmag -> default stamp size lookup (public TASOC calibration tables,
#: reference BasePhotometry.py:541-556).
_STAMP_TMAG = np.array([0.0, 0.52631579, 1.05263158, 1.57894737, 2.10526316,
                        2.63157895, 3.15789474, 3.68421053, 4.21052632, 4.73684211,
                        5.26315789, 5.78947368, 6.31578947, 6.84210526, 7.36842105,
                        7.89473684, 8.42105263, 8.94736842, 9.47368421, 10.0, 13.0])
_STAMP_HEIGHT = np.array([831.98319063, 533.58494422, 344.0840884, 223.73963332,
                          147.31365728, 98.77856016, 67.95585074, 48.38157414,
                          35.95072974, 28.05639497, 23.043017, 19.85922009,
                          17.83731732, 16.5532873, 15.73785092, 15.21999971,
                          14.89113301, 14.68228285, 14.54965042, 14.46542084, 14.0])
_STAMP_WIDTH = np.array([157.71602062, 125.1238281, 99.99440209, 80.61896267,
                         65.6799962, 54.16166547, 45.28073365, 38.4333048,
                         33.15375951, 28.05639497, 23.043017, 19.85922009,
                         17.83731732, 16.5532873, 15.73785092, 15.21999971,
                         14.89113301, 14.68228285, 14.54965042, 14.46542084, 14.0])


def default_stamp_size(tmag) -> tuple:
    """Default (n_rows, n_cols) of the stamp for a target of magnitude tmag."""
    nr = np.maximum(np.ceil(np.interp(tmag, _STAMP_TMAG, _STAMP_HEIGHT)), 15).astype(int)
    nc = np.maximum(np.ceil(np.interp(tmag, _STAMP_TMAG, _STAMP_WIDTH)), 15).astype(int)
    return nr, nc


# ---------------------------------------------------------------------------
# Context
# ---------------------------------------------------------------------------

#: Frames cast to another dtype at a time (on the target device).
_CAST_FRAMES = 16


def _cube_dtype(cube_dtype) -> torch.dtype:
    """The cubes' torch dtype for ``cube_dtype``: None or float32 (a torch,
    numpy or string spelling), or bfloat16 (``torch.bfloat16``,
    ``"bfloat16"`` or a dtype named so); anything else raises ValueError."""
    if cube_dtype is None:
        return torch.float32
    if isinstance(cube_dtype, torch.dtype):
        name = str(cube_dtype).removeprefix("torch.")
    elif isinstance(cube_dtype, str):
        name = cube_dtype
    else:
        try:
            name = np.dtype(cube_dtype).name
        except TypeError:
            name = repr(cube_dtype)
    if name not in ("float32", "bfloat16"):
        raise ValueError(f"cube_dtype={cube_dtype!r}: need None, float32 or bfloat16")
    return getattr(torch, name)


def _as_tensor(x) -> torch.Tensor:
    """numpy or tensor -> tensor, sharing memory where it can; a numpy
    bfloat16 array (``ml_dtypes``, as from a JAX array) keeps its bits."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.ascontiguousarray(x)
    bf16 = a.dtype.name == "bfloat16"       # numpy has no bfloat16 of its own
    if bf16:
        a = a.view(np.uint16)
    if not a.flags.writeable:       # e.g. a JAX array's host view: torch needs its own copy
        a = a.copy()
    t = torch.from_numpy(a)
    return t.view(torch.bfloat16) if bf16 else t


def _to_bfloat16(x: torch.Tensor) -> torch.Tensor:
    """float32 -> bfloat16 bits as XLA and ml_dtypes make them: rounded to
    nearest even (past bfloat16's range to inf, subnormals kept), a NaN to
    the quiet NaN of its sign.  torch's own cast gives a NaN other bits
    (0xffff on the CPU), so the JAX package's cubes would differ from ours."""
    u = x.to(torch.float32).contiguous().view(torch.int32)
    r = (u + (0x7FFF + ((u >> 16) & 1))) >> 16
    r = torch.where(torch.isnan(x), torch.where(u < 0, 0xFFC0, 0x7FC0), r)
    return r.to(torch.int16).view(torch.bfloat16)


def _on_device(x, dtype, dev) -> torch.Tensor:
    """numpy or tensor -> contiguous tensor of ``dtype`` on ``dev`` (no copy
    if already so), in the span ``context.upload``.  Another dtype is cast
    on ``dev``, ``_CAST_FRAMES`` frames at a time, so no second full-size
    copy is made on the way."""
    t = _as_tensor(x)
    with span("context.upload"):
        if t.dtype == dtype:
            return t.to(dev).contiguous()
        cast = _to_bfloat16 if dtype == torch.bfloat16 else (lambda b: b)
        out = torch.empty(t.shape, dtype=dtype, device=dev)
        for a in range(0, t.shape[0], _CAST_FRAMES):
            out[a:a + _CAST_FRAMES].copy_(cast(t[a:a + _CAST_FRAMES].to(dev)))
        return out


def _on_host(x, dtype=None) -> torch.Tensor:
    """numpy or tensor -> contiguous CPU tensor, sharing a numpy array's
    memory where it can; cast only to ``dtype`` if given."""
    t = _as_tensor(x).cpu()
    return (t if dtype is None else t.to(dtype)).contiguous()


class SectorContext:
    """One sector-CCD: cubes as tensors on ``device`` + catalog + WCS + motion model.

    ``cube_dtype`` (None or float32, or ``torch.bfloat16``) is the dtype of
    the images, errors and backgrounds on the device; pixel flags stay
    uint8 and the sum image float32.  bfloat16 halves the cubes' bytes and
    their reads (the band kernel widens each element and sums in float32):
    the JAX package's preview mode, ~0.1% relative flux error at the 99th
    percentile against float32 (tests/test_engine_extras.py).

    ``cache="host"`` keeps the four cubes on the host as CPU tensors in the
    dtype they are stored in (a cube file's float32: as the JAX package,
    ``cube_dtype`` is kept as an attribute and not applied), for sectors
    larger than the card; the sum image, the collected map and everything
    the extraction builds still go to ``device``, and the final extraction
    streams the cubes through it in chunks of frames
    (:func:`_extract_flux_streamed`).  PSF, linPSF and halo gather their
    stamps on the host and move only those.

    ``mesh`` (a ``parallel.mesh.Mesh`` of devices of ``device``'s type)
    with ``cache="device"`` puts the four cubes on the mesh time-sharded
    (:class:`~photometry_tpu_torch.parallel.mesh.ShardedCube`): T is padded
    to a multiple of the time-axis size with NaN frames (pixel flags 0),
    ``n_times`` stays the true T, and the final extraction runs once per
    mesh block (:func:`_extract_flux_sharded`); a tensor already on a
    shard's device in the cube dtype is shared, not copied (only a padded
    last shard is).  With ``cache="host"`` the mesh is kept and not
    applied, as in the JAX package.  A context's mesh holds this process's
    devices only.
    """

    datasource = "ffi"

    def __init__(self, input_folder: str, sector: int, camera: int, ccd: int,
                 cache: str = "device", motion_mode: str = "wcs",
                 time_corrector=None, cube_dtype=None, mesh=None, device="cuda"):
        cube_dtype = _cube_dtype(cube_dtype)
        cubes = discovery.find_cube_files(input_folder, sector=sector, camera=camera, ccd=ccd)
        if len(cubes) != 1:
            raise FileNotFoundError(
                f"HDF5 File not found. SECTOR={sector:d}, CAMERA={camera:d}, CCD={ccd:d}")
        cats = discovery.find_catalog_files(input_folder, sector=sector, camera=camera, ccd=ccd)
        if len(cats) != 1:
            raise FileNotFoundError(
                f"Catalog file not found: SECTOR={sector:d}, CAMERA={camera:d}, CCD={ccd:d}")
        with ImageCube(cubes[0]) as cube:
            wcs = cube.reference_wcs()
            time, timecorr = cube.time, cube.timecorr
            # Motion model: per-frame WCS series (default), else stored
            # kernels, else unchanged (BasePhotometry.py:1186-1221):
            wcs_strings = cube.wcs_strings()
            t_nocorr = time - timecorr
            if motion_mode == "wcs" and any(s.strip() for s in wcs_strings):
                motion = MotionModel(warpmode="wcs", wcs_ref=wcs)
                motion.load_series(t_nocorr, wcs_strings)
            elif "movement_kernel" in cube.h5:
                mode = cube.h5["movement_kernel"].attrs.get("warpmode", "translation")
                motion = MotionModel(warpmode=str(mode))
                motion.load_series(t_nocorr, np.asarray(cube.h5["movement_kernel"]))
            else:
                motion = MotionModel(warpmode="unchanged")
            self._setup(
                images=cube.images(), images_err=cube.images_err(),
                backgrounds=cube.backgrounds(), pixelflags=cube.pixelflags(),
                sumimage=cube.sumimage, time=time, timecorr=timecorr,
                cadenceno=cube.cadenceno, quality=cube.quality, catalog_path=cats[0],
                wcs=wcs, sector=sector, camera=camera, ccd=ccd, header=cube.header,
                bkg_pixels_used=np.asarray(cube.h5["bkg_pixels_used"]), motion=motion,
                input_folder=input_folder, time_corrector=time_corrector,
                cube_dtype=cube_dtype, cache=cache, mesh=mesh, device=device)

    @classmethod
    def from_arrays(cls, *, images, images_err, backgrounds, pixelflags, sumimage,
                    time, timecorr, cadenceno, quality, catalog_path: str, wcs,
                    sector: int, camera: int, ccd: int, header: Optional[dict] = None,
                    bkg_pixels_used=None, motion: Optional[MotionModel] = None,
                    input_folder: str = ".", time_corrector=None, cube_dtype=None,
                    cache: str = "device", mesh=None, device="cuda") -> "SectorContext":
        """A context from in-memory state.

        Cubes (T, H, W) may be numpy arrays (a JAX bfloat16 array's host
        copy included) or tensors; tensors already on ``device`` in the
        cube dtype (uint8 for ``pixelflags``) are used as they are, without
        a copy, and others are cast on ``device`` a block of frames at a
        time.  With ``cache="host"`` the cubes stay on the host in their
        own dtype (a contiguous CPU tensor, pinned or not, is used as it
        is; a numpy array's memory is shared).  ``header`` carries the cube
        attributes (DATA_REL, CADENCE, NUM_FRM, ...; defaults as the
        reference's).  ``mesh`` as for the file constructor: on a mesh of
        one card, a tensor there in the cube dtype becomes the shards' views.
        """
        ctx = cls.__new__(cls)
        ctx._setup(images=images, images_err=images_err, backgrounds=backgrounds,
                   pixelflags=pixelflags, sumimage=sumimage, time=time, timecorr=timecorr,
                   cadenceno=cadenceno, quality=quality, catalog_path=catalog_path, wcs=wcs,
                   sector=sector, camera=camera, ccd=ccd, header=header,
                   bkg_pixels_used=bkg_pixels_used, motion=motion,
                   input_folder=input_folder, time_corrector=time_corrector,
                   cube_dtype=_cube_dtype(cube_dtype), cache=cache, mesh=mesh, device=device)
        return ctx

    def _setup(self, *, images, images_err, backgrounds, pixelflags, sumimage, time,
               timecorr, cadenceno, quality, catalog_path, wcs, sector, camera, ccd,
               header, bkg_pixels_used, motion, input_folder, time_corrector, cube_dtype,
               cache, mesh, device):
        if cache not in ("device", "host"):
            raise ValueError(f"cache={cache!r}: need 'device' or 'host'")
        self.device = resolve_device(device)
        #: The device mesh (``parallel.mesh.Mesh``) the cubes are sharded on, or None.
        self.mesh = mesh
        if mesh is not None:
            kinds = {mesh.device(i, j).type for _, i, j in mesh.flat()}
            if kinds != {self.device.type}:
                raise ValueError(f"mesh devices are {sorted(kinds)}, the context's device is "
                                 f"{self.device}")
            if mesh.spans_processes:
                raise ValueError("a context's mesh must hold this process's devices only")
        self.cube_dtype = cube_dtype
        self.cache = cache
        #: Optional core.timecorr.TimeCorrector for per-target barycentric
        #: corrections (None keeps the cube's frame-level values).
        self.time_corrector = time_corrector
        self.input_folder = input_folder
        self.sector, self.camera, self.ccd = int(sector), int(camera), int(ccd)
        self.catalog = StarCatalog(catalog_path)
        self.header = dict(header or {})
        hdr = self.header
        self.data_rel = int(hdr.get("DATA_REL", 99))
        self.cadence = int(hdr.get("CADENCE", 1800))
        self.num_frm = int(hdr.get("NUM_FRM", 900))
        crblksz = hdr.get("CRBLKSZ") or np.inf
        self.n_readout = int(hdr.get("NREADOUT") or int(self.num_frm * (1 - 2 / crblksz)))
        self.readnoise = float(hdr.get("READNOIS", 10.0))
        self.gain = float(hdr.get("GAIN", 100.0))
        self.pixel_offset_row = int(hdr.get("PIXEL_OFFSET_ROW", 0))
        self.pixel_offset_col = int(hdr.get("PIXEL_OFFSET_COLUMN", 0))

        self.time = np.asarray(time, np.float64)
        self.timecorr = np.asarray(timecorr)
        self.cadenceno = np.asarray(cadenceno)
        self.quality = np.asarray(quality)
        self.wcs = wcs if isinstance(wcs, TanWCS) else TanWCS.from_any(wcs)
        self.sumimage = np.asarray(sumimage).astype(np.float32)
        self.shape = tuple(self.sumimage.shape)
        self.n_times = len(self.time)
        self.bkg_pixels_used = (np.zeros(self.shape, bool) if bkg_pixels_used is None
                                else np.asarray(bkg_pixels_used).astype(bool))

        dev = self.device
        if cache == "host":
            self.images, self.images_err, self.backgrounds = (
                _on_host(x) for x in (images, images_err, backgrounds))
            self.pixelflags = _on_host(pixelflags, torch.uint8)
        elif mesh is not None:
            self.images, self.images_err, self.backgrounds = (
                shard_cube(x, mesh, put=lambda p, d: _on_device(p, cube_dtype, d))
                for x in (images, images_err, backgrounds))
            self.pixelflags = shard_cube(pixelflags, mesh, fill=0,
                                         put=lambda p, d: _on_device(p, torch.uint8, d))
        else:
            self.images = _on_device(images, cube_dtype, dev)
            self.images_err = _on_device(images_err, cube_dtype, dev)
            self.backgrounds = _on_device(backgrounds, cube_dtype, dev)
            self.pixelflags = _on_device(pixelflags, torch.uint8, dev)
        for name in ("images", "images_err", "backgrounds", "pixelflags"):
            x = getattr(self, name)
            got = (getattr(x, "n_times", x.shape[0]),) + tuple(x.shape[1:])
            if got != (self.n_times,) + self.shape:
                raise ValueError(f"{name} has shape {got}, expected "
                                 f"{(self.n_times,) + self.shape}")
        self.motion = motion if motion is not None else MotionModel(warpmode="unchanged")
        # Collected pixels (aperture bit 1): pixel was read out at all.
        self.collected = np.isfinite(self.sumimage)
        self._dev_cache = {}

    def close(self):
        self.catalog.close()

    def device_array(self, name: str, build) -> torch.Tensor:
        """Per-context cache of host maps (sumimage, collected) uploaded once."""
        if name not in self._dev_cache:
            self._dev_cache[name] = torch.as_tensor(build(), device=self.device)
        return self._dev_cache[name]

    def target_position(self, ra, dec) -> tuple:
        """(row, col) 0-based CCD position for catalog coordinates."""
        row, col = self.wcs.rowcol_of_radec(np.atleast_1d(ra), np.atleast_1d(dec))
        return float(row[0]), float(col[0])

    def corrected_time(self, ra: float, dec: float) -> tuple:
        """(time, timecorr) for a target at (ra, dec): recomputed for its sky
        position with a TimeCorrector, else the cube's frame-level values."""
        if self.time_corrector is None:
            return self.time, self.timecorr
        t_nocorr = self.time - self.timecorr
        corr = self.time_corrector.barycentric_correction(t_nocorr, float(ra), float(dec))
        return t_nocorr + corr, corr.astype(np.float32)


def context_from_jax(jax_ctx, device) -> SectorContext:
    """The port's SectorContext holding the same state as a JAX package
    ``SectorContext`` (cubes via ``np.asarray``, bfloat16 ones bit for bit;
    the cube dtype, the cache (a JAX host context's numpy cubes make a host
    context), catalog file, WCS, motion series and header fields carried
    over).  A JAX mesh context's cubes are gathered, cut to its true T and
    sharded again on a port mesh of the same shape, each entry ``device``
    (``["cpu"] * 8`` for the JAX suite's 8 virtual devices): the same
    padding and ``n_times``."""
    mesh = None
    if getattr(jax_ctx, "mesh", None) is not None:
        shape = jax_ctx.mesh.shape
        mesh = make_mesh(shape[TIME_AXIS], shape[TARGET_AXIS],
                         [device] * (shape[TIME_AXIS] * shape[TARGET_AXIS]))
    n = jax_ctx.n_times

    def cube(x):
        return np.asarray(x)[:n]
    jm = jax_ctx.motion
    wcs_ref = None if getattr(jm, "wcs_ref", None) is None else TanWCS.from_any(jm.wcs_ref)
    motion = MotionModel(warpmode=jm.warpmode, wcs_ref=wcs_ref)
    if jm.warpmode == "wcs":
        motion.load_series(jm.series_times, jm._wcs_series)
    elif jm.warpmode != "unchanged":
        motion.load_series(jm.series_times, jm.series_kernels)
    return SectorContext.from_arrays(
        images=cube(jax_ctx.images), images_err=cube(jax_ctx.images_err),
        backgrounds=cube(jax_ctx.backgrounds), pixelflags=cube(jax_ctx.pixelflags),
        sumimage=jax_ctx.sumimage, time=jax_ctx.time, timecorr=jax_ctx.timecorr,
        cadenceno=jax_ctx.cadenceno, quality=jax_ctx.quality,
        catalog_path=jax_ctx.catalog.path, wcs=jax_ctx.wcs, sector=jax_ctx.sector,
        camera=jax_ctx.camera, ccd=jax_ctx.ccd, header=jax_ctx.header,
        bkg_pixels_used=jax_ctx.bkg_pixels_used, motion=motion,
        input_folder=jax_ctx.input_folder, time_corrector=jax_ctx.time_corrector,
        cube_dtype=getattr(jax_ctx, "cube_dtype", None),
        cache="host" if isinstance(jax_ctx.images, np.ndarray) else "device", mesh=mesh,
        device=device)


class TpfContext:
    """A Target Pixel File with the SectorContext interface, its cubes as
    tensors on ``device``.

    Counterpart of the TPF branch of BasePhotometry.__init__
    (BasePhotometry.py:307-384), as the JAX package's ``TpfContext``.  The
    "CCD image" is the TPF stamp itself; CCD coordinates are offset by the
    stamp corner.  Cubes are float32; NaN and inf pixels pass through (the
    extraction's finiteness tests own them), pixel flags are zero.
    """

    datasource = "tpf"
    cache = "device"
    time_corrector = None

    def __init__(self, input_folder: str, starid: int, sector: Optional[int] = None,
                 cadence: Optional[int] = None, device="cuda"):
        self.device = resolve_device(device)
        files = discovery.find_tpf_files(input_folder, starid=starid, sector=sector,
                                         cadence=cadence)
        if len(files) == 0:
            raise FileNotFoundError("Target Pixel File not found")
        if len(files) > 1:
            raise FileNotFoundError("Multiple Target Pixel Files found matching pattern")
        with span("context.read"):
            tpf = read_tpf(files[0])
        self.tpf = tpf
        self.input_folder = input_folder
        self.sector, self.camera, self.ccd = tpf.sector, tpf.camera, tpf.ccd
        self.data_rel = tpf.data_rel
        self.cadence = tpf.cadence
        self.num_frm = tpf.num_frm
        self.n_readout = tpf.n_readout
        self.readnoise = tpf.readnoise
        self.gain = tpf.gain
        self.pixel_offset_row = tpf.corner_row
        self.pixel_offset_col = tpf.corner_col

        cats = discovery.find_catalog_files(input_folder, sector=self.sector,
                                            camera=self.camera, ccd=self.ccd)
        if len(cats) != 1:
            raise FileNotFoundError(
                f"Catalog file not found: SECTOR={self.sector:d}, "
                f"CAMERA={self.camera:d}, CCD={self.ccd:d}")
        self.catalog = StarCatalog(cats[0])

        self.time = time_offset(tpf.time, tpf.header, datatype="tpf")
        self.timecorr = tpf.timecorr
        self.cadenceno = tpf.cadenceno
        self.quality = tpf.quality
        self.n_times = len(self.time)
        self.shape = tuple(tpf.shape)
        self.wcs = tpf.wcs                  # stamp-relative

        dev = self.device
        self.images = _on_device(tpf.flux, torch.float32, dev)
        self.images_err = _on_device(tpf.flux_err, torch.float32, dev)
        bkg = tpf.flux_bkg if tpf.flux_bkg is not None else np.zeros_like(tpf.flux)
        self.backgrounds = _on_device(bkg, torch.float32, dev)
        self.pixelflags = torch.zeros(tpf.flux.shape, dtype=torch.uint8, device=dev)
        self.sumimage = np.nanmean(
            np.where(TESSQualityFlags.filter(tpf.quality)[:, None, None], tpf.flux, np.nan),
            axis=0).astype(np.float32)
        self.collected = ((tpf.aperture & 1 != 0) if tpf.aperture is not None
                          else np.isfinite(self.sumimage))
        #: SPOC aperture bits, the basis of the APERTURE image (BasePhotometry.py:1063-1072):
        self.tpf_aperture = tpf.aperture
        self.bkg_pixels_used = np.zeros(self.shape, bool)
        self._dev_cache = {}

        # Motion: translation kernels from POS_CORR, re-zeroed at the frame
        # nearest the catalog reference time (BasePhotometry.py:1199-1216);
        # with no finite (time, POS_CORR) pair, a static pointing model:
        t_nocorr = self.time - self.timecorr
        k = tpf.pos_corr.astype(np.float64) if tpf.pos_corr is not None else np.zeros((0, 2))
        good = (np.isfinite(t_nocorr[:len(k)]) & np.all(np.isfinite(k), axis=1)
                if len(k) else np.zeros(0, bool))
        if np.any(good):
            tt, kk = t_nocorr[:len(k)][good], k[good]
            ref_time = self.catalog.settings.reference_time - 2457000.0
            kk = kk - kk[int(np.argmin(np.abs(tt - ref_time)))]
            self.motion = MotionModel(warpmode="translation")
            self.motion.load_series(tt, kk)
        else:
            self.motion = MotionModel(warpmode="unchanged")

    close = SectorContext.close
    device_array = SectorContext.device_array
    target_position = SectorContext.target_position     # stamp coordinates: the WCS is the stamp's

    def corrected_time(self, ra: float, dec: float) -> tuple:
        """TPFs keep the per-cadence SPOC barycentric corrections."""
        return self.time, self.timecorr


# ---------------------------------------------------------------------------
# Results
# ---------------------------------------------------------------------------

@dataclass
class TargetResult:
    """Everything produced for one target by an extraction."""

    starid: int
    method: str
    status: STATUS
    sector: int
    camera: int
    ccd: int
    cadence: int
    data_rel: int
    target: dict
    lightcurve: dict
    mask: Optional[np.ndarray] = None
    aperture_image: Optional[np.ndarray] = None
    sumimage_stamp: Optional[np.ndarray] = None
    stamp: Optional[tuple] = None
    details: dict = field(default_factory=dict)
    additional_headers: dict = field(default_factory=dict)
    skip_targets: list = field(default_factory=list)
    num_frm: int = 900
    n_readout: int = 720
    ticver: str = "unknown"
    stamp_wcs: object = None

    def save(self, output_folder: str, version: int) -> str:
        from .lightcurve import save_lightcurve
        path = save_lightcurve(self, output_folder, version, sumimage=self.sumimage_stamp,
                               stamp_wcs=self.stamp_wcs,
                               halo_weightmap=self.details.get("halo_weightmap"))
        self.details["filepath_lightcurve"] = path
        return path


# ---------------------------------------------------------------------------
# Batched stamp machinery
# ---------------------------------------------------------------------------

def aperture_image(ctx, stamp, mask_stamp) -> np.ndarray:
    """TESS-product APERTURE bits for one stamp (BasePhotometry.py:1031-1074
    + the final-mask bits of :1644-1649).  FFI: bit 1 collected, bit 4
    background pixel, bits 32/64/128/256 CCD output A-D by raw 1-based
    column.  TPF: the SPOC aperture with its mask bits (2|8) cleared.  Both
    get 2|8 on the photometric mask.  ``stamp`` = (r0, r1, c0, c1), 0-based."""
    r0, r1, c0, c1 = stamp
    tpf_ap = getattr(ctx, "tpf_aperture", None)
    if ctx.datasource == "ffi" or tpf_ap is None:
        ap = ctx.collected[r0:r1, c0:c1].astype(np.int32)
        ap |= 4 * ctx.bkg_pixels_used[r0:r1, c0:c1].astype(np.int32)
        if ctx.datasource == "ffi":
            rawcol = np.arange(c0, c1) + ctx.pixel_offset_col + 1  # 1-based raw
            bits = np.zeros_like(rawcol, np.int32)
            bits[(45 <= rawcol) & (rawcol <= 556)] = 32     # CCD output A
            bits[(557 <= rawcol) & (rawcol <= 1068)] = 64   # CCD output B
            bits[(1069 <= rawcol) & (rawcol <= 1580)] = 128  # CCD output C
            bits[(1581 <= rawcol) & (rawcol <= 2092)] = 256  # CCD output D
            ap |= bits[None, :]
    else:
        ap = np.asarray(tpf_ap[r0:r1, c0:c1], np.int32) & ~np.int32(2 | 8)
    if mask_stamp is not None:
        ap |= np.where(mask_stamp, np.int32(2 | 8), np.int32(0))
    return ap


def _gather_stamps_image(image, r0s, c0s, h: int, w: int):
    """(N,) stamps of an (H, W) tensor -> (N, h, w)."""
    rows = r0s.long()[:, None] + torch.arange(h, device=image.device)
    cols = c0s.long()[:, None] + torch.arange(w, device=image.device)
    return image[rows[:, :, None], cols[:, None, :]]


def extract_flux_core(images, images_err, backgrounds, pixelflags, masks, r0s, c0s,
                      h: int, w: int, windows=None):
    """Aperture sums by the plain torch gather formulation, on any device.

    Same arguments and outputs as ``ops.bandext.band_extract_flux_batch``
    (flux, flux_err, flux_bkg (N, T), centroid (N, T, 2) 1-based,
    shenanigans_any (N, T)), without the CUDA kernel: the reference the
    kernel is held against.
    """
    return _extract(band_sums_plain, images, images_err, backgrounds, pixelflags, masks, r0s,
                    c0s, h, w, windows)


def _extract_flux_streamed(ctx, masks, r0s, c0s, h: int, w: int, chunk: int = 128,
                           windows=None):
    """Aperture sums of a host-resident cube (``cache="host"``), ``chunk``
    frames at a time through ``ctx.device``.

    A full float32 sector (1,312 frames of 2048x2048, ~71.5 GB with the
    flags) exceeds one card; this path streams it as the reference's
    ``_extract_flux_streamed`` does (photometry_tpu/core/engine.py:502-529).
    The masks, corners and windows live on ``ctx.device``; the outputs are
    those of ``band_extract_flux_batch``, on ``ctx.device``.  On a card
    each chunk's sums come from the band kernel on the device-resident
    chunk (``ops.bandext.band_sums_streamed``), so they equal the device
    path's; on the CPU, from the plain version per chunk.  Timed in the
    span ``aperture.stream``, up to the last chunk's copies and launch.
    """
    sums = functools.partial(band_sums_streamed, device=ctx.device, chunk=chunk)
    with span("aperture.stream"):
        return _extract(sums, ctx.images, ctx.images_err, ctx.backgrounds, ctx.pixelflags,
                        masks, r0s, c0s, h, w, windows)


def _extract_flux_sharded(ctx, masks, r0s, c0s, h: int, w: int, windows):
    """Aperture sums of a mesh context (``ctx.mesh``, time x targets).

    The cubes are time-sharded (and time-padded) by SectorContext; the
    host target arrays (masks, corners, windows) are padded here to a
    multiple of the target-axis size, then ``parallel.sharded`` runs
    ``band_extract_flux_batch`` once per block: once per time shard
    (``sharded_band_extract``) on a time-only mesh, once per (time shard,
    target shard) otherwise (``sharded_extract_flux``), as the JAX
    package's ``_extract_flux_sharded`` picks (photometry_tpu/core/
    engine.py:532-570).  Returns the five outputs cut to (N, ctx.n_times)
    on ``ctx.device``: bit-equal to the single-device extraction, as every
    element depends on one (target, cadence) pair.
    """
    mesh = ctx.mesh
    N, T = len(masks), ctx.n_times
    n_targets = mesh.shape[TARGET_AXIS]
    masks_p, _ = pad_to_multiple(np.asarray(masks), 0, n_targets, fill=False)
    windows_p, _ = pad_to_multiple(np.asarray(windows), 0, n_targets, fill=False)
    r0s_p, _ = pad_to_multiple(np.asarray(r0s, np.int32), 0, n_targets, fill=0)
    c0s_p, _ = pad_to_multiple(np.asarray(c0s, np.int32), 0, n_targets, fill=0)
    run = sharded_band_extract if n_targets == 1 else sharded_extract_flux
    out = run(ctx.images, ctx.images_err, ctx.backgrounds, ctx.pixelflags, masks_p, r0s_p,
              c0s_p, mesh, h, w, windows=windows_p, out_device=ctx.device)
    return tuple(o[:N, :T].contiguous() for o in out)


def _stamp_catalog_select(cat_all: dict, r0, r1, c0, c1, buffer_px: float = 5.0) -> np.ndarray:
    """Indices of catalog stars within one stamp (+buffer), brightest first."""
    row, col = cat_all["row"], cat_all["col"]
    sel = ((row >= r0 - buffer_px) & (row <= r1 - 1 + buffer_px)
           & (col >= c0 - buffer_px) & (col <= c1 - 1 + buffer_px))
    idx = np.where(sel)[0]
    return idx[np.argsort(cat_all["tmag"][idx], kind="stable")]


#: Padded catalog widths shared across batches (as the stamp-bucket ladder):
_K_LADDER = (48, 64, 96, 128, 192, 256, 384, 512, 768, 1024)

#: Quantized stamp-bucket ladder: batches re-use a small set of shapes.
_LADDER = (17, 25, 33, 49, 65, 97, 129, 161, 225, 337, 513, 769, 1025)


def _catalog_bucket(n: int) -> int:
    for b in _K_LADDER:
        if b >= n:
            return b
    return int(n)


def _bucket(n: int, limit: int) -> int:
    for b in _LADDER:
        if b >= n:
            return min(b, limit)
    return min(n, limit)


def _stamp_catalog(cat_all: dict, idx: np.ndarray, r0, c0, pad_to: int) -> dict:
    """Padded per-stamp catalog table from pre-selected (brightest-first) indices."""
    idx = idx[:pad_to]
    k = len(idx)
    out = {
        "starid": np.zeros(pad_to, np.int64),
        "row": np.full(pad_to, 1e9), "col": np.full(pad_to, 1e9),
        "tmag": np.full(pad_to, 30.0), "valid": np.zeros(pad_to, bool),
    }
    out["starid"][:k] = cat_all["starid"][idx]
    out["row"][:k] = cat_all["row"][idx] - r0
    out["col"][:k] = cat_all["col"][idx] - c0
    out["tmag"][:k] = cat_all["tmag"][idx]
    out["valid"][:k] = True
    return out


def _full_catalog_positions(ctx) -> dict:
    """All catalog stars with 0-based positions through the context WCS: CCD
    coordinates, or stamp coordinates on a TPF (its WCS and ``ctx.shape``
    are the stamp's)."""
    cat = ctx.catalog.all_stars()
    if len(cat["starid"]) == 0:
        return {"starid": np.array([], np.int64), "row": np.array([]),
                "col": np.array([]), "tmag": np.array([])}
    row, col = ctx.wcs.rowcol_of_radec(cat["ra"], cat["decl"])
    return {"starid": cat["starid"], "row": np.asarray(row), "col": np.asarray(col),
            "tmag": cat["tmag"]}


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# The batched aperture extractor
# ---------------------------------------------------------------------------

def extract_aperture_batch(ctx, starids, retries: Optional[int] = None,
                           max_stars: Optional[int] = None,
                           k2p2_params=None) -> list:
    """K2P2 aperture photometry for a batch of targets on one context.

    Returns a list of :class:`TargetResult` in the order of ``starids``.
    ``k2p2_params`` is any NamedTuple with the K2P2Params fields (the JAX
    package's included).  See the reference's docstring for the retry loop
    (AperturePhotometry/photometry.py:71-165).
    """
    settings = load_settings()
    halos_tmag = settings.getfloat("haloswitch", "tmag_limit", fallback=6.0)
    halos_flux = settings.getfloat("haloswitch", "flux_limit", fallback=0.01)
    deblend_ratio = settings.getfloat("deblend", "neighbour_flux_ratio", fallback=0.1)
    k2p2_params = (DEFAULT_K2P2_PARAMS if k2p2_params is None
                   else K2P2Params(**k2p2_params._asdict()))

    starids = [int(s) for s in starids]
    if not starids:
        return []
    H, W = ctx.shape
    dev = ctx.device
    cat_all = _full_catalog_positions(ctx)
    sum_dev = ctx.device_array("sumimage", lambda: ctx.sumimage)
    coll_dev = ctx.device_array("collected", lambda: ctx.collected.astype(np.float32))

    # --- per-target setup -------------------------------------------------
    targets = []
    for sid in starids:
        tgt = ctx.catalog.target(sid)
        row, col = ctx.target_position(tgt["ra"], tgt["decl"])
        if ctx.datasource.startswith("tpf"):
            stamp = [0, H, 0, W]      # TPF: the whole postage stamp, one round
            max_retries = 1
        else:
            nr, nc = default_stamp_size(tgt["tmag"])
            stamp = [int(round(row)) - nr // 2, int(round(row)) + nr // 2 + 1,
                     int(round(col)) - nc // 2, int(round(col)) + nc // 2 + 1]
            max_retries = (10 if tgt["tmag"] < 6 else 5) if retries is None else retries
        targets.append({
            "starid": sid, "target": tgt, "row": row, "col": col,
            "stamp": stamp, "resizes": 0, "max_retries": max_retries,
            "done": False, "status": None, "details": {}, "mask": None,
        })

    def clip_stamp(s):
        return [int(max(s[0], 0)), int(min(s[1], H)), int(max(s[2], 0)), int(min(s[3], W))]

    # --- retry rounds -------------------------------------------------------
    # At least one round always runs (the initial mask build is in the loop):
    for _ in range(max(max(t["max_retries"] for t in targets), 1)):
        active = [t for t in targets if not t["done"] and t["resizes"] <= t["max_retries"]]
        if not active:
            break
        hs = [clip_stamp(t["stamp"]) for t in active]
        bh = _bucket(max(s[1] - s[0] for s in hs), H)
        bw = _bucket(max(s[3] - s[2] for s in hs), W)

        # Two-pass catalog build: every star of every stamp, padded to the
        # round's largest count (no silent truncation):
        sel_idx = [_stamp_catalog_select(cat_all, s[0], s[1], s[2], s[3]) for s in hs]
        k_round = _catalog_bucket(max((len(ix) for ix in sel_idx), default=1))
        if max_stars is not None:
            k_round = min(k_round, int(max_stars))

        r0s, c0s, cats, trs, tcs, tts = [], [], [], [], [], []
        for t, s, ix in zip(active, hs, sel_idx):
            # slice of bucket size fully inside the CCD, anchored at stamp:
            r0 = min(s[0], H - bh)
            c0 = min(s[2], W - bw)
            t["bucket_corner"] = (r0, c0)
            t["clipped"] = s
            r0s.append(r0)
            c0s.append(c0)
            trs.append(t["row"] - r0)
            tcs.append(t["col"] - c0)
            tts.append(t["target"]["tmag"])
            cats.append(_stamp_catalog(cat_all, ix, s[0], s[2], k_round))
        r0s_d = torch.as_tensor(np.array(r0s, np.int32), device=dev)
        c0s_d = torch.as_tensor(np.array(c0s, np.int32), device=dev)
        stamps = _gather_stamps_image(sum_dev, r0s_d, c0s_d, bh, bw)
        coll = _gather_stamps_image(coll_dev, r0s_d, c0s_d, bh, bw) > 0
        # Mask out pixels outside each target's *logical* stamp:
        yy, xx = np.mgrid[0:bh, 0:bw]
        logical = np.stack([(yy + t["bucket_corner"][0] >= t["clipped"][0])
                            & (yy + t["bucket_corner"][0] < t["clipped"][1])
                            & (xx + t["bucket_corner"][1] >= t["clipped"][2])
                            & (xx + t["bucket_corner"][1] < t["clipped"][3]) for t in active])
        logical = torch.as_tensor(logical, device=dev)
        stamps = torch.where(logical, stamps, torch.nan)
        coll = coll & logical

        def table(key, shift=None, dtype=torch.float32):
            a = np.stack([c[key] if shift is None else c[key] + shift(t)
                          for c, t in zip(cats, active)])
            return torch.as_tensor(a, device=dev, dtype=dtype)

        out = build_masks_batch(
            stamps,
            table("col", lambda t: t["clipped"][2] - t["bucket_corner"][1]),
            table("row", lambda t: t["clipped"][0] - t["bucket_corner"][0]),
            table("tmag"), table("starid", dtype=torch.int64), table("valid", dtype=torch.bool),
            torch.as_tensor(np.array(trs), device=dev, dtype=torch.float32),
            torch.as_tensor(np.array(tcs), device=dev, dtype=torch.float32),
            torch.as_tensor(np.array(tts), device=dev, dtype=torch.float32),
            collected=coll, params=k2p2_params)
        masks, found, no_flux, in_mask = (_host(out[k]) for k in
                                          ("mask", "found_mask", "no_flux", "in_mask"))
        stamps_host = None

        # Edge contact of the *logical* stamp:
        for i, t in enumerate(active):
            r0, c0 = t["bucket_corner"]
            s = t["clipped"]
            m = masks[i]
            bot = np.any(m[s[0] - r0, :]) if s[0] - r0 < bh else False
            top = np.any(m[s[1] - r0 - 1, :])
            left = np.any(m[:, s[2] - c0])
            right = np.any(m[:, s[3] - c0 - 1])
            t["mask_bucket"] = m
            t["found"] = bool(found[i])
            t["no_flux"] = bool(no_flux[i])
            t["cat"] = cats[i]
            t["in_mask"] = np.asarray(in_mask[i]) & cats[i]["valid"]

            # A TPF's stamp is the postage stamp: it never grows.
            resize = {k: 10 for k, hit in (("down", bot), ("up", top), ("left", left),
                                           ("right", right))
                      if hit and ctx.datasource == "ffi"}
            if not resize:
                t["done"] = True
                continue
            old = list(t["stamp"])
            s2 = list(t["stamp"])
            if "down" in resize:
                s2[0] -= 10
            if "up" in resize:
                s2[1] += 10
            if "left" in resize:
                s2[2] -= 10
            if "right" in resize:
                s2[3] += 10
            changed = clip_stamp(s2) != clip_stamp(old)
            t["stamp"] = s2
            if not changed:
                # Could not resize further -> halo-switch quick break check:
                tgt = t["target"]
                if tgt["tmag"] <= halos_tmag:
                    edge_img = np.zeros_like(m, dtype=bool)
                    cs = t["clipped"]
                    if "down" in resize:
                        edge_img[cs[0] - r0, :] = True
                    if "up" in resize:
                        edge_img[cs[1] - r0 - 1, :] = True
                    if "left" in resize:
                        edge_img[:, cs[2] - c0] = True
                    if "right" in resize:
                        edge_img[:, cs[3] - c0 - 1] = True
                    if stamps_host is None:
                        stamps_host = _host(stamps)
                    edge_flux = np.nansum(stamps_host[i][m & edge_img])
                    expected = float(mag2flux(tgt["tmag"]))
                    if edge_flux / expected > halos_flux:
                        t["details"]["edge_flux"] = float(edge_flux)
                        t["status"] = STATUS.ERROR
                        t["details"]["errors"] = ["Stamp resize hit limit. Haloswitch quick break."]
                # Otherwise the mask still touches the edge but is accepted
                # (the reference breaks its loop the same way, photometry.py:138-141).
                t["done"] = True
                continue
            t["resizes"] += 1
            if t["resizes"] >= t["max_retries"]:
                t["status"] = STATUS.ERROR
                t["details"]["errors"] = ["Too many stamp resizes."]
                t["done"] = True

    # Any still-active targets after rounds -> too many resizes:
    for t in targets:
        if not t.get("done"):
            t["status"] = STATUS.ERROR
            t.setdefault("details", {})["errors"] = ["Too many stamp resizes."]
            t["done"] = True

    # --- final flux extraction (single bucket over final masks) -------------
    ok_targets = [t for t in targets if t["status"] is None and t.get("mask_bucket") is not None]
    results = {t["starid"]: None for t in targets}

    if ok_targets:
        n_ok = len(ok_targets)
        bh = max(t["mask_bucket"].shape[0] for t in ok_targets)
        bw = max(t["mask_bucket"].shape[1] for t in ok_targets)
        masks_f = np.zeros((n_ok, bh, bw), bool)
        # logical-stamp windows: the shenanigans flag sees only the target's
        # own stamp, not the shared padded bucket:
        windows_f = np.zeros((n_ok, bh, bw), bool)
        r0s = np.zeros(n_ok, np.int32)
        c0s = np.zeros(n_ok, np.int32)
        for i, t in enumerate(ok_targets):
            m = t["mask_bucket"]
            r0 = min(t["bucket_corner"][0], H - bh)
            c0 = min(t["bucket_corner"][1], W - bw)
            # re-anchor mask into the (possibly larger) final bucket:
            dr = t["bucket_corner"][0] - r0
            dc = t["bucket_corner"][1] - c0
            masks_f[i, dr:dr + m.shape[0], dc:dc + m.shape[1]] = m
            s = t["clipped"]
            windows_f[i, s[0] - r0:s[1] - r0, s[2] - c0:s[3] - c0] = True
            r0s[i] = r0
            c0s[i] = c0
        stamps_d = (torch.as_tensor(masks_f, device=dev), torch.as_tensor(r0s, device=dev),
                    torch.as_tensor(c0s, device=dev), bh, bw)
        windows_d = torch.as_tensor(windows_f, device=dev)
        if ctx.cache == "host":
            # Host-resident cube: stream chunks of frames through the device.
            out = _extract_flux_streamed(ctx, *stamps_d, windows=windows_d)
        elif getattr(ctx, "mesh", None) is not None:
            # A mesh context: one extraction per block of the mesh.
            out = _extract_flux_sharded(ctx, masks_f, r0s, c0s, bh, bw, windows_f)
        else:
            out = band_extract_flux_batch(ctx.images, ctx.images_err, ctx.backgrounds,
                                          ctx.pixelflags, *stamps_d, windows=windows_d)
        flux_d, ferr_d, fbkg_d, cent_d, shen_d = out

        # pos_corr for every target over time:
        rows = np.array([t["row"] for t in ok_targets])
        cols = np.array([t["col"] for t in ok_targets])
        if ctx.datasource.startswith("tpf"):   # the motion model is in CCD coordinates
            rows, cols = rows + ctx.pixel_offset_row, cols + ctx.pixel_offset_col
        jit_all = ctx.motion.jitter_batch(ctx.time - ctx.timecorr, cols, rows)  # (T, N, 2)

        # Float32 device inputs, as the reference's jnp.asarray (x64 off):
        metrics = compute_metrics_batch(
            torch.as_tensor(ctx.time, dtype=torch.float32, device=dev), flux_d, ferr_d,
            torch.as_tensor(ctx.quality, device=dev), cent_d)
        metrics = {k: _host(v) for k, v in metrics.items()}
        flux, ferr, fbkg, cent, shen = (_host(x) for x in out)

        # PSF-flux completeness/crowding of the final masks (SPOC
        # FLFRCSAP/CROWDSAP); targets of different rounds carry different
        # catalog widths, stacked to the widest:
        K = max(len(t["cat"]["row"]) for t in ok_targets)
        cm_row = np.full((n_ok, K), 1e9, np.float32)
        cm_col = np.full((n_ok, K), 1e9, np.float32)
        cm_flux = np.zeros((n_ok, K), np.float32)
        cm_valid = np.zeros((n_ok, K), bool)
        cm_istgt = np.zeros((n_ok, K), bool)
        cm_trow = np.zeros(n_ok, np.float32)
        cm_tcol = np.zeros(n_ok, np.float32)
        cm_tflux = np.zeros(n_ok, np.float32)
        for i, t in enumerate(ok_targets):
            c = t["cat"]
            s = t["clipped"]
            k = len(c["row"])
            cm_row[i, :k] = c["row"] + (s[0] - r0s[i])
            cm_col[i, :k] = c["col"] + (s[2] - c0s[i])
            cm_flux[i, :k] = np.asarray(mag2flux(c["tmag"]), np.float32)
            cm_valid[i, :k] = c["valid"]
            cm_istgt[i, :k] = c["valid"] & (c["starid"] == t["starid"])
            cm_trow[i] = t["row"] - r0s[i]
            cm_tcol[i] = t["col"] - c0s[i]
            cm_tflux[i] = float(mag2flux(t["target"].get("tmag", np.nan)))
        psf_sigma = float(getattr(ctx, "header", {}).get("PSFSIGMA", 1.25) or 1.25)
        crowding = crowding_metrics_batch(
            *(torch.as_tensor(a, device=dev) for a in (masks_f, cm_row, cm_col, cm_flux, cm_valid,
                                                       cm_istgt, cm_trow, cm_tcol, cm_tflux)),
            psf_sigma)
        crowding = {k: _host(v) for k, v in crowding.items()}

    for i, t in enumerate(ok_targets):
        tgt = t["target"]
        s = t["clipped"]
        # crop the bucket down to the logical stamp:
        fr0, fc0 = int(r0s[i]), int(c0s[i])
        mask_stamp = masks_f[i][s[0] - fr0:s[1] - fr0, s[2] - fc0:s[3] - fc0]
        sum_stamp = ctx.sumimage[s[0]:s[1], s[2]:s[3]]
        aperture = aperture_image(ctx, s, mask_stamp)

        status = STATUS.OK
        details = dict(t["details"])
        add_headers = {
            "KP_THRES": (k2p2_params.thresh, "K2P2 sum-image threshold"),
            "KP_MIPIX": (k2p2_params.min_no_pixels_in_mask, "K2P2 min pixels in mask"),
            "KP_MICLS": (k2p2_params.min_for_cluster, "K2P2 min pix. for cluster"),
            "KP_CLSRA": (float(np.sqrt(2) + np.finfo(np.float64).eps), "K2P2 cluster radius"),
            "KP_WS": (bool(k2p2_params.segmentation), "K2P2 watershed segmentation"),
            "KP_WSBLR": (k2p2_params.ws_blur, "K2P2 watershed blur"),
            "KP_WSTHR": (k2p2_params.ws_thres, "K2P2 watershed threshold"),
            "KP_WSFOT": (k2p2_params.ws_footprint, "K2P2 watershed footprint"),
            "KP_EX": (bool(k2p2_params.extend_overflow), "K2P2 extend overflow"),
        }

        # contamination + skip targets (photometry.py:222-250):
        cat = t["cat"]
        in_mask = t["in_mask"]
        ids_in = cat["starid"][in_mask]
        skip_targets = [int(s_) for s_ in ids_in if s_ != t["starid"]]
        if len(ids_in) == 0:
            contamination = np.nan
            status = STATUS.ERROR
            details.setdefault("errors", []).append("No targets in mask.")
        elif len(ids_in) == 1 and int(ids_in[0]) == t["starid"]:
            contamination = 0.0
        else:
            mags = cat["tmag"][in_mask]
            mags_total = -2.5 * np.log10(np.nansum(10 ** (-0.4 * mags)))
            contamination = float(np.clip(1.0 - 10 ** (0.4 * (mags_total - tgt["tmag"])), 0, None))
        if np.isfinite(contamination):
            add_headers["AP_CONT"] = (round(float(contamination), 8), "AP contamination")
            details["contamination"] = float(contamination)

        # PSF-model completeness + crowding, nearest (significant) neighbour:
        completeness = float(crowding["completeness"][i])
        crowdsap = float(crowding["crowdsap"][i])
        details["completeness"] = completeness
        details["crowdsap"] = crowdsap
        others = cat["valid"] & (cat["starid"] != t["starid"])
        if others.any():
            dist = np.hypot(cat["row"][others] - (t["row"] - s[0]),
                            cat["col"][others] - (t["col"] - s[2]))
            details["nearest_neighbour_px"] = float(np.min(dist))
            ratio = 10.0 ** (-0.4 * (cat["tmag"][others] - tgt["tmag"]))
            sig = ratio >= deblend_ratio
            if sig.any():
                details["nearest_significant_neighbour_px"] = float(np.min(dist[sig]))
        add_headers["FLFRCSAP"] = (round(completeness, 6), "Frac. of target PSF flux in aperture")
        add_headers["CROWDSAP"] = (round(crowdsap, 6), "Target flux / total flux in aperture")
        if t["found"] and completeness < 0.5:
            status = STATUS.WARNING if status == STATUS.OK else status
            details.setdefault("errors", []).append(
                f"Mask captures only {100 * completeness:.0f}% of the "
                "target's PSF flux (deblending truncation).")

        if not t["found"]:
            status = STATUS.WARNING if status == STATUS.OK else status
            details.setdefault("errors", []).append(
                "No flux above threshold." if t["no_flux"]
                else "No mask found for main target. Using minimum aperture.")

        t_i, tc_i = ctx.corrected_time(tgt["ra"], tgt["decl"])
        lc = {
            "time": t_i, "timecorr": tc_i,
            "cadenceno": ctx.cadenceno, "quality": ctx.quality,
            "flux": flux[i], "flux_err": ferr[i], "flux_background": fbkg[i],
            "pos_centroid": cent[i], "pos_corr": jit_all[:, i, :],
            "shenanigans_any": shen[i],
        }
        details.update({
            "mean_flux": float(metrics["mean_flux"][i]),
            "variance": float(metrics["variance"][i]),
            "rms_hour": float(metrics["rms_hour"][i]),
            "ptp": float(metrics["ptp"][i]),
            "variability": float(metrics["variability"][i]),
            "pos_centroid": metrics["pos_centroid"][i].tolist(),
            "mask_size": int(mask_stamp.sum()),
            "stamp_resizes": t["resizes"],
            "stamp": tuple(s),
        })
        # edge flux of the final mask (BasePhotometry.py:1397-1405):
        edge_m = np.zeros_like(mask_stamp, bool)
        edge_m[:, (0, -1)] = True
        edge_m[(0, -1), 1:-1] = True
        details["edge_flux"] = float(np.nansum(sum_stamp[mask_stamp & edge_m]))

        # Stamp WCS (CRPIX shifted to the stamp):
        stamp_wcs = None
        if ctx.wcs is not None:
            stamp_wcs = ctx.wcs.copy()
            if ctx.datasource == "ffi":      # a TPF's WCS is the stamp's already
                stamp_wcs.crpix = stamp_wcs.crpix - np.array([s[2], s[0]])

        if np.all(np.isnan(flux[i])):
            status = STATUS.ERROR
            details.setdefault("errors", []).append("Final lightcurve fluxes are all NaNs")

        results[t["starid"]] = TargetResult(
            starid=t["starid"], method="aperture", status=status,
            sector=ctx.sector, camera=ctx.camera, ccd=ctx.ccd,
            cadence=ctx.cadence, data_rel=ctx.data_rel,
            target=tgt, lightcurve=lc, mask=mask_stamp,
            aperture_image=aperture, sumimage_stamp=sum_stamp,
            stamp=tuple(s), details=details, additional_headers=add_headers,
            skip_targets=skip_targets, num_frm=ctx.num_frm,
            n_readout=ctx.n_readout, ticver=ctx.catalog.settings.ticver,
            stamp_wcs=stamp_wcs)

    # Error-status targets get a stub result:
    for t in targets:
        if results[t["starid"]] is None:
            results[t["starid"]] = TargetResult(
                starid=t["starid"], method="aperture",
                status=t["status"] or STATUS.ERROR,
                sector=ctx.sector, camera=ctx.camera, ccd=ctx.ccd,
                cadence=ctx.cadence, data_rel=ctx.data_rel,
                target=t["target"], lightcurve={}, details=t["details"],
                num_frm=ctx.num_frm, n_readout=ctx.n_readout,
                ticver=ctx.catalog.settings.ticver)

    return [results[s] for s in starids]
