"""
The sector-CCD image cube store.

The port's own copy of ``photometry_tpu/io/cube.py``: one contiguous
``(T, H, W)`` dataset per quantity in an HDF5 file named
``sector{s:03d}_camera{c}_ccd{d}.hdf5``, with the same datasets, dtypes,
chunks, compression and attributes, so either package reads a cube the
other wrote::

    /images       (T, H, W) float32, background-subtracted flux  [e-/s]
    /images_err   (T, H, W) float32
    /backgrounds  (T, H, W) float32
    /pixelflags   (T, H, W) uint8     (PixelQualityFlags bits)
    /time         (T,) float64  mid-exposure BTJD (barycentre corrected)
    /timecorr     (T,) float32  barycentric correction applied [days]
    /cadenceno    (T,) int32
    /quality      (T,) int32    (TESSQualityFlags bits)
    /time_start, /time_stop (T,) float64  (written by the prepare stage)
    /sumimage     (H, W) float64  mean of quality-good frames
    /bkg_pixels_used (H, W) uint8
    /wcs          (T,) variable-length str (serialized per-frame headers)
    /movement_kernel (T, P) float64, attrs warpmode, ref_frame (optional
                  stage 6: one ECC warp per frame against the reference frame)
    attrs: SECTOR, CAMERA, CCD, DATA_REL, PROCVER, CADENCE, WCS_REF_FRAME,
           plus completion markers (``mark_done``/``is_done``).

``h5py`` is imported when a cube is opened, not with this module: a
context built from arrays never needs it.  Everything the prepare stage
stores goes through methods of :class:`ImageCube` (it never touches
``h5``), so any object with the same methods can stand in for the file.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from .fits import Header
from .wcs import TanWCS

__all__ = ["ImageCube", "cube_filename"]

_SCRATCH = "_scratch_resid"


def cube_filename(sector: int, camera: int, ccd: int) -> str:
    return f"sector{sector:03d}_camera{camera:d}_ccd{ccd:d}.hdf5"


def _chunks(n_times: int, shape) -> tuple:
    return (min(n_times, 8), min(shape[0], 128), min(shape[1], 128))


class ImageCube:
    """Create, write and read one sector-CCD cube file.

    Writing is resumable: each stage calls :meth:`mark_done` when it
    finishes, and re-runs skip completed stages (reference
    prepare.py:265,289,347,515,630).
    """

    def __init__(self, path: str, mode: str = "r"):
        import h5py
        self.path = path
        self.h5 = h5py.File(path, mode)

    # -- lifecycle -----------------------------------------------------------
    @classmethod
    def create(cls, path: str, n_times: int, shape,
               header: Optional[dict] = None) -> "ImageCube":
        """A new cube file, or the existing one when its shape matches.

        A truncated or corrupt file from a killed run is recreated; a file
        another process holds locked raises.
        """
        import h5py
        if os.path.exists(path):
            cube = None
            try:
                cube = cls(path, "r+")
                if cube.n_times != n_times or cube.shape != tuple(shape):
                    raise ValueError(f"Existing cube {path} has incompatible shape")
                return cube
            except ValueError:
                if cube is not None:
                    cube.close()
                raise
            except (OSError, KeyError) as exc:
                msg = str(exc).lower()
                if "lock" in msg or "already open" in msg:
                    raise
                os.remove(path)
        cube = cls(path, "w")
        h5 = cube.h5
        comp = dict(compression="lzf", shuffle=True)
        ch = _chunks(n_times, shape)
        for name in ("images", "images_err", "backgrounds"):
            h5.create_dataset(name, shape=(n_times,) + tuple(shape), dtype="f4", chunks=ch, **comp)
        h5.create_dataset("pixelflags", shape=(n_times,) + tuple(shape), dtype="u1", chunks=ch,
                          **comp)
        h5.create_dataset("time", shape=(n_times,), dtype="f8")
        h5.create_dataset("timecorr", shape=(n_times,), dtype="f4")
        h5.create_dataset("cadenceno", shape=(n_times,), dtype="i4")
        h5.create_dataset("quality", shape=(n_times,), dtype="i4")
        h5.create_dataset("sumimage", shape=tuple(shape), dtype="f8")
        h5.create_dataset("bkg_pixels_used", shape=tuple(shape), dtype="u1")
        h5.create_dataset("wcs", shape=(n_times,), dtype=h5py.string_dtype())
        for k, v in (header or {}).items():
            if v is not None:
                h5.attrs[k] = v
        h5.attrs["_stages_done"] = ""
        return cube

    def close(self):
        if self.h5:
            self.h5.close()
            self.h5 = None

    def flush(self):
        self.h5.flush()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- resumability ---------------------------------------------------------
    def _stages(self) -> set:
        return set(filter(None, str(self.h5.attrs.get("_stages_done", "")).split(",")))

    def mark_done(self, stage: str):
        self.h5.attrs["_stages_done"] = ",".join(sorted(self._stages() | {stage}))
        self.h5.flush()

    def is_done(self, stage: str) -> bool:
        return stage in self._stages()

    # -- metadata -------------------------------------------------------------
    @property
    def n_times(self) -> int:
        return self.h5["time"].shape[0]

    @property
    def shape(self) -> tuple:
        return tuple(self.h5["sumimage"].shape)

    @property
    def header(self) -> dict:
        return {k: v for k, v in self.h5.attrs.items() if not k.startswith("_")}

    @property
    def attrs(self):
        return self.h5.attrs

    # -- vectors ---------------------------------------------------------------
    @property
    def time(self) -> np.ndarray:
        return np.asarray(self.h5["time"])

    @property
    def timecorr(self) -> np.ndarray:
        return np.asarray(self.h5["timecorr"])

    @property
    def cadenceno(self) -> np.ndarray:
        return np.asarray(self.h5["cadenceno"])

    @property
    def quality(self) -> np.ndarray:
        return np.asarray(self.h5["quality"])

    @property
    def sumimage(self) -> np.ndarray:
        return np.asarray(self.h5["sumimage"])

    def time_bounds(self) -> tuple:
        """(time_start, time_stop) of every frame, as the prepare stage wrote them."""
        return np.asarray(self.h5["time_start"]), np.asarray(self.h5["time_stop"])

    # -- bulk reads -------------------------------------------------------------
    def images(self, t0: int = 0, t1: Optional[int] = None) -> np.ndarray:
        return np.asarray(self.h5["images"][t0:t1])

    def images_err(self, t0: int = 0, t1: Optional[int] = None) -> np.ndarray:
        return np.asarray(self.h5["images_err"][t0:t1])

    def backgrounds(self, t0: int = 0, t1: Optional[int] = None) -> np.ndarray:
        return np.asarray(self.h5["backgrounds"][t0:t1])

    def pixelflags(self, t0: int = 0, t1: Optional[int] = None) -> np.ndarray:
        return np.asarray(self.h5["pixelflags"][t0:t1])

    def wcs_strings(self) -> list:
        return [s.decode() if isinstance(s, bytes) else s for s in self.h5["wcs"][:]]

    def wcs_at(self, k: int) -> TanWCS:
        """Deserialize the WCS of frame k (stored as FITS header cards)."""
        s = self.h5["wcs"][k]
        s = s.decode() if isinstance(s, bytes) else s
        if not s:
            raise ValueError(f"Invalid WCS header string in cube frame {k}")
        return TanWCS.from_header(Header.from_bytes(s.encode("ascii")))

    def reference_wcs(self) -> TanWCS:
        """The WCS of the reference frame (attr WCS_REF_FRAME)."""
        return self.wcs_at(int(self.h5.attrs.get("WCS_REF_FRAME", 0)))

    # -- writes -----------------------------------------------------------------
    def write_frame(self, k: int, image=None, image_err=None, background=None,
                    pixelflags=None, wcs_str=None):
        for name, value in (("images", image), ("images_err", image_err),
                            ("backgrounds", background), ("pixelflags", pixelflags),
                            ("wcs", wcs_str)):
            if value is not None:
                self.h5[name][k] = value

    def write_block(self, name: str, t0: int, block: np.ndarray):
        """Write a contiguous time-block of a (T, H, W) dataset in one call."""
        self.h5[name][t0:t0 + block.shape[0]] = block

    def write_vectors(self, time=None, timecorr=None, cadenceno=None, quality=None):
        for name, value in (("time", time), ("timecorr", timecorr), ("cadenceno", cadenceno),
                            ("quality", quality)):
            if value is not None:
                self.h5[name][:] = value

    def write_time_bounds(self, time_start, time_stop):
        """(Re)create the time_start / time_stop datasets (float64)."""
        for name, data in (("time_start", time_start), ("time_stop", time_stop)):
            if name in self.h5:
                del self.h5[name]
            self.h5.create_dataset(name, data=np.asarray(data, np.float64))

    def write_sumimage(self, sumimage, pixels_used=None):
        self.h5["sumimage"][:] = sumimage
        if pixels_used is not None:
            self.h5["bkg_pixels_used"][:] = pixels_used

    def write_movement_kernel(self, kernels, warpmode: str, ref_frame: int):
        """(Re)create the (T, P) float64 ``movement_kernel`` dataset and its
        ``warpmode`` / ``ref_frame`` attributes (an old one is deleted first,
        so a rerun after a crash starts clean)."""
        if "movement_kernel" in self.h5:
            del self.h5["movement_kernel"]
        dset = self.h5.create_dataset("movement_kernel", data=np.asarray(kernels, np.float64))
        dset.attrs["warpmode"] = warpmode
        dset.attrs["ref_frame"] = int(ref_frame)

    # -- the prepare stage's transient residual stack ---------------------------
    def create_scratch(self):
        """A fresh (T, H, W) float32 scratch dataset in the file."""
        self.delete_scratch()
        H, W = self.shape
        self.h5.create_dataset(_SCRATCH, shape=(self.n_times, H, W), dtype="f4",
                               chunks=(1, min(H, 512), min(W, 512)),
                               compression="lzf", shuffle=True)

    def write_scratch(self, t0: int, block: np.ndarray):
        self.h5[_SCRATCH][t0:t0 + block.shape[0]] = block

    def read_scratch(self, index) -> np.ndarray:
        """Frames of the scratch stack: a slice, or increasing frame indices."""
        return np.asarray(self.h5[_SCRATCH][index])

    def delete_scratch(self):
        if _SCRATCH in self.h5:
            del self.h5[_SCRATCH]
