"""
The sector-CCD image cube store, read side.

The port's own copy of the reader of ``photometry_tpu/io/cube.py``: one
contiguous ``(T, H, W)`` dataset per quantity in an HDF5 file named
``sector{s:03d}_camera{c}_ccd{d}.hdf5`` (layout in that module's
docstring).  ``h5py`` is imported when a cube is opened, not with this
module: a context built from arrays never needs it.  WCS objects are the
port's :class:`~photometry_tpu_torch.io.wcs.TanWCS`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .fits import Header
from .wcs import TanWCS

__all__ = ["ImageCube"]


class ImageCube:
    """Read access to one cube file."""

    def __init__(self, path: str):
        import h5py
        self.path = path
        self.h5 = h5py.File(path, "r")

    def close(self):
        self.h5.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    @property
    def header(self) -> dict:
        return {k: v for k, v in self.h5.attrs.items() if not k.startswith("_")}

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
