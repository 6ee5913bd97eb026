"""
The sector-CCD image cube store, read with the port's WCS.

A thin subclass of ``photometry_tpu.io.cube.ImageCube`` (HDF5 through
h5py, no JAX): only the WCS deserialisation differs, returning the port's
:class:`~photometry_tpu_torch.io.wcs.TanWCS`.  ``reference_wcs`` goes
through :meth:`ImageCube.wcs_at`, so it returns the port's type too.
"""

from __future__ import annotations

from photometry_tpu.io.cube import ImageCube as _ReferenceCube
from photometry_tpu.io.fits import Header

from .wcs import TanWCS

__all__ = ["ImageCube"]


class ImageCube(_ReferenceCube):
    """Read access to one cube file; WCS objects are the port's."""

    def wcs_at(self, k: int) -> TanWCS:
        """Deserialize the WCS of frame k (stored as FITS header cards)."""
        s = self.h5["wcs"][k]
        s = s.decode() if isinstance(s, bytes) else s
        if not s:
            raise ValueError(f"Invalid WCS header string in cube frame {k}")
        return TanWCS.from_header(Header.from_bytes(s.encode("ascii")))
