"""
photometry_tpu_torch — the PyTorch + CUDA port of photometry_tpu.

The JAX package ``photometry_tpu`` is the reference; this package mirrors
its layout (``core/engine.py``, ``ops/bandext.py``, ...) so each counterpart
is found by path.  It imports ``torch`` and never ``jax``: the host modules
it shares with the reference are only the jax-free ones (``catalog``,
``io.fits``, ``io.settings``, ``io.discovery``, ``quality``,
``taskmanager``, ``core.lightcurve``, ``core.status``).

Ported so far: the FFI aperture slice — K2P2 masks, banded extraction
(a hand-written Hopper kernel, ``ops/csrc/band_extract.cu``), metrics,
jitter, the batch dispatcher, the drain and the ``photometry`` CLI with
``--method aperture``.
"""

from . import device  # noqa: F401  (sets the float32 precision policy)
