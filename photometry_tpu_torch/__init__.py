"""
photometry_tpu_torch — the PyTorch + CUDA port of photometry_tpu.

The JAX package ``photometry_tpu`` is the reference; this package mirrors
its layout (``core/engine.py``, ``ops/bandext.py``, ...) so each counterpart
is found by path.  It imports ``torch`` and never ``jax`` nor any module of
``photometry_tpu``: it keeps its own copies of the host modules it needs
(``catalog``, ``fixes``, ``quality``, ``taskmanager``, ``todolist``,
``todo_merge``, ``sim``, ``io.fits``, ``io.settings``, ``io.discovery``,
``io.tess``, ``io.loader``, ...).

Ported so far, each TPU kernel as a hand-written Hopper kernel under
``ops/csrc/``:

- the FFI aperture slice: K2P2 masks, banded extraction
  (``band_extract.cu``), metrics, jitter, the batch dispatcher, the drain
  and the ``photometry`` CLI;
- the PSF method with its fused warm-start fit (``psf_warm_fit.cu``);
- the linPSF and halo methods (torch code: the JAX package runs them in
  XLA, outside any Pallas kernel) and both automatic switches of the
  default method, the halo switch queued across leases
  (``HaloSwitchQueue``) and the linPSF deblend switch;
- the prepare stage (FFIs -> cube): background fit with the ring
  histogram (``segment_hist.cu``), time smoothing, the Background
  Shenanigans detector with the 15x15 median (``median15.cu``), and the
  ``prepare`` CLI;
- the work queue's host code (numpy and sqlite): catalogs from a TIC
  extract, the todo list, the merge of a corrections todo, with their CLIs;
  the simulator and the end-to-end fuzz harness (``tools/fuzz_e2e.py``).
"""

from . import device  # noqa: F401  (sets the float32 precision policy)
