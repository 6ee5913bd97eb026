"""
Build and load the port's hand-written CUDA kernels.

Each kernel source under ``ops/csrc/`` has a plain C interface and is
compiled at first use with ``nvcc`` for ``sm_90a`` (Hopper) into
``photometry_tpu_torch/_build/`` — a directory ``.gitignore`` lists — then
loaded with ``ctypes``.  The library's file name carries a hash of the
source, so an edited source is rebuilt, never stale.  Nothing here runs at
import: the CPU tests import every module on a machine without ``nvcc``.

A failed build or launch raises :class:`KernelError`; no caller falls back
to a plain version.  :func:`build_all` starts one ``nvcc`` per source at
once; ``build_log`` keeps what ``ptxas -v`` said (registers, spills).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from time import perf_counter

__all__ = ["KernelError", "CudaLibrary", "Instantiation", "BAND_EXTRACT", "BAND_EXTRACT_BF16",
           "PSF_WARM_FIT", "MEDIAN15", "SEGMENT_HIST", "STAMP_FLUX", "TILE_MODE", "LIBRARIES",
           "KERNELS", "build_all"]

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_BUILD = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-split-compile", "0"]


class KernelError(RuntimeError):
    """A CUDA kernel of the port failed to build or to launch."""


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise KernelError("nvcc not found (set CUDA_HOME or NVCC)")


class CudaLibrary:
    """One ``csrc/<name>.cu`` source (or ``source``), built on demand into a
    ctypes library.

    ``launches`` counts kernel launches; the wrapper that launches adds one
    where it launches and nowhere else.
    """

    def __init__(self, name: str, signatures: dict, source: str | None = None):
        self.name = name
        self.source = source or os.path.join(_CSRC, name + ".cu")
        self._signatures = signatures
        self._lib = None
        self._lock = threading.Lock()
        self.launches = 0
        self.build_seconds = None   #: wall of the nvcc run, None if loaded from _build
        self.build_log = ""         #: nvcc's stderr (ptxas -v) of this process's build

    def lib(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                self._lib = self._load()
            return self._lib

    def _load(self) -> ctypes.CDLL:
        with open(self.source, "rb") as fh:
            digest = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        path = os.path.join(_BUILD, f"lib{self.name}-{digest}.so")
        if not os.path.exists(path):
            os.makedirs(_BUILD, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
            os.close(fd)
            tic = perf_counter()
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, self.source],
                                  capture_output=True, text=True)
            self.build_seconds = perf_counter() - tic
            self.build_log = proc.stderr
            if proc.returncode != 0:
                os.unlink(tmp)
                raise KernelError(f"nvcc failed for {self.source}:\n{proc.stderr}")
            os.replace(tmp, path)
        lib = ctypes.CDLL(path)
        for fn, (restype, argtypes) in self._signatures.items():
            f = getattr(lib, fn)
            f.restype = restype
            f.argtypes = argtypes
        return lib


class Instantiation:
    """A second kernel built from another library's source (a template
    instantiated on another element type): its own launch count, the
    library's build."""

    def __init__(self, name: str, library: CudaLibrary):
        self.name = name
        self.library = library
        self.launches = 0

    def lib(self) -> ctypes.CDLL:
        return self.library.lib()


_P, _I = ctypes.c_void_p, ctypes.c_int

_L, _F = ctypes.c_int64, ctypes.c_float

#: ops/csrc/band_extract.cu — see ops.bandext.band_sums_cuda.
BAND_EXTRACT = CudaLibrary("band_extract", {
    "band_extract_sums": (_I, [_P] * 9 + [_I] * 6 + [_P]),
    "band_extract_sums_bf16": (_I, [_P] * 9 + [_I] * 6 + [_P]),
})

#: The band kernel on bfloat16 value planes (``band_extract_sums_bf16``).
BAND_EXTRACT_BF16 = Instantiation("band_extract_bf16", BAND_EXTRACT)

#: ops/csrc/psf_warm_fit.cu — see models.psf_fused.fused_warm_fit_cuda.
PSF_WARM_FIT = CudaLibrary("psf_warm_fit", {
    "psf_warm_fit": (_I, [_P] * 11 + [_L] + [_I] * 5 + [_I] * 4 + [_F] + [_I] * 4 + [_F]
                     + [_I] + [_F] * 2 + [_I] + [_P]),
})

#: ops/csrc/median15.cu — see ops.median15.median15_cuda.
MEDIAN15 = CudaLibrary("median15", {
    "median15": (_I, [_P] * 2 + [_I] * 3 + [_P]),
})

#: ops/csrc/segment_hist.cu — see ops.seghist.segment_histogram_cuda.
SEGMENT_HIST = CudaLibrary("segment_hist", {
    "segment_hist": (_I, [_P] * 5 + [_I] + [_L] + [_I] * 4 + [_P]),
    "segment_hist_max_cells": (_I, []),
    "segment_hist_resident_blocks": (_I, [_I, _I]),
})

#: ops/csrc/stamp_flux.cu — see ops.stamp_flux.stamp_flux_cuda.
STAMP_FLUX = CudaLibrary("stamp_flux", {
    "stamp_flux": (_I, [_P] * 5 + [_I] * 6 + [_P]),
    "stamp_flux_max_pixels": (_I, []),
})

#: ops/csrc/tile_mode.cu — see ops.tilemode.tile_mode_cuda.
TILE_MODE = CudaLibrary("tile_mode", {
    "tile_mode": (_I, [_P] * 3 + [_I] * 5 + [_F] * 2 + [_P]),
    "tile_mode_max_pixels": (_I, []),
})

LIBRARIES = (BAND_EXTRACT, PSF_WARM_FIT, MEDIAN15, SEGMENT_HIST, STAMP_FLUX, TILE_MODE)

#: Every kernel with a launch count: the libraries' and the second instantiations.
KERNELS = LIBRARIES + (BAND_EXTRACT_BF16,)


def build_all() -> None:
    """Build every kernel library at once, one nvcc process each."""
    threads = [threading.Thread(target=lib.lib) for lib in LIBRARIES]
    errors = []
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for lib in LIBRARIES:
        try:
            lib.lib()
        except KernelError as e:
            errors.append(str(e))
    if errors:
        raise KernelError("\n".join(errors))
