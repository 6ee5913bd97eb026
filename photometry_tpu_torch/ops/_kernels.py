"""
Build and load the port's hand-written CUDA kernels.

Each kernel source under ``ops/csrc/`` has a plain C interface and is
compiled at first use with ``nvcc`` for ``sm_90a`` (Hopper) into
``photometry_tpu_torch/_build/`` — a directory ``.gitignore`` lists — then
loaded with ``ctypes``.  The library's file name carries a hash of the
source, so an edited source is rebuilt, never stale.  Nothing here runs at
import: the CPU tests import every module on a machine without ``nvcc``.

A failed build or launch raises :class:`KernelError`; no caller falls back
to a plain version.
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

__all__ = ["KernelError", "CudaLibrary", "BAND_EXTRACT"]

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_BUILD = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]


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
    """One ``csrc/<name>.cu`` source, built on demand into a ctypes library.

    ``launches`` counts kernel launches; the wrapper that launches adds one
    where it launches and nowhere else.
    """

    def __init__(self, name: str, signatures: dict):
        self.name = name
        self.source = os.path.join(_CSRC, name + ".cu")
        self._signatures = signatures
        self._lib = None
        self._lock = threading.Lock()
        self.launches = 0
        self.build_seconds = None   #: wall of the nvcc run, None if loaded from _build

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


_P, _I = ctypes.c_void_p, ctypes.c_int

#: ops/csrc/band_extract.cu — see ops.bandext.band_sums_cuda.
BAND_EXTRACT = CudaLibrary("band_extract", {
    "band_extract_sums": (_I, [_P] * 9 + [_I] * 6 + [_P]),
})
