"""
ctypes binding to the native host runtime, ``native/fastio.cpp``.

The port's own copy of ``photometry_tpu/native_ops.py``: GIL-free
whole-buffer gunzip of ``.gz`` reads, a threaded byteswap of big-endian
float32 images (whole, or cropped to a window as it is swapped), a
NaN-ignoring centred moving median along the time axis, and libdeflate gzip
of ``.gz`` products (MTIME 0, so a product's bytes depend on its content
only).

The unchanged source is compiled with g++ at first use, with
``native/Makefile``'s flags (libdeflate linked where an empty program links
against it, as the Makefile tests), into ``photometry_tpu_torch/_build/``.
The library's name carries a digest of the source, the flags and the host
CPU (the flags hold ``-march=native``), and the build writes a temporary
file that it renames into place, so processes that build at once do not
race and a library built for another CPU is never loaded.  Nothing is
written into ``native/``.

Every entry point keeps the JAX binding's fallback (the standard library
and numpy) for a host without a toolchain; this is host code, with no
device kernel to fall back from.  :func:`native_available` and
:func:`libdeflate_linked` say which path runs.
"""

from __future__ import annotations

import ctypes
import gzip
import hashlib
import logging
import os
import subprocess
import tempfile
import threading

import numpy as np

logger = logging.getLogger(__name__)

__all__ = ["native_available", "libdeflate_linked", "bswap_f32", "bswap_crop_f32",
           "moving_median_f32", "gunzip", "gzip_compress"]

_PKG = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(os.path.dirname(_PKG), "native", "fastio.cpp")
BUILD = os.path.join(_PKG, "_build")
#: native/Makefile's CXXFLAGS and LDFLAGS (``-ldeflate`` is added where it links).
CXXFLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall"]
LDFLAGS = ["-shared", "-lz", "-lpthread"]

_lock = threading.Lock()
_lib = None
_tried = False
_deflate = False


def _run(cmd, **kw) -> bool:
    try:
        return subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                              **kw).returncode == 0
    except (OSError, subprocess.SubprocessError) as e:
        logger.debug("%s failed: %s", cmd[0], e)
        return False


def _cpu_id() -> bytes:
    """The host CPU's model and feature flags (what ``-march=native`` reads)."""
    try:
        with open("/proc/cpuinfo", "rb") as fh:
            lines = fh.read().splitlines()
    except OSError:
        return os.uname().machine.encode()
    keep = [ln for ln in lines if ln.split(b":")[0].strip() in (b"model name", b"flags")]
    return b"\n".join(sorted(set(keep)))


def _load():
    global _lib, _tried, _deflate
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        cxx = os.environ.get("CXX", "g++")
        try:
            with open(SOURCE, "rb") as fh:
                src = fh.read()
        except OSError:
            logger.info("native/fastio.cpp not found; using the stdlib and numpy paths.")
            return None
        deflate = _run([cxx, "-x", "c++", "-", "-ldeflate", "-o", os.devnull],
                       input="int main(){return 0;}")
        ldflags = LDFLAGS + (["-ldeflate"] if deflate else [])
        digest = hashlib.sha256(b"\0".join([src, " ".join(CXXFLAGS + ldflags).encode(),
                                            _cpu_id()])).hexdigest()[:16]
        path = os.path.join(BUILD, f"libptfastio-{digest}.so")
        if not os.path.exists(path):
            os.makedirs(BUILD, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
            os.close(fd)
            if not _run([cxx, *CXXFLAGS, SOURCE, "-o", tmp, *ldflags]):
                os.unlink(tmp)
                logger.info("Native build failed; using the stdlib and numpy paths.")
                return None
            os.replace(tmp, path)
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        lib.pt_bswap_f32.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
        lib.pt_bswap_crop_f32.argtypes = [ctypes.c_void_p] + [ctypes.c_int64] * 6 + [
            ctypes.c_void_p]
        lib.pt_moving_median_f32.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                                             ctypes.c_int, ctypes.c_void_p]
        lib.pt_gunzip.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                                  ctypes.c_int64]
        lib.pt_gunzip.restype = ctypes.c_int64
        lib.pt_gzip.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                                ctypes.c_int64, ctypes.c_int]
        lib.pt_gzip.restype = ctypes.c_int64
        lib.pt_version.restype = ctypes.c_int
        if lib.pt_version() < 2:
            return None
        _lib, _deflate = lib, deflate
        return _lib


def native_available() -> bool:
    """Whether the native library built (or was found built) and loaded."""
    return _load() is not None


def libdeflate_linked() -> bool:
    """Whether the loaded library has libdeflate: ``.gz`` products are then
    written by it, else by the stdlib fallback (MTIME 0 either way)."""
    return _load() is not None and _deflate


def bswap_f32(raw: bytes) -> np.ndarray:
    """Big-endian float32 buffer -> native float32 array."""
    n = len(raw) // 4
    lib = _load()
    if lib is None:
        return np.frombuffer(raw, dtype=">f4").astype("<f4")
    out = np.empty(n, dtype="<f4")
    buf = np.frombuffer(raw, dtype=np.uint8)
    lib.pt_bswap_f32(buf.ctypes.data, out.ctypes.data, n)
    return out


def bswap_crop_f32(raw: bytes, H: int, W: int, r0: int, r1: int,
                   c0: int, c1: int) -> np.ndarray:
    """Fused byteswap + crop of a big-endian (H, W) float32 image buffer:
    rows ``r0:r1``, columns ``c0:c1`` in native order."""
    lib = _load()
    if lib is None:
        img = np.frombuffer(raw, dtype=">f4").reshape(H, W)
        return img[r0:r1, c0:c1].astype("<f4")
    out = np.empty((r1 - r0, c1 - c0), dtype="<f4")
    buf = np.frombuffer(raw, dtype=np.uint8)
    lib.pt_bswap_crop_f32(buf.ctypes.data, H, W, r0, r1, c0, c1, out.ctypes.data)
    return out


def moving_median_f32(x: np.ndarray, window: int) -> np.ndarray:
    """Centred moving median along axis 0, NaN-ignoring, with the window
    shrinking at the ends (``utils.mathutils.np_moving_median_central``)."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    shape = x.shape
    lib = _load()
    if lib is None:
        from .utils.mathutils import np_moving_median_central
        return np_moving_median_central(x, window, axis=0).astype(np.float32)
    T = shape[0]
    P = int(np.prod(shape[1:])) if x.ndim > 1 else 1
    flat = x.reshape(T, P)
    out = np.empty_like(flat)
    lib.pt_moving_median_f32(flat.ctypes.data, T, P, window, out.ctypes.data)
    return out.reshape(shape)


def gzip_compress(data: bytes, level: int = 2) -> bytes:
    """Gzip a whole buffer: libdeflate at ``level`` (1-12) where it is
    linked, else the stdlib at ``level`` clamped to zlib's 0-9; both stamp
    MTIME 0.  The ctypes call releases the GIL, so the product writer's
    threads overlap their compressions."""
    lib = _load()
    if lib is not None and len(data):
        inp = np.frombuffer(data, dtype=np.uint8)
        # gzip overhead is 18 bytes + deflate's worst case of ~n + n/4000:
        cap = len(data) + len(data) // 1000 + 256
        out = np.empty(cap, dtype=np.uint8)
        n = lib.pt_gzip(inp.ctypes.data, len(data), out.ctypes.data, cap, int(level))
        if n == -2:          # capacity miss (should not happen): retry 2x
            cap *= 2
            out = np.empty(cap, dtype=np.uint8)
            n = lib.pt_gzip(inp.ctypes.data, len(data), out.ctypes.data, cap, int(level))
        if n > 0:
            return out[:n].tobytes()
    return gzip.compress(data, compresslevel=min(max(int(level), 0), 9), mtime=0)


def gunzip(data: bytes, expected_size: int = 0) -> bytes:
    """Inflate a gzip stream, every member of it (zlib in the native path,
    the stdlib otherwise, and for input the native path calls corrupt)."""
    lib = _load()
    if lib is None:
        return gzip.decompress(data)
    cap = max(expected_size, 4 * len(data), 1 << 20)
    inp = np.frombuffer(data, dtype=np.uint8)
    for _ in range(4):
        out = np.empty(cap, dtype=np.uint8)
        n = lib.pt_gunzip(inp.ctypes.data, len(data), out.ctypes.data, cap)
        if n >= 0:
            return out[:n].tobytes()
        if n != -2:
            # corrupt or invalid input: a bigger buffer cannot help; the
            # stdlib path gives the clear error
            break
        cap *= 4          # -2: output capacity exhausted, retry bigger
    return gzip.decompress(data)
