"""The port's binding to the native host runtime, ``photometry_tpu_torch.native_ops``.

Case for case as tests/test_native.py holds the JAX binding (the binding
has no ``bswap_crop_f32`` or ``moving_median_f32``: no caller of the port
needs them): it builds ``native/fastio.cpp`` into
``photometry_tpu_torch/_build/`` and loads it, nothing new in ``native/``;
byteswap; gunzip, multi-member streams and trailing garbage; the gzip round
trip and determinism.  Beside them:

- ``gzip_compress`` of both packages gives the same bytes at each level;
- ``read_fits`` of both packages gives identical arrays on a gzipped FFI
  (a float32 image past 1 MB takes the native byteswap);
- ``.fits.gz`` products are byte-reproducible: two writes of one HDU list a
  second apart are byte-equal, the gzip header's MTIME is 0, and the
  payload is the JAX package's ``write_fits`` payload for the same HDUs, on
  the native path and on the stdlib fallback.
"""

import glob
import gzip
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from photometry_tpu import native_ops as jax_native
from photometry_tpu.io import fits as jax_fits
from photometry_tpu_torch import native_ops
from photometry_tpu_torch.io import fits as pf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(params=["native", "fallback"])
def path_kind(request, monkeypatch):
    """Run a test on the native library, then on the stdlib/numpy fallback."""
    if request.param == "fallback":
        monkeypatch.setattr(native_ops, "_load", lambda: None)
    else:
        assert native_ops.native_available()
    return request.param


def test_native_builds_and_loads():
    """In a fresh process the library builds (or is found built) under
    ``_build/`` by a digest name and loads; the port adds nothing to
    ``native/``.  The JAX binding's ``make -C native`` may write the
    Makefile's own ``libptfastio.so`` there meanwhile (tests/test_native.py
    in another test worker), so that one name may appear; none of the
    port's names (``libptfastio-<digest>.so``, its ``tmp*.so``) may, and
    nothing may go."""
    native = os.path.join(ROOT, "native")
    before = set(os.listdir(native))
    script = ("from photometry_tpu_torch import native_ops as n\n"
              "assert n.native_available()\n"
              "print(n.libdeflate_linked())\n")
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    after = set(os.listdir(native))
    assert before <= after and after - before <= {"libptfastio.so"}, sorted(after ^ before)
    assert not glob.glob(os.path.join(native, "libptfastio-*.so"))
    assert not glob.glob(os.path.join(native, "tmp*.so"))
    assert glob.glob(os.path.join(native_ops.BUILD, "libptfastio-*.so"))
    # g++ and libdeflate are both here, so the library links it:
    assert proc.stdout.strip() == "True"
    assert native_ops.native_available() and native_ops.libdeflate_linked()


def test_bswap(path_kind):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(1000).astype("<f4")
    raw = x.astype(">f4").tobytes()
    out = native_ops.bswap_f32(raw)
    assert out.dtype == np.dtype("<f4")
    np.testing.assert_array_equal(out, x)


def test_gunzip(path_kind):
    payload = np.arange(100000, dtype=np.int32).tobytes()
    gz = gzip.compress(payload)
    assert native_ops.gunzip(gz, expected_size=len(payload)) == payload
    # a tiny capacity to start with still succeeds through the retry:
    assert native_ops.gunzip(gz, expected_size=1) == payload


def test_gunzip_multimember(path_kind):
    a, b, c = b"A" * 1000, b"B" * 2000, b"C" * 300
    gz = gzip.compress(a) + gzip.compress(b) + gzip.compress(c)
    assert native_ops.gunzip(gz, expected_size=len(a) + len(b) + len(c)) == a + b + c
    assert native_ops.gunzip(gz, expected_size=1) == a + b + c


def test_gunzip_trailing_garbage_falls_back(path_kind):
    payload = b"hello world" * 100
    gz = gzip.compress(payload) + b"\x00garbage-not-gzip"
    # never a silent truncation: the native path calls it corrupt and the
    # stdlib raises
    with pytest.raises(Exception):
        native_ops.gunzip(gz)


def test_gzip_compress_roundtrip_and_determinism(path_kind):
    payload = (b"FITS" * 50000) + bytes(range(256)) * 100
    blob = native_ops.gzip_compress(payload, level=2)
    assert gzip.decompress(blob) == payload
    assert native_ops.gunzip(blob) == payload
    assert blob == native_ops.gzip_compress(payload, level=2)
    assert blob[4:8] == b"\0\0\0\0"                     # MTIME
    noise = np.random.default_rng(3).integers(0, 256, 300000, dtype=np.uint8).tobytes()
    assert gzip.decompress(native_ops.gzip_compress(noise, level=1)) == noise
    assert gzip.decompress(native_ops.gzip_compress(b"", level=2)) == b""


@pytest.mark.parametrize("level", [1, 2, 6, 9])
def test_gzip_compress_equals_jax(level):
    """libdeflate on both sides (both libraries link it here): the same bytes."""
    assert jax_native.native_available() and native_ops.libdeflate_linked()
    rng = np.random.default_rng(level)
    payload = (rng.normal(100, 5, 60000).astype(">f4").tobytes()
               + b"FITS" * 20000 + bytes(range(256)) * 50)
    assert native_ops.gzip_compress(payload, level) == jax_native.gzip_compress(payload, level)


def test_read_fits_gzipped_ffi_equals_jax(tmp_path, path_kind):
    """A gzipped FFI-like file (a 2.2 MB float32 image, an int16 image under
    1 MB, a table) reads to identical arrays in both packages."""
    rng = np.random.default_rng(4)
    img = rng.normal(300, 40, (600, 900)).astype(np.float32)
    img[3, 5] = np.nan
    hdus = [jax_fits.PrimaryHDU(None),
            jax_fits.ImageHDU(img, name="SCI"),
            jax_fits.ImageHDU((np.arange(600, dtype=np.int16) - 50).reshape(20, 30),
                              name="SMALL"),
            jax_fits.BinTableHDU({"TIME": np.linspace(0, 1, 9),
                                  "FLUX": np.arange(9, dtype=np.float32)}, name="T")]
    path = str(tmp_path / "tess-ffic.fits.gz")
    jax_fits.write_fits(path, hdus)
    got, want = pf.read_fits(path), jax_fits.read_fits(path)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.name == w.name and g.kind == w.kind
        if w.kind == "bintable":
            for k in w.data:
                assert g.data[k].dtype == w.data[k].dtype
                np.testing.assert_array_equal(g.data[k], w.data[k])
        elif w.data is None:
            assert g.data is None
        else:
            assert g.data.dtype == w.data.dtype and g.data.shape == w.data.shape
            np.testing.assert_array_equal(g.data, w.data)
    np.testing.assert_array_equal(got[1].data, img)


def test_products_byte_reproducible(tmp_path, path_kind):
    """Two writes of one HDU list a second apart are byte-equal, MTIME is 0,
    and the payload is the JAX package's write_fits payload."""
    lc = {"TIME": np.linspace(1325.0, 1353.0, 500), "FLUX_RAW": np.linspace(1, 2, 500,
                                                                            dtype=np.float32)}
    aperture = np.arange(15 * 17, dtype=np.int32).reshape(15, 17)

    def hdus(mod):
        return [mod.PrimaryHDU(None), mod.BinTableHDU(lc, name="LIGHTCURVE"),
                mod.ImageHDU(aperture, name="APERTURE")]

    a, b = str(tmp_path / "a.fits.gz"), str(tmp_path / "b.fits.gz")
    pf.write_fits(a, hdus(pf), gzip_level=2)
    time.sleep(1.1)
    pf.write_fits(b, hdus(pf), gzip_level=2)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        blob_a, blob_b = fa.read(), fb.read()
    assert blob_a[4:8] == b"\0\0\0\0"
    assert blob_a == blob_b
    ref = str(tmp_path / "ref.fits")
    jax_fits.write_fits(ref, hdus(jax_fits))
    with open(ref, "rb") as fh:
        assert gzip.decompress(blob_a) == fh.read()
