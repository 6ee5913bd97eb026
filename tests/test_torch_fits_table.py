"""Binary-table columns of the port's FITS reader against the JAX package's, on the CPU.

- Every numeric TFORM code with repeat 1 and more, a 3-D ``TDIM`` column,
  TSCAL/TZERO (unsigned int16 among them), logicals stored as ``T``/``F``
  and as 1/0, a string column and a ``P`` descriptor column with a heap,
  plain and gzipped: the port's ``read_fits`` returns what the JAX
  package's does, bit for bit, each column a new native-order,
  C-contiguous, writable array that owns its memory, and it counts the
  numeric columns' bytes under ``fits_table_bytes``.
- ``read_tpf`` of a TPF whose TIME is all finite, and of one with NaN
  TIME cadences (dropped): every field equal to the JAX package's, and the
  counters ``fits_table_bytes`` and ``fits_bytes`` of the read.
"""

import dataclasses
import gzip
import os

import numpy as np
import pytest

from photometry_tpu.io import fits as jfits
from photometry_tpu.io import tess as jtess
from photometry_tpu_torch.io import fits as pf
from photometry_tpu_torch.io import tess
from photometry_tpu_torch.io.wcs import TanWCS
from photometry_tpu_torch.utils.profiling import StageTimer

N = 37


def _rng(name):
    return np.random.default_rng(sum(name.encode()))


def _numeric(rng, dtype, shape):
    """Values of ``dtype`` that span its range (floats with NaN and inf)."""
    dtype = np.dtype(dtype)
    if dtype.kind == "f":
        out = rng.normal(scale=1e3, size=shape).astype(dtype)
        flat = out.reshape(-1)
        flat[::7] = np.nan
        flat[3::11] = np.inf
        flat[5::13] = -0.0
        return out
    if dtype.kind == "b":
        return rng.random(shape) < 0.5
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, size=shape, endpoint=True, dtype=dtype)


def _write(path, columns, header=None, after=None):
    hdus = [pf.PrimaryHDU(None), pf.BinTableHDU(columns, header=header, name="TABLE")]
    if after is not None:
        hdus.append(pf.ImageHDU(after, name="AFTER"))
    pf.write_fits(path, hdus, checksum=False)


def _bytes_of(columns):
    """Bytes of the numeric columns of a table written by ``write_fits``."""
    return sum(a.dtype.itemsize * a.size for a in columns.values() if a.dtype.kind != "U")


def _case_code(code, dtype, repeat):
    def make(path):
        rng = _rng(code + str(repeat))
        shape = (N,) if repeat == 1 else (N, repeat)
        cols = {"X": _numeric(rng, dtype, shape), "Y": _numeric(rng, np.float64, (N,))}
        _write(path, cols, after=np.arange(12, dtype=np.int16).reshape(3, 4))
        return _bytes_of(cols)
    return make


def _case_tdim(path):
    rng = _rng("tdim")
    cols = {"CUBE": _numeric(rng, np.float32, (N, 3, 4, 5)),
            "PLANE": _numeric(rng, np.int32, (N, 2, 6)),
            "TIME": _numeric(rng, np.float64, (N,))}
    _write(path, cols)
    return _bytes_of(cols)


def _case_scaled(path):
    rng = _rng("scaled")
    cols = {"U16": _numeric(rng, np.int16, (N, 3)), "J": _numeric(rng, np.int32, (N,)),
            "E": _numeric(rng, np.float32, (N, 2)), "PLAIN": _numeric(rng, np.int16, (N,))}
    hdr = pf.Header()
    hdr.set("TZERO1", 32768)                      # unsigned int16
    hdr.set("TSCAL2", 2)
    hdr.set("TZERO2", -7)
    hdr.set("TSCAL3", 0.5)
    hdr.set("TZERO3", 10.25)
    _write(path, cols, header=hdr)
    return _bytes_of(cols)


def _case_logical_tf(path):
    rng = _rng("tf")
    cols = {"ONE": _numeric(rng, bool, (N,)), "MANY": _numeric(rng, bool, (N, 5))}
    _write(path, cols)
    return _bytes_of(cols)


def _case_logical_10(path):
    """Logicals stored as bytes 1 and 0: written as a ``B`` column whose
    TFORM card is then changed to ``L`` in place."""
    rng = _rng("10")
    cols = {"FLAG": rng.integers(0, 2, size=(N, 4), dtype=np.uint8),
            "N": _numeric(rng, np.int64, (N,))}
    _write(path, cols)
    with open(path, "rb") as fh:
        data = fh.read()
    card = b"TFORM1  = '4B      '"
    assert data.count(card) == 1
    with open(path, "wb") as fh:
        fh.write(data.replace(card, b"TFORM1  = '4L      '"))
    return _bytes_of(cols)


def _case_string(path):
    rng = _rng("string")
    cols = {"NAME": np.array([f"star {i}" * (i % 3) for i in range(N)]),
            "K": _numeric(rng, np.int64, (N, 2)), "B": _numeric(rng, np.uint8, (N,))}
    _write(path, cols)
    return _bytes_of(cols)


def _case_heap(path):
    """A ``1PE(3)`` descriptor column and an ``I`` column over a heap of
    float32 arrays, then an IMAGE HDU that the reader must find past the
    heap (the writer makes no heap, so the HDU is built by hand)."""
    rng = _rng("heap")
    lengths = np.arange(N) % 3 + 1
    heap = _numeric(rng, ">f4", (int(lengths.sum()),)).tobytes()
    rows = np.zeros(N, dtype=[("desc", ">i4", (2,)), ("k", ">i2")])
    rows["desc"][:, 0] = lengths
    rows["desc"][:, 1] = 4 * np.concatenate([[0], np.cumsum(lengths)[:-1]])
    rows["k"] = _numeric(rng, np.int16, (N,))
    hdr = pf.Header()
    for key, value in (("XTENSION", "BINTABLE"), ("BITPIX", 8), ("NAXIS", 2),
                       ("NAXIS1", rows.itemsize), ("NAXIS2", N), ("PCOUNT", len(heap)),
                       ("GCOUNT", 1), ("TFIELDS", 2), ("TTYPE1", "VAR"), ("TFORM1", "1PE(3)"),
                       ("TTYPE2", "K"), ("TFORM2", "I"), ("EXTNAME", "TABLE")):
        hdr.set(key, value)
    data = rows.tobytes() + heap
    img = np.arange(6, dtype=">f4").reshape(2, 3)
    ihdr = pf.Header()
    for key, value in (("XTENSION", "IMAGE"), ("BITPIX", -32), ("NAXIS", 2), ("NAXIS1", 3),
                       ("NAXIS2", 2), ("PCOUNT", 0), ("GCOUNT", 1), ("EXTNAME", "AFTER")):
        ihdr.set(key, value)
    prim = pf.Header()
    for key, value in (("SIMPLE", True), ("BITPIX", 8), ("NAXIS", 0), ("EXTEND", True)):
        prim.set(key, value)

    def pad(b):
        return b + b"\0" * ((-len(b)) % pf.BLOCK)
    with open(path, "wb") as fh:
        fh.write(prim.to_bytes() + hdr.to_bytes() + pad(data) + ihdr.to_bytes()
                 + pad(img.tobytes()))
    return 2 * N


CASES = {f"{code}{repeat}": _case_code(code, dtype, repeat)
         for code, dtype in (("B", np.uint8), ("I", np.int16), ("J", np.int32),
                             ("K", np.int64), ("E", np.float32), ("D", np.float64),
                             ("L", bool))
         for repeat in (1, 6)}
CASES.update(tdim=_case_tdim, scaled=_case_scaled, logical_tf=_case_logical_tf,
             logical_10=_case_logical_10, string=_case_string, heap=_case_heap)


def _same_array(a, b):
    """Equal dtype, shape and values, bit for bit (NaN payloads and -0.0 too)."""
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype.kind in "fc":
        assert np.array_equal(a.view(f"u{a.dtype.itemsize}"), b.view(f"u{b.dtype.itemsize}"))
    else:
        assert np.array_equal(a, b)


def _fresh(arr):
    """A native-order, C-contiguous, writable array on memory of its own:
    it, or the array it views, owns its data (the file's bytes are no
    base of it)."""
    assert arr.dtype.isnative
    assert arr.flags.c_contiguous and arr.flags.writeable
    while arr.base is not None:
        assert isinstance(arr.base, np.ndarray)
        arr = arr.base
    assert arr.flags.owndata and arr.flags.writeable


def _gzip(path):
    with open(path, "rb") as fh:
        data = fh.read()
    with open(path + ".gz", "wb") as fh:
        fh.write(gzip.compress(data, mtime=0))
    os.unlink(path)
    return path + ".gz"


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gz"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_table_columns_match_the_jax_reader(case, gz, tmp_path):
    path = str(tmp_path / f"{case}.fits")
    numeric_bytes = CASES[case](path)
    if gz:
        path = _gzip(path)
    timings = {}
    with StageTimer(timings).recording():
        mine = pf.read_fits(path)
    theirs = jfits.read_fits(path)
    assert timings["fits_table_bytes"] == numeric_bytes
    assert [h.kind for h in mine] == [h.kind for h in theirs]
    for a, b in zip(mine, theirs):
        assert dict(a.header.items()) == dict(b.header.items())
        if a.kind != "bintable":
            assert (a.data is None) == (b.data is None)
            if a.data is not None:
                _same_array(a.data, b.data)
            continue
        assert list(a.data) == list(b.data)
        for name in a.data:
            _same_array(a.data[name], b.data[name])
            _fresh(a.data[name])


def _write_tpf(path, time):
    """A SPOC-layout TPF of 9x7 stamps over ``len(time)`` cadences."""
    rng = _rng(os.path.basename(path))
    T, shape = len(time), (9, 7)
    cube = (T,) + shape
    prim, pix = pf.Header(), pf.Header()
    for key, value in (("TELESCOP", "TESS"), ("TICID", 261136679), ("SECTOR", 14),
                       ("CAMERA", 2), ("CCD", 3), ("DATA_REL", 19)):
        prim.set(key, value)
    pix.set("TIMEDEL", 120 / 86400)
    pix.set("READNOIA", 9.5)
    pix.set("GAINA", 5.2)
    columns = {
        "TIME": time, "TIMECORR": rng.normal(size=T).astype(np.float32),
        "CADENCENO": np.arange(1000, 1000 + T, dtype=np.int32),
        "RAW_CNTS": rng.integers(0, 1 << 20, size=cube, dtype=np.int32),
        "FLUX": _numeric(rng, np.float32, cube), "FLUX_ERR": _numeric(rng, np.float32, cube),
        "FLUX_BKG": _numeric(rng, np.float32, cube),
        "FLUX_BKG_ERR": _numeric(rng, np.float32, cube),
        "COSMIC_RAYS": _numeric(rng, np.float32, cube),
        "QUALITY": rng.integers(0, 1 << 16, size=T, dtype=np.int32),
        "POS_CORR1": _numeric(rng, np.float32, (T,)),
        "POS_CORR2": _numeric(rng, np.float32, (T,))}
    aperture = rng.integers(0, 1 << 8, size=shape, dtype=np.int32)
    wcs = TanWCS(crpix=np.array([4.0, 5.0]), crval=np.array([150.1, -60.2]),
                 cd=np.array([[-5.8e-3, 1e-5], [2e-5, 5.8e-3]]))
    ap = wcs.to_header(pf.Header())
    ap.set("CRVAL1P", 1031)
    ap.set("CRVAL2P", 517)
    pf.write_fits(path, [pf.PrimaryHDU(None, header=prim),
                         pf.BinTableHDU(columns, header=pix, name="PIXELS"),
                         pf.ImageHDU(aperture, header=ap, name="APERTURE")])
    table = sum(a.dtype.itemsize * a.size for a in columns.values())
    return table, table + aperture.nbytes


def _same_field(a, b):
    if isinstance(a, np.ndarray):
        _same_array(a, b)
    elif dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__
        for f in dataclasses.fields(a):
            _same_field(getattr(a, f.name), getattr(b, f.name))
    else:
        assert a == b


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gz"])
@pytest.mark.parametrize("time", ["finite", "nan"])
def test_read_tpf_matches_the_jax_reader_and_counts_its_bytes(time, gz, tmp_path):
    t = 1683.35 + np.arange(53) * 120 / 86400
    if time == "nan":
        t[[0, 17, 18, 52]] = np.nan
    path = str(tmp_path / "tess-s0014-tp.fits") + (".gz" if gz else "")
    table, whole = _write_tpf(path, t)
    timings = {}
    with StageTimer(timings).recording():
        mine = tess.read_tpf(path)
    theirs = jtess.read_tpf(path)
    assert timings["fits_table_bytes"] == table and timings["fits_bytes"] == whole
    assert mine.flux.shape == (np.isfinite(t).sum(), 9, 7)
    assert mine.wcs is not None and mine.flux_bkg is not None and mine.pos_corr is not None
    for f in dataclasses.fields(mine):
        _same_field(getattr(mine, f.name), getattr(theirs, f.name))
    for arr in (mine.time, mine.timecorr, mine.cadenceno, mine.quality, mine.flux,
                mine.flux_err, mine.flux_bkg, mine.pos_corr):
        _fresh(arr)
