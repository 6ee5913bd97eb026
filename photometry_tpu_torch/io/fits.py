"""
Minimal, dependency-free FITS reader/writer.

The port's own copy of ``photometry_tpu/io/fits.py`` (the parts the light
curve products and the cube's WCS need): the same bytes on disk, with the
gunzip of reads, the byteswap of float32 images of 1 MB and more and the
gzip of writes done by the native host runtime (``native_ops``, which falls
back to the standard library and numpy where it did not build).

The reference pipeline leans on astropy.io.fits for every product (TESS FFIs,
TPFs, light curves — e.g. photometry/io.py:25-93, BasePhotometry.py:1417-1728).
astropy is not a dependency of this framework: FITS only appears at the host
I/O boundary, so a small, fast, NumPy-native implementation is all that is
needed.  Supports:

- Primary + IMAGE + BINTABLE HDUs, read and write.
- BITPIX 8/16/32/64/-32/-64 with BSCALE/BZERO (incl. the unsigned-int
  convention BZERO=2**(bits-1)).
- BINTABLE TFORM codes L, B, I, J, K, E, D, A (with repeat counts) and
  2-D column arrays via TDIM.
- Transparent gzip by filename extension (``.gz``).

Everything is host-side numpy; device code never touches FITS.
"""

from __future__ import annotations

import gzip
import io as _io
import numpy as np

from ..native_ops import bswap_f32, gunzip, gzip_compress

BLOCK = 2880

__all__ = ["Header", "HDU", "read_fits", "write_fits", "PrimaryHDU",
           "ImageHDU", "BinTableHDU", "verify_checksums"]


# ---------------------------------------------------------------------------
# FITS checksums (Seaman & Pence; reference writes them via astropy at
# BasePhotometry.py:1720-1722 with checksum=True)
# ---------------------------------------------------------------------------

def _ones_complement_sum(data: bytes, start: int = 0) -> int:
    """32-bit ones'-complement sum of big-endian words (FITS checksum core)."""
    if len(data) % 4:
        data = data + b"\x00" * ((-len(data)) % 4)
    words = np.frombuffer(data, dtype=">u4").astype(np.uint64)
    s = int(start) + int(words.sum())
    while s >> 32:
        s = (s & 0xFFFFFFFF) + (s >> 32)
    return s


_CHECKSUM_EXCLUDE = frozenset(b":;<=>?@[\\]^_`")


def _encode_checksum(value: int) -> str:
    """ASCII-encode the complement of ``value`` per the FITS standard.

    Each of the 4 bytes of ``~value`` is split into 4 printable chars
    (offset '0') that sum back to the byte, punctuation avoided by paired
    +1/-1 shifts, interleaved, then rotated right one place.
    """
    value = (~value) & 0xFFFFFFFF
    ascii_ = bytearray(16)
    for j in range(4):
        byte = (value >> (24 - 8 * j)) & 0xFF
        quotient = byte // 4 + ord("0")
        remainder = byte % 4
        ch = [quotient] * 4
        ch[0] += remainder
        changed = True
        while changed:
            changed = False
            for k in (0, 2):
                if ch[k] in _CHECKSUM_EXCLUDE or ch[k + 1] in _CHECKSUM_EXCLUDE:
                    ch[k] += 1
                    ch[k + 1] -= 1
                    changed = True
        for k in range(4):
            ascii_[4 * k + j] = ch[k]
    # rotate right by one character:
    return (ascii_[-1:] + ascii_[:-1]).decode("ascii")


def _hdu_bytes_with_checksum(hdr: Header, data_raw: bytes) -> bytes:
    """Render one HDU with valid DATASUM/CHECKSUM keywords.

    The header is rendered ONCE with the '0'*16 CHECKSUM placeholder and the
    encoded value patched into the card bytes in place — re-rendering the
    whole header for the final value doubled the hot product path's card
    formatting cost.
    """
    datasum = _ones_complement_sum(data_raw)
    hdr.set("DATASUM", str(datasum), "data unit checksum")
    hdr.set("CHECKSUM", "0" * 16, "HDU checksum")
    raw_hdr = bytearray(hdr.to_bytes())
    total = _ones_complement_sum(bytes(raw_hdr), start=datasum)
    encoded = _encode_checksum(total)
    hdr.set("CHECKSUM", encoded, "HDU checksum")
    # The placeholder card renders as CHECKSUM= '0000000000000000' — the
    # 16 encoded chars land exactly where the 16 zeros sit (cards are
    # 80-byte aligned, value starts at column 10, string opens with a quote):
    off = raw_hdr.find(b"CHECKSUM= '0000000000000000'")
    if off < 0 or off % 80:  # unexpected layout: fall back to a re-render
        return hdr.to_bytes() + data_raw
    raw_hdr[off + 11:off + 27] = encoded.encode("ascii")
    return bytes(raw_hdr) + data_raw


# ---------------------------------------------------------------------------
# Header
# ---------------------------------------------------------------------------

def verify_checksums(path) -> list:
    """Verify CHECKSUM/DATASUM of every HDU in a file.

    Returns one dict per HDU: {"checksum_ok": bool|None, "datasum_ok":
    bool|None} (None when the HDU carries no such keyword).
    """
    results = []
    with _open_maybe_gzip(path, "rb") as fh:
        while True:
            hdr_raw = b""
            done = False
            while True:
                block = fh.read(BLOCK)
                if len(block) < BLOCK:
                    done = True
                    break
                hdr_raw += block
                if any(block[i:i + 8].rstrip() == b"END" for i in range(0, BLOCK, 80)):
                    break
            if done or not hdr_raw:
                break
            hdr = Header.from_bytes(hdr_raw)
            naxis = int(hdr.get("NAXIS", 0))
            nbytes = 0
            if naxis:
                nbytes = abs(int(hdr["BITPIX"])) // 8
                for i in range(1, naxis + 1):
                    nbytes *= int(hdr[f"NAXIS{i}"])
                nbytes += int(hdr.get("PCOUNT", 0)) * abs(int(hdr["BITPIX"])) // 8
            data_raw = fh.read(nbytes + ((-nbytes) % BLOCK))
            out = {"checksum_ok": None, "datasum_ok": None}
            if "DATASUM" in hdr:
                out["datasum_ok"] = int(str(hdr["DATASUM"])) == _ones_complement_sum(data_raw)
            if "CHECKSUM" in hdr:
                # a valid HDU sums to all ones:
                out["checksum_ok"] = _ones_complement_sum(hdr_raw + data_raw) == 0xFFFFFFFF
            results.append(out)
    return results


class Header:
    """Ordered FITS header: mapping from keyword to (value, comment).

    Access like a dict (``hdr['NAXIS']`` -> value); ``hdr.comment(key)``
    returns the comment.  Values are parsed into bool/int/float/str.
    """

    def __init__(self, cards=None):
        self._keys: list = []
        self._values: dict = {}
        self._comments: dict = {}
        if cards:
            for k, v, c in cards:
                self.set(k, v, c)

    # -- mapping interface ---------------------------------------------------
    def __contains__(self, key):
        return key.upper() in self._values

    def __getitem__(self, key):
        return self._values[key.upper()]

    def __setitem__(self, key, value):
        if isinstance(value, tuple) and len(value) == 2:
            self.set(key, value[0], value[1])
        else:
            self.set(key, value)

    def __delitem__(self, key):
        key = key.upper()
        self._keys.remove(key)
        del self._values[key]
        self._comments.pop(key, None)

    def __iter__(self):
        return iter(self._keys)

    def __len__(self):
        return len(self._keys)

    def get(self, key, default=None):
        return self._values.get(key.upper(), default)

    def set(self, key, value, comment=None):
        key = key.upper()
        if key not in self._values:
            self._keys.append(key)
        self._values[key] = value
        if comment is not None:
            self._comments[key] = comment

    def comment(self, key):
        return self._comments.get(key.upper(), "")

    def items(self):
        for k in self._keys:
            yield k, self._values[k]

    def copy(self):
        h = Header()
        h._keys = list(self._keys)
        h._values = dict(self._values)
        h._comments = dict(self._comments)
        return h

    # -- parsing -------------------------------------------------------------
    @staticmethod
    def _parse_value(raw: str):
        raw = raw.strip()
        if not raw:
            return None
        if raw.startswith("'"):
            # FITS string: quoted, '' escapes a quote, trailing spaces stripped
            end = 1
            buf = []
            while end < len(raw):
                if raw[end] == "'":
                    if end + 1 < len(raw) and raw[end + 1] == "'":
                        buf.append("'")
                        end += 2
                        continue
                    break
                buf.append(raw[end])
                end += 1
            return "".join(buf).rstrip()
        if raw == "T":
            return True
        if raw == "F":
            return False
        try:
            if any(c in raw for c in ".eEdD") and not raw.lstrip("+-").isdigit():
                return float(raw.replace("D", "E").replace("d", "e"))
            return int(raw)
        except ValueError:
            return raw

    @classmethod
    def from_bytes(cls, data: bytes) -> "Header":
        hdr = cls()
        for i in range(0, len(data), 80):
            card = data[i:i + 80].decode("ascii", errors="replace")
            key = card[:8].strip()
            if key == "END":
                break
            if key in ("COMMENT", "HISTORY", ""):
                continue
            if card[8:10] != "= ":
                continue
            rest = card[10:]
            # split value / comment at first '/' outside quotes
            in_str = False
            slash = -1
            j = 0
            while j < len(rest):
                ch = rest[j]
                if ch == "'":
                    in_str = not in_str
                elif ch == "/" and not in_str:
                    slash = j
                    break
                j += 1
            if slash >= 0:
                valstr, comment = rest[:slash], rest[slash + 1:].strip()
            else:
                valstr, comment = rest, ""
            hdr.set(key, cls._parse_value(valstr), comment or None)
        return hdr

    # -- formatting ----------------------------------------------------------
    @staticmethod
    def _format_value(value) -> str:
        if isinstance(value, bool) or isinstance(value, np.bool_):
            return ("T" if value else "F").rjust(20)
        if isinstance(value, (int, np.integer)):
            return str(int(value)).rjust(20)
        if isinstance(value, (float, np.floating)):
            if np.isnan(value):
                return "".rjust(20)  # undefined
            s = repr(float(value))
            if "e" in s:
                s = f"{float(value):.16E}"
            return s.rjust(20)
        if value is None:
            return "".rjust(20)
        s = str(value).replace("'", "''")
        return ("'" + s.ljust(8) + "'").ljust(20)

    def to_bytes(self) -> bytes:
        out = []
        for key in self._keys:
            value = self._values[key]
            comment = self._comments.get(key, "")
            card = f"{key[:8]:<8}= {self._format_value(value)}"
            if comment:
                card += " / " + comment
            out.append(card[:80].ljust(80))
        out.append("END".ljust(80))
        raw = "".join(out).encode("ascii")
        pad = (-len(raw)) % BLOCK
        return raw + b" " * pad


# ---------------------------------------------------------------------------
# HDUs
# ---------------------------------------------------------------------------

_BITPIX_DTYPE = {8: ">u1", 16: ">i2", 32: ">i4", 64: ">i8", -32: ">f4", -64: ">f8"}
_DTYPE_BITPIX = {"u1": 8, "i2": 16, "i4": 32, "i8": 64, "f4": -32, "f8": -64}

_TFORM_DTYPE = {"L": "?", "B": "u1", "I": ">i2", "J": ">i4", "K": ">i8",
                "E": ">f4", "D": ">f8"}


class HDU:
    """One header-data unit. ``data`` is an ndarray (image) or dict of columns."""

    def __init__(self, data=None, header: Header = None, name: str = None,
                 kind: str = "image"):
        self.data = data
        self.header = header if header is not None else Header()
        self.kind = kind  # 'image' | 'bintable'
        if name:
            self.header.set("EXTNAME", name)

    @property
    def name(self):
        return self.header.get("EXTNAME", "")

    def columns(self):
        """Column names for a bintable HDU."""
        if self.kind != "bintable":
            raise TypeError("not a table HDU")
        return list(self.data.keys())


def PrimaryHDU(data=None, header=None):
    return HDU(data=data, header=header, kind="image")


def ImageHDU(data=None, header=None, name=None):
    return HDU(data=data, header=header, name=name, kind="image")


def BinTableHDU(columns: dict, header=None, name=None):
    """Build a bintable HDU from an ordered {name: ndarray} mapping."""
    return HDU(data=dict(columns), header=header, name=name, kind="bintable")


# ---------------------------------------------------------------------------
# Reading
# ---------------------------------------------------------------------------

def _open_maybe_gzip(path, mode="rb", compresslevel=6):
    if str(path).endswith(".gz"):
        if "r" in mode:
            # Whole-file native inflate (GIL-free zlib) instead of Python's
            # incremental gzip stream: the loader's threads overlap these calls.
            with open(path, "rb") as fh:
                data = fh.read()
            return _io.BytesIO(gunzip(data))
        return gzip.open(path, mode, compresslevel=compresslevel)
    return open(path, mode)


def _read_header(fh) -> Header:
    blocks = b""
    while True:
        block = fh.read(BLOCK)
        if len(block) < BLOCK:
            if not blocks:
                return None
            raise EOFError("Truncated FITS header")
        blocks += block
        # look for the END card at an 80-byte boundary
        for i in range(0, len(block), 80):
            if block[i:i + 8].rstrip() == b"END":
                return Header.from_bytes(blocks)


def _parse_tform(tform: str):
    tform = tform.strip()
    i = 0
    while i < len(tform) and tform[i].isdigit():
        i += 1
    repeat = int(tform[:i]) if i else 1
    code = tform[i]
    return repeat, code


def _strip_scaling(hdr: Header) -> None:
    """Drop BSCALE/BZERO after they were applied on read, so writing the
    (now physical) data back with the same header cannot double-scale it
    for the next reader (astropy strips them the same way)."""
    for key in ("BSCALE", "BZERO"):
        if hdr.get(key) is not None:
            del hdr[key]


def _read_data(fh, hdr: Header):
    naxis = int(hdr.get("NAXIS", 0))
    if naxis == 0:
        return None, "image"
    xtension = str(hdr.get("XTENSION", "")).strip().upper()
    shape = [int(hdr[f"NAXIS{i}"]) for i in range(naxis, 0, -1)]
    nbytes_per_elem = abs(int(hdr["BITPIX"])) // 8
    total = int(np.prod(shape)) * nbytes_per_elem
    raw = fh.read(total)
    if len(raw) < total:
        raise EOFError("Truncated FITS data")
    # The data block also contains PCOUNT heap bytes (variable-length
    # array columns); skip them so the next HDU's header parse does not
    # consume heap bytes as cards.  (Variable-length columns themselves
    # are not decoded — their descriptors come back as raw P/Q pairs.)
    pcount = int(hdr.get("PCOUNT", 0) or 0)
    if pcount:
        fh.read(pcount)
    fh.read((-(total + pcount)) % BLOCK)  # skip padding

    if xtension == "BINTABLE":
        nrows = shape[0]
        rowlen = shape[1]
        tfields = int(hdr["TFIELDS"])
        rec = np.frombuffer(raw, dtype=np.uint8).reshape(nrows, rowlen)
        cols = {}
        offset = 0
        for f in range(1, tfields + 1):
            name = str(hdr.get(f"TTYPE{f}", f"COL{f}")).strip()
            repeat, code = _parse_tform(str(hdr[f"TFORM{f}"]))
            if code == "A":
                width = repeat
                data = rec[:, offset:offset + width].tobytes()
                arr = np.array([data[i * width:(i + 1) * width].decode("ascii").rstrip()
                                for i in range(nrows)])
                offset += width
            elif code in ("P", "Q"):
                # variable-length array descriptor: (count, heap offset)
                # pairs; returned raw (the heap itself is skipped below):
                dt = np.dtype(">i4" if code == "P" else ">i8")
                width = dt.itemsize * 2 * repeat
                arr = np.frombuffer(rec[:, offset:offset + width].tobytes(),
                                    dtype=dt).reshape(nrows, 2 * repeat)
                arr = arr.astype(arr.dtype.newbyteorder("="))
                offset += width
                cols[name] = arr
                continue
            else:
                dt = np.dtype(_TFORM_DTYPE[code])
                width = dt.itemsize * repeat
                arr = rec[:, offset:offset + width].tobytes()
                arr = np.frombuffer(arr, dtype=dt).reshape(nrows, repeat)
                tdim = hdr.get(f"TDIM{f}")
                if tdim:
                    dims = tuple(int(x) for x in str(tdim).strip("() ").split(","))
                    arr = arr.reshape((nrows,) + dims[::-1])
                elif repeat == 1:
                    arr = arr[:, 0]
                arr = arr.astype(arr.dtype.newbyteorder("="))
                offset += width
            if code == "L":
                # FITS logicals are ASCII 'T'/'F' bytes (both nonzero!);
                # this module's own writer stores 1/0 which also decodes
                # correctly here:
                arr = (arr.view(np.uint8) == ord("T")) | (arr.view(np.uint8) == 1)
            # apply column scaling if present, then strip the keywords so a
            # read-modify-write does not double-apply them (astropy does
            # the same after scaling on read):
            tz = hdr.get(f"TZERO{f}")
            ts = hdr.get(f"TSCAL{f}")
            if ts is not None or tz is not None:
                if arr.dtype.kind in "iu":
                    # promote first: under NumPy 2 (NEP 50) int16 + 32768
                    # raises OverflowError instead of upcasting — and the
                    # unsigned convention (TZERO=2^(bits-1)) is exactly
                    # that case:
                    arr = arr.astype(np.int64)
                arr = arr * (ts if ts is not None else 1) + (tz if tz is not None else 0)
                for key in (f"TZERO{f}", f"TSCAL{f}"):
                    if hdr.get(key) is not None:
                        del hdr[key]
            cols[name] = arr
        return cols, "bintable"

    dtype = np.dtype(_BITPIX_DTYPE[int(hdr["BITPIX"])])
    if int(hdr["BITPIX"]) == -32 and len(raw) >= (1 << 20):
        # Hot ingestion path: threaded native byteswap for large images.
        arr = bswap_f32(raw).reshape(shape)
        bscale = hdr.get("BSCALE", 1)
        bzero = hdr.get("BZERO", 0)
        if bscale != 1 or bzero != 0:
            arr = arr * bscale + bzero
            _strip_scaling(hdr)
        return arr, "image"
    arr = np.frombuffer(raw, dtype=dtype).reshape(shape)
    bscale = hdr.get("BSCALE", 1)
    bzero = hdr.get("BZERO", 0)
    if bscale != 1 or bzero != 0:
        if isinstance(bscale, int) and isinstance(bzero, int) and arr.dtype.kind in "iu":
            arr = arr.astype(np.int64) * bscale + bzero
        else:
            arr = arr.astype(np.float64) * bscale + bzero
        _strip_scaling(hdr)
    else:
        arr = arr.astype(dtype.newbyteorder("="))
    return arr, "image"


def read_fits(path) -> list:
    """Read all HDUs of a FITS file (optionally gzipped). Returns [HDU, ...]."""
    hdus = []
    with _open_maybe_gzip(path, "rb") as fh:
        while True:
            try:
                hdr = _read_header(fh)
            except EOFError:
                break
            if hdr is None:
                break
            data, kind = _read_data(fh, hdr)
            hdus.append(HDU(data=data, header=hdr, kind=kind))
    if not hdus:
        raise OSError(f"Not a FITS file: {path}")
    return hdus


# ---------------------------------------------------------------------------
# Writing
# ---------------------------------------------------------------------------

def _image_header(data, primary: bool, user_header: Header) -> Header:
    hdr = Header()
    if primary:
        hdr.set("SIMPLE", True, "conforms to FITS standard")
    else:
        hdr.set("XTENSION", "IMAGE", "image extension")
    if data is None:
        hdr.set("BITPIX", 8)
        hdr.set("NAXIS", 0)
    else:
        key = data.dtype.str[1:]
        if key not in _DTYPE_BITPIX:
            raise TypeError(f"Unsupported image dtype {data.dtype}")
        hdr.set("BITPIX", _DTYPE_BITPIX[key])
        hdr.set("NAXIS", data.ndim)
        for i, n in enumerate(reversed(data.shape)):
            hdr.set(f"NAXIS{i + 1}", int(n))
    if not primary:
        hdr.set("PCOUNT", 0)
        hdr.set("GCOUNT", 1)
    if user_header is not None:
        for k, v in user_header.items():
            if k in ("SIMPLE", "XTENSION", "BITPIX", "NAXIS", "PCOUNT", "GCOUNT") or k.startswith("NAXIS"):
                continue
            hdr.set(k, v, user_header.comment(k) or None)
    return hdr


_NP_TFORM = {"?": "L", "b": "B", "u1": "B", "i2": "I", "i4": "J", "i8": "K",
             "f4": "E", "f8": "D"}


def _column_spec(arr: np.ndarray):
    """(tform, big-endian dtype, flattened-per-row shape) for one column."""
    if arr.dtype.kind in ("U", "S"):
        width = int(str(arr.dtype).split(arr.dtype.kind)[-1] or 1)
        return f"{width}A", None, width
    key = arr.dtype.str[1:]
    if key == "i1":
        key = "b"
    elif key == "b1":   # numpy bool dtype.str is '|b1'
        key = "?"
    code = _NP_TFORM.get(key)
    if code is None:
        raise TypeError(f"Unsupported column dtype {arr.dtype}")
    repeat = int(np.prod(arr.shape[1:])) if arr.ndim > 1 else 1
    tform = f"{repeat}{code}" if repeat != 1 else code
    be = np.dtype(_TFORM_DTYPE[code])
    return tform, be, repeat


def _bintable_parts(cols: dict, user_header: Header, name) -> tuple:
    names = list(cols.keys())
    arrays = [np.asarray(cols[n]) for n in names]
    nrows = len(arrays[0]) if arrays else 0
    specs = [_column_spec(a) for a in arrays]
    rowlen = 0
    for (tform, be, repeat), arr in zip(specs, arrays):
        rowlen += repeat if be is None else be.itemsize * repeat

    hdr = Header()
    hdr.set("XTENSION", "BINTABLE", "binary table extension")
    hdr.set("BITPIX", 8)
    hdr.set("NAXIS", 2)
    hdr.set("NAXIS1", rowlen, "width of table in bytes")
    hdr.set("NAXIS2", nrows, "number of rows in table")
    hdr.set("PCOUNT", 0)
    hdr.set("GCOUNT", 1)
    hdr.set("TFIELDS", len(names))
    for i, (n, (tform, be, repeat), arr) in enumerate(zip(names, specs, arrays), start=1):
        hdr.set(f"TTYPE{i}", n)
        hdr.set(f"TFORM{i}", tform)
        if arr.ndim > 2:
            hdr.set(f"TDIM{i}", "(" + ",".join(str(s) for s in arr.shape[:0:-1]) + ")")
    if name:
        hdr.set("EXTNAME", name)
    if user_header is not None:
        for k, v in user_header.items():
            if k.startswith(("NAXIS", "TTYPE", "TFORM", "TDIM")) or k in (
                    "XTENSION", "BITPIX", "PCOUNT", "GCOUNT", "TFIELDS", "EXTNAME"):
                continue
            hdr.set(k, v, user_header.comment(k) or None)

    buf = np.zeros((nrows, rowlen), dtype=np.uint8)
    offset = 0
    for (tform, be, repeat), arr in zip(specs, arrays):
        if be is None:  # string column
            width = repeat
            raw = np.zeros((nrows, width), dtype="S1")
            for r in range(nrows):
                s = str(arr[r])[:width].encode("ascii")
                raw[r, :len(s)] = np.frombuffer(s, dtype="S1")
            buf[:, offset:offset + width] = raw.view(np.uint8)
            offset += width
        else:
            flat = arr.reshape(nrows, repeat).astype(be)
            if tform.endswith("L"):
                # standard FITS logicals are ASCII 'T'/'F', not 1/0:
                flat = np.where(flat, np.uint8(ord("T")), np.uint8(ord("F")))
            width = be.itemsize * repeat
            buf[:, offset:offset + width] = flat.view(np.uint8).reshape(nrows, width)
            offset += width
    raw = buf.tobytes()
    pad = (-len(raw)) % BLOCK
    return hdr, raw + b"\x00" * pad


def write_fits(path, hdus: list, overwrite: bool = True, checksum: bool = True,
               gzip_level: int = 6):
    """Write a list of HDUs to ``path`` (gzip if it ends with .gz).

    With ``checksum`` (default, like the reference's astropy writeto at
    BasePhotometry.py:1720-1722), every HDU gets CHECKSUM/DATASUM keywords.

    ``gzip_level`` tunes deflate effort for ``.gz`` paths.  Level 9 (the
    stdlib gzip default) spends ~8x the CPU of level 2 for <2% smaller
    light-curve files on real payloads — per-target product writing is the
    production drain's hot host loop, so the light-curve writer passes the
    ``[products] gzip_level`` setting here (default 2).
    """
    if not overwrite:
        import os
        if os.path.exists(path):
            raise FileExistsError(path)
    out = _io.BytesIO()
    for i, hdu in enumerate(hdus):
        if hdu.kind == "bintable":
            if i == 0:
                raise ValueError("Primary HDU cannot be a bintable")
            hdr, raw = _bintable_parts(hdu.data, hdu.header, hdu.name or None)
        else:
            data = hdu.data
            if data is not None:
                data = np.ascontiguousarray(data)
                key = data.dtype.str[1:]
                if key not in _DTYPE_BITPIX:
                    data = data.astype(">f8" if data.dtype.kind == "f" else ">i8")
            hdr = _image_header(data, primary=(i == 0), user_header=hdu.header)
            if i == 0:
                hdr.set("EXTEND", True)
            raw = b""
            if data is not None:
                raw = data.astype(data.dtype.newbyteorder(">")).tobytes()
                raw += b"\x00" * ((-len(raw)) % BLOCK)
        if checksum:
            out.write(_hdu_bytes_with_checksum(hdr, raw))
        else:
            out.write(hdr.to_bytes() + raw)
    payload = out.getvalue()
    if str(path).endswith(".gz"):
        # One-shot gzip with MTIME 0 (libdeflate where linked, GIL-free):
        # the product writer threads overlap here, and a product's bytes
        # depend on its content only.
        blob = gzip_compress(payload, level=gzip_level)
        with open(path, "wb") as fh:
            fh.write(blob)
    else:
        with open(path, "wb") as fh:
            fh.write(payload)
