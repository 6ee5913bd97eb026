"""A plain FITS reader for the program's products: numpy and the stdlib only.

Reads a (possibly gzipped) file into a list of HDUs, each a dict with
``name``, ``header`` (keyword -> value) and ``data``: None, an image array
(NAXIS1 fastest, so shape (NAXISn, ..., NAXIS1)), or for a binary table a
dict of column name -> array (a column with TDIM keeps that shape per row).
It reads what the products hold: IMAGE extensions of int32, float32 or
float64 and BINTABLE extensions with the TFORM codes J, E and D, no
scaling, no variable-length arrays.  It is independent of the program's
own FITS code on purpose.
"""

import gzip
import re

import numpy as np

BLOCK = 2880
_BITPIX = {32: ">i4", -32: ">f4", -64: ">f8"}
_TFORM = {"J": (">i4", 4), "E": (">f4", 4), "D": (">f8", 8)}


def _value(raw: str):
    raw = raw.split("/", 1)[0].strip() if not raw.lstrip().startswith("'") else raw.strip()
    if raw.startswith("'"):
        end = raw.find("'", 1)
        while end != -1 and raw[end + 1:end + 2] == "'":
            end = raw.find("'", end + 2)
        return raw[1:end].replace("''", "'").rstrip()
    if raw in ("T", "F"):
        return raw == "T"
    try:
        return int(raw)
    except ValueError:
        pass
    try:
        return float(raw.replace("D", "E"))
    except ValueError:
        return raw


def _header(buf: bytes, pos: int):
    hdr = {}
    while True:
        block = buf[pos:pos + BLOCK]
        if len(block) < BLOCK:
            raise ValueError("truncated FITS header")
        pos += BLOCK
        for i in range(0, BLOCK, 80):
            card = block[i:i + 80].decode("ascii")
            key = card[:8].strip()
            if key == "END":
                return hdr, pos
            if card[8:10] == "= ":
                hdr[key] = _value(card[10:])


def read(path: str) -> list:
    with open(path, "rb") as fh:
        buf = fh.read()
    if buf[:2] == b"\x1f\x8b":
        buf = gzip.decompress(buf)
    hdus, pos = [], 0
    while pos + BLOCK <= len(buf):
        hdr, pos = _header(buf, pos)
        naxis = int(hdr.get("NAXIS", 0))
        dims = [int(hdr[f"NAXIS{i}"]) for i in range(1, naxis + 1)]
        nbytes = abs(int(hdr["BITPIX"])) // 8 * int(np.prod(dims)) if naxis else 0
        nbytes += int(hdr.get("PCOUNT", 0))
        raw = buf[pos:pos + nbytes]
        data = None
        if hdr.get("XTENSION") == "BINTABLE":
            data = _table(hdr, raw)
        elif naxis:
            data = np.frombuffer(raw, _BITPIX[int(hdr["BITPIX"])],
                                 int(np.prod(dims))).reshape(dims[::-1])
        hdus.append({"name": hdr.get("EXTNAME", "PRIMARY" if not hdus else ""), "header": hdr,
                     "data": data})
        pos += -(-nbytes // BLOCK) * BLOCK
    return hdus


def _table(hdr, raw):
    width, nrows = int(hdr["NAXIS1"]), int(hdr["NAXIS2"])
    rows = np.frombuffer(raw, np.uint8, width * nrows).reshape(nrows, width)
    out, off = {}, 0
    for i in range(1, int(hdr["TFIELDS"]) + 1):
        m = re.fullmatch(r"(\d*)([A-Z])", str(hdr[f"TFORM{i}"]).strip())
        count = int(m.group(1) or 1)
        dtype, size = _TFORM[m.group(2)]
        cell = rows[:, off:off + count * size].copy()
        off += count * size
        col = cell.view(dtype).reshape(nrows, count)
        tdim = hdr.get(f"TDIM{i}")
        if tdim:
            shape = [int(x) for x in tdim.strip("() ").split(",")][::-1]
            col = col.reshape(nrows, *shape)
        elif count == 1:
            col = col[:, 0]
        out[str(hdr[f"TTYPE{i}"]).strip()] = col.astype(col.dtype.newbyteorder("="))
    return out


def hdu(hdus: list, name: str) -> dict:
    for h in hdus:
        if h["name"] == name:
            return h
    raise KeyError(name)
