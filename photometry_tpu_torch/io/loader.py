"""
Threaded FFI frame prefetching for the prepare stage.

The port's own copy of ``photometry_tpu/io/loader.py``.  Reading a
sector's ~1300 gzipped FFIs is host-bound (inflate + byteswap + crop); the
reference hides some of this in multiprocessing pools (prepare.py:184-199).
Here a small thread pool keeps a bounded buffer of decoded frames ahead of
the consumer, so file I/O and decompression (zlib and numpy release the
GIL) overlap with device compute.
"""

from __future__ import annotations

import concurrent.futures
from typing import Iterator, Sequence

from .tess import FFIFrame, read_ffi

__all__ = ["iter_frames"]


def iter_frames(files: Sequence[str], workers: int = 4,
                prefetch: int = 8) -> Iterator[FFIFrame]:
    """Yield decoded FFI frames in file order with background prefetching."""
    if workers <= 1 or len(files) <= 1:
        for f in files:
            yield read_ffi(f)
        return
    with concurrent.futures.ThreadPoolExecutor(max_workers=workers) as pool:
        pending = {}
        nxt = 0          # next index to yield
        submitted = 0
        while nxt < len(files):
            while submitted < len(files) and submitted - nxt < prefetch:
                pending[submitted] = pool.submit(read_ffi, files[submitted])
                submitted += 1
            yield pending.pop(nxt).result()
            nxt += 1
