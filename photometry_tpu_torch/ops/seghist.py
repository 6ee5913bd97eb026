"""
Exact per-frame (segment x bucket) count tables.

    hist[f, s, b] = #{i : seg[i] == s, bucket[f, i] == b, good[f, i]}

The table of ``photometry_tpu/ops/stats.py:_segment_histogram_matmul``
and of the TPU's Pallas kernel ``ops/hist_pallas.py:_kernel``, which
``stats.segment_kde_mode`` builds for the ring modes of the background's
radial component (three times per frame in the prepare stage).

- On a CUDA tensor the table comes from the hand-written Hopper kernel
  ``ops/csrc/segment_hist.cu`` (:func:`segment_histogram_cuda`): one launch
  for all frames, one wave of blocks (:func:`blocks_per_frame`), each
  counting 4 samples a thread and step (:func:`vector_head`) into a private
  shared-memory table.
- On a CPU tensor it is one ``torch.bincount`` of the flat (frame,
  segment, bucket) cell of every good sample
  (:func:`segment_histogram_plain`), also what ``chip_smoke.py`` holds the
  kernel against on the card.

Samples whose segment or bucket is out of range are not counted.  Counts
are exact integers, returned as float32 like the JAX functions.  A CUDA
tensor always goes to the kernel or raises; nothing falls back.
"""

from __future__ import annotations

import functools

import torch

from ._kernels import SEGMENT_HIST, KernelError

__all__ = ["segment_histogram", "segment_histogram_plain", "segment_histogram_cuda",
           "blocks_per_frame", "vector_head"]

#: Fewest samples a block strides over before more blocks per frame are added.
_MIN_SAMPLES_PER_BLOCK = 32768


def blocks_per_frame(n_frames: int, n: int, resident: int) -> int:
    """Blocks per frame of one launch: the device's ``resident`` blocks
    shared by the frames (one wave), never more than one per
    ``_MIN_SAMPLES_PER_BLOCK`` samples, at least one."""
    return max(1, min(resident // max(n_frames, 1), -(-n // _MIN_SAMPLES_PER_BLOCK)))


def vector_head(seg_ptr: int, bucket_ptr: int, good_ptr: int, n_frames: int, n: int) -> int:
    """Samples before the first 16-byte boundary that the kernel's 4-wide
    loads start from (0-3), or -1 for its scalar loop: the int32 ``seg``
    and ``bucket`` and the byte ``good`` must sit at the same offset mod 4
    elements, and every frame's row must keep it (``n % 4 == 0`` unless
    there is one frame)."""
    off = (bucket_ptr % 16) // 4
    if n < 8 or (n_frames > 1 and n % 4) or (seg_ptr % 16) // 4 != off or good_ptr % 4 != off:
        return -1
    return (4 - off) % 4


@functools.lru_cache(maxsize=None)
def _resident_blocks(device_index: int, n_segments: int, n_buckets: int) -> int:
    """Blocks of one ``n_segments x n_buckets`` table that run at once on
    the card (fixed for a device and table, so asked once); raises
    :class:`KernelError` for a table larger than one block's shared memory."""
    lib = SEGMENT_HIST.lib()
    with torch.cuda.device(device_index):
        cap = lib.segment_hist_max_cells()
        if n_segments * n_buckets > cap:
            raise KernelError(f"segment_hist: a {n_segments} x {n_buckets} table exceeds the "
                              f"{cap} int32 cells of one block's shared memory")
        resident = lib.segment_hist_resident_blocks(n_segments, n_buckets)
    if resident <= 0:
        raise KernelError(f"segment_hist occupancy query failed: CUDA error {-resident}")
    return resident


def _as_frames(bucket, good):
    if bucket.ndim == 1:
        return bucket[None], good[None], True
    return bucket, good, False


def segment_histogram_plain(seg, bucket, good, n_segments: int, n_buckets: int) -> torch.Tensor:
    """(F, n_segments, n_buckets) float32 counts by one ``bincount``.

    ``seg`` (N,) int, shared by the frames; ``bucket``/``good`` (F, N) or (N,).
    """
    bucket, good, squeeze = _as_frames(bucket, good)
    nf = bucket.shape[0]
    seg = seg.reshape(-1).long()
    ok = (good.to(torch.bool) & ((seg >= 0) & (seg < n_segments))[None]
          & (bucket >= 0) & (bucket < n_buckets))
    frame = torch.arange(nf, device=bucket.device)[:, None]
    cell = (frame * n_segments + seg[None]) * n_buckets + bucket.long()
    hist = torch.bincount(cell[ok], minlength=nf * n_segments * n_buckets)
    hist = hist.to(torch.float32).reshape(nf, n_segments, n_buckets)
    return hist[0] if squeeze else hist


def segment_histogram_cuda(seg, bucket, good, n_segments: int, n_buckets: int) -> torch.Tensor:
    """(F, n_segments, n_buckets) float32 counts from the CUDA kernel."""
    dev = bucket.device
    if dev.type != "cuda":
        raise ValueError(f"segment_histogram_cuda needs CUDA tensors, got {dev}")
    bucket, good, squeeze = _as_frames(bucket, good)
    nf, n = bucket.shape
    if seg.device != dev or seg.dtype != torch.int32 or seg.numel() != n:
        raise ValueError(f"seg: need an int32 ({n},) tensor on {dev}")
    if bucket.dtype != torch.int32 or not bucket.is_contiguous():
        raise ValueError("bucket: need a contiguous int32 (F, N) tensor")
    if (good.device != dev or good.dtype not in (torch.bool, torch.uint8)
            or tuple(good.shape) != (nf, n)):
        raise ValueError(f"good: need a bool/uint8 ({nf}, {n}) tensor on {dev}")
    if n_segments < 1 or n_buckets < 1 or nf > 65535:
        raise ValueError(f"unsupported shape: {nf} frames, {n_segments} x {n_buckets}")
    if nf == 0 or n == 0:
        out = torch.zeros(nf, n_segments, n_buckets, dtype=torch.float32, device=dev)
        return out[0] if squeeze else out
    resident = _resident_blocks(dev.index, n_segments, n_buckets)
    with torch.cuda.device(dev):
        counts = torch.empty(nf, n_segments, n_buckets, dtype=torch.int32, device=dev)
        out = torch.empty(nf, n_segments, n_buckets, dtype=torch.float32, device=dev)
        seg, good = seg.contiguous(), good.contiguous()
        head = vector_head(seg.data_ptr(), bucket.data_ptr(), good.data_ptr(), nf, n)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = SEGMENT_HIST.lib().segment_hist(
            seg.data_ptr(), bucket.data_ptr(), good.data_ptr(), counts.data_ptr(),
            out.data_ptr(), nf, n, n_segments, n_buckets, blocks_per_frame(nf, n, resident),
            head, stream)
    if rc != 0:
        raise KernelError(f"segment_hist launch failed: CUDA error {rc}")
    SEGMENT_HIST.launches += 1
    return out[0] if squeeze else out


def segment_histogram(seg, bucket, good, n_segments: int, n_buckets: int,
                      plain: bool = False) -> torch.Tensor:
    """The count table: the kernel for CUDA tensors, the plain version for
    CPU ones (or anywhere with ``plain``, for comparisons on the card)."""
    if plain or bucket.device.type == "cpu":
        return segment_histogram_plain(seg, bucket, good, n_segments, n_buckets)
    if bucket.device.type == "cuda":
        return segment_histogram_cuda(seg, bucket, good, n_segments, n_buckets)
    raise ValueError(f"no histogram path for device {bucket.device}")
