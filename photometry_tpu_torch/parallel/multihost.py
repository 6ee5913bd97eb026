"""
The host-level work split of several processes, over ``torch.distributed``.

Port of ``is_initialized`` and ``process_shard`` of
``photometry_tpu/parallel/multihost.py`` (its ``jax.distributed`` process
index and count become ``torch.distributed``'s rank and world size), as
``cli/movie_cmd`` uses them.  The multi-card programs of that module
(global meshes, sharded data) are not ported.
"""

from __future__ import annotations

from typing import Optional, Sequence

__all__ = ["is_initialized", "process_shard"]


def is_initialized() -> bool:
    """True when this process joined a ``torch.distributed`` process group."""
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def process_shard(items: Sequence, process_id: Optional[int] = None,
                  process_count: Optional[int] = None) -> list:
    """This process's strided slice ``items[pid::count]`` of a host-level
    work list (the cubes of a sector, movie jobs).  ``pid`` and ``count``
    default to the process group's rank and world size (0 and 1 outside
    one).  Raises on an inconsistent pair: 1-based ids or a count of 0
    would hand two processes overlapping shards."""
    if process_id is None or process_count is None:
        import torch.distributed as dist
        joined = is_initialized()
        pid = (dist.get_rank() if joined else 0) if process_id is None else process_id
        count = ((dist.get_world_size() if joined else 1) if process_count is None
                 else process_count)
    else:
        pid, count = process_id, process_count
    if count < 1:
        raise ValueError(f"process_count must be >= 1, got {count}")
    if not 0 <= pid < count:
        raise ValueError(f"process_id {pid} outside [0, {count}) — ids are 0-based; an "
                         f"out-of-range id would silently overlap another process's shard")
    return list(items)[pid::count]
