"""
Multi-process device meshes over ``torch.distributed``.

Port of ``photometry_tpu/parallel/multihost.py``: its ``jax.distributed``
coordination service becomes a ``torch.distributed`` process group (gloo on
the CPU, NCCL on cards), the process index and count its rank and world
size.  Two ways to use several processes:

- share-nothing work lists: :func:`process_shard` hands each process its
  strided slice of the cubes of a sector or of movie jobs (``prepare``,
  ``cli/movie_cmd``);
- one sharded program over every process's devices: :func:`global_mesh`
  lays out a (time, targets) mesh whose target rows never cross a process
  (the time axis is the one that may: its only traffic is the halo frames
  of the background smoothing and the partial sums of the sum image, which
  ``parallel.sharded`` exchanges with send/recv and ``all_gather``), and
  :func:`local_data_slice` names the frames a process must load.

Typical launch (the same program in every process)::

    from photometry_tpu_torch.parallel import multihost
    multihost.initialize("10.0.0.1:1234", num_processes=2, process_id=rank)
    mesh = multihost.global_mesh(n_targets=4)
    frames = multihost.local_data_slice(n_frames, mesh)

A single process may skip :func:`initialize` (or call it: without a
coordinator or a cluster environment it is a no-op) and every helper
degrades to ``parallel/mesh.py``'s local mesh.
"""

from __future__ import annotations

import datetime
import logging
import os
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from .mesh import TARGET_AXIS, TIME_AXIS, Mesh, visible_devices

logger = logging.getLogger(__name__)

__all__ = ["initialize", "shutdown", "is_initialized", "global_mesh", "process_shard",
           "local_data_slice", "ProcessDevice"]

#: Environment variables that say a cluster launched this process.
_CLUSTER_ENV = ("SLURM_JOB_ID", "OMPI_COMM_WORLD_SIZE", "MASTER_ADDR",
                "PHOTOMETRY_TPU_COORDINATOR_ADDRESS")

#: This process's devices as :func:`initialize` was told them (None: every
#: visible card, or the CPU for a gloo group).
_local_devices: Optional[list] = None
_device_type = "cuda"


@dataclass(frozen=True)
class ProcessDevice:
    """A device of one process in a global mesh: the process's rank, the
    device's place among that process's devices, and the torch device it
    names in that process."""
    process_index: int
    id: int
    device: torch.device

    def __repr__(self):
        return f"p{self.process_index}.{self.id}:{self.device}"


def is_initialized() -> bool:
    """True when this process joined a ``torch.distributed`` process group."""
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def _rank_and_size():
    import torch.distributed as dist
    if is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _cluster_env() -> Optional[tuple]:
    """(address, world size, rank) from a cluster launcher's environment,
    None when there is none.  ``PHOTOMETRY_TPU_MULTIHOST=1`` forces the
    ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK`` reading."""
    env = os.environ
    forced = env.get("PHOTOMETRY_TPU_MULTIHOST", "") not in ("", "0")
    if not forced and not any(v in env for v in _CLUSTER_ENV):
        return None
    addr = env.get("PHOTOMETRY_TPU_COORDINATOR_ADDRESS")
    if addr is None and "MASTER_ADDR" in env:
        addr = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    size = next((int(env[v]) for v in ("WORLD_SIZE", "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE")
                 if v in env), None)
    rank = next((int(env[v]) for v in ("RANK", "SLURM_PROCID", "OMPI_COMM_WORLD_RANK")
                 if v in env), None)
    if addr is None or size is None or rank is None:
        raise RuntimeError("multihost.initialize: a cluster environment without a "
                           "coordinator address, world size and rank (set MASTER_ADDR, "
                           "MASTER_PORT, WORLD_SIZE and RANK)")
    return addr, size, rank


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids: Optional[Sequence[int]] = None,
               device="cuda", timeout: float = 300.0) -> int:
    """Join (or, as process 0, start) the process group.

    - With no arguments and no cluster environment (SLURM, Open MPI,
      ``torchrun``'s ``MASTER_ADDR``) this is a **no-op** that returns 0,
      so single-process code can call it unconditionally.
    - With ``coordinator_address="host:port"``, ``num_processes`` and
      ``process_id``: ``init_method="tcp://host:port"``, the rank
      ``process_id``; process 0 must be reachable there.

    ``device`` picks the backend: NCCL for ``"cuda"``, gloo for ``"cpu"``.
    ``local_device_ids`` are this process's cards (default: every visible
    one); the first becomes the current device.  ``timeout`` (seconds)
    bounds every collective.  Returns this process's rank.
    """
    global _local_devices, _device_type
    import torch.distributed as dist
    if is_initialized():
        return dist.get_rank()
    if coordinator_address is None:
        found = _cluster_env()
        if found is None:
            logger.warning("multihost.initialize: no coordinator address and no cluster "
                           "environment: running as one process.  Set "
                           "PHOTOMETRY_TPU_MULTIHOST=1 with MASTER_ADDR, MASTER_PORT, "
                           "WORLD_SIZE and RANK to join a group.")
            return 0
        coordinator_address, num_processes, process_id = found
    if num_processes is None or process_id is None:
        raise ValueError("num_processes and process_id go with coordinator_address")
    kind = torch.device(device).type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"device={device!r}: need cuda (NCCL) or cpu (gloo)")
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("multihost.initialize(device='cuda'): CUDA is not available")
        ids = list(local_device_ids) if local_device_ids is not None \
            else list(range(torch.cuda.device_count()))
        _local_devices = [torch.device("cuda", i) for i in ids]
        torch.cuda.set_device(_local_devices[0])
    else:
        _local_devices = None
    _device_type = kind
    dist.init_process_group("nccl" if kind == "cuda" else "gloo",
                            init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes), rank=int(process_id),
                            timeout=datetime.timedelta(seconds=timeout))
    logger.info("multihost: process %d/%d joined (%s)", dist.get_rank(),
                dist.get_world_size(), dist.get_backend())
    return dist.get_rank()


def shutdown() -> None:
    """Leave the process group (test/teardown hook)."""
    global _local_devices
    if not is_initialized():
        return
    import torch.distributed as dist
    dist.destroy_process_group()
    _local_devices = None


def _order_devices(devices, n_targets: int):
    """Order a global device list so each (time) row of an
    ``(n_time, n_targets)`` mesh is a block of one process's devices.

    Devices are grouped by ``process_index`` (stable within a process by
    ``id``); raises when ``n_targets`` does not divide every process's
    device count, as a row across two processes would put the targets
    axis's traffic between hosts.
    """
    by_proc: dict = {}
    for d in devices:
        by_proc.setdefault(getattr(d, "process_index", 0), []).append(d)
    ordered = []
    for proc in sorted(by_proc):
        block = sorted(by_proc[proc], key=lambda d: getattr(d, "id", 0))
        if len(block) % n_targets != 0:
            raise ValueError(
                f"n_targets={n_targets} does not divide process {proc}'s "
                f"{len(block)} local devices; a mesh row would cross hosts "
                f"and put target traffic between them")
        ordered.extend(block)
    return ordered


def _global_devices(local) -> list:
    """Every process's devices as :class:`ProcessDevice`s: this process's
    ``local`` list, and the others' gathered from the group."""
    rank, size = _rank_and_size()
    names = [str(d) for d in local]
    if size > 1:
        import torch.distributed as dist
        gathered = [None] * size
        dist.all_gather_object(gathered, names)
    else:
        gathered = [names]
    return [ProcessDevice(p, i, torch.device(n)) for p, ns in enumerate(gathered)
            for i, n in enumerate(ns)]


def global_mesh(n_time: Optional[int] = None, n_targets: Optional[int] = None,
                devices=None) -> Mesh:
    """A 2-D ``(time, targets)`` mesh over **every** process's devices,
    laid out so the targets axis never crosses a process.

    ``devices``: this process's devices (torch devices or strings, repeats
    allowed: ``["cuda:0"] * 4`` is four entries of one card), gathered from
    every process of the group; or a global list of entries that already
    carry ``process_index`` (and ``id``), used as given.  Default: the
    devices :func:`initialize` was told, else every visible card.
    Defaults of the split as ``mesh.make_mesh``.
    """
    if devices is not None and all(hasattr(d, "process_index") for d in devices):
        entries = list(devices)
    else:
        if devices is None:
            devices = (_local_devices if _local_devices is not None
                       else visible_devices(_device_type if is_initialized() else "cuda"))
        entries = _global_devices([torch.device(d) for d in devices])
    n = len(entries)
    if n_time is None and n_targets is None:
        n_time, n_targets = n, 1
    elif n_time is None:
        n_time = n // n_targets
    elif n_targets is None:
        n_targets = n // n_time
    if n_time < 1 or n_targets < 1 or n_time * n_targets != n:
        raise ValueError(f"mesh {n_time}x{n_targets} != {n} devices")
    ordered = np.empty(n, dtype=object)
    ordered[:] = _order_devices(entries, n_targets)
    return Mesh(ordered.reshape(n_time, n_targets))


def process_shard(items: Sequence, process_id: Optional[int] = None,
                  process_count: Optional[int] = None) -> list:
    """This process's strided slice ``items[pid::count]`` of a host-level
    work list (the cubes of a sector, movie jobs).  ``pid`` and ``count``
    default to the process group's rank and world size (0 and 1 outside
    one).  Raises on an inconsistent pair: 1-based ids or a count of 0
    would hand two processes overlapping shards."""
    rank, size = _rank_and_size()
    pid = rank if process_id is None else process_id
    count = size if process_count is None else process_count
    if count < 1:
        raise ValueError(f"process_count must be >= 1, got {count}")
    if not 0 <= pid < count:
        raise ValueError(f"process_id {pid} outside [0, {count}) — ids are 0-based; an "
                         f"out-of-range id would silently overlap another process's shard")
    return list(items)[pid::count]


def local_data_slice(n_rows: int, mesh=None, axis: str = TIME_AXIS,
                     process_id: Optional[int] = None) -> slice:
    """The contiguous row range of an ``axis``-sharded array that this
    process must produce: with :func:`global_mesh`'s process-blocked order
    each process's time rows are contiguous, so a process reads only its
    own frames from disk and bulk pixels never cross hosts."""
    if mesh is None:
        mesh = global_mesh()
    n_axis = mesh.shape[axis]
    if n_rows % n_axis != 0:
        raise ValueError(f"{n_rows} rows not divisible by {axis}={n_axis}")
    per = n_rows // n_axis
    axis_idx = list(mesh.axis_names).index(axis)
    pid = _rank_and_size()[0] if process_id is None else process_id
    rows = np.moveaxis(np.asarray(mesh.devices, dtype=object), axis_idx, 0)
    coords = [i for i in range(n_axis)
              if any(getattr(d, "process_index", 0) == pid for d in rows[i].flat)]
    if not coords:
        raise ValueError(f"process {pid} owns no devices on axis {axis!r}")
    lo, hi = min(coords), max(coords)
    if coords != list(range(lo, hi + 1)):
        raise ValueError("process-local rows are not contiguous — was the "
                         "mesh built by global_mesh()?")
    # Exclusive ownership: a row mixing processes would hand two of them
    # overlapping "local" slices while each passes the contiguity check.
    for i in coords:
        owners = {getattr(d, "process_index", 0) for d in rows[i].flat}
        if owners != {pid}:
            raise ValueError(
                f"axis {axis!r} row {i} is shared by processes "
                f"{sorted(owners)} — rows must be exclusively owned; was "
                f"the mesh built by global_mesh()?")
    return slice(lo * per, (hi + 1) * per)
