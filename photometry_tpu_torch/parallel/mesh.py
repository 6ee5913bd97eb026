"""
Device meshes and time-sharded cubes for multi-card photometry.

Port of ``photometry_tpu/parallel/mesh.py``.  A :class:`Mesh` is a 2-D
(time, targets) grid of torch devices: the *time* axis shards a sector's
cubes (each mesh row holds a contiguous block of frames), the *targets*
axis shards an extraction batch.  torch has no shardings, so in place of
the JAX module's ``cube_sharding``, ``targets_sharding`` and
``replicated`` there is :class:`ShardedCube` (a cube's time shards, one
tensor a mesh row, each on its row's device) and :func:`shard_cube`, which
makes one from a host or device ``(T, H, W)`` array.

A device may repeat in a mesh: ``make_mesh(4, 2, ["cpu"] * 8)`` and
``make_mesh(4, 1, ["cuda:0"] * 4)`` are meshes of one device, the
counterparts of the JAX suite's virtual host devices
(``--xla_force_host_platform_device_count=8``).  Their programs run shard
by shard on that device, with the same arithmetic as on distinct cards.
"""

from __future__ import annotations

import re
from typing import Callable, Optional

import numpy as np
import torch

__all__ = ["TIME_AXIS", "TARGET_AXIS", "CPU_DEVICES", "Mesh", "ShardedCube", "make_mesh",
           "parse_mesh_spec", "mesh_axes", "visible_devices", "shard_cube", "map_time"]

TIME_AXIS = "time"
TARGET_AXIS = "targets"

#: The CPU's device entries for ``parse_mesh_spec(..., device="cpu")``: as
#: many as the JAX suite's virtual host devices.
CPU_DEVICES = 8


def _torch_device(entry) -> torch.device:
    """The torch device of a mesh entry: a ``torch.device``, a device string,
    or an object carrying one as ``.device`` (``multihost.ProcessDevice``)."""
    if isinstance(entry, torch.device):
        return entry
    if isinstance(entry, str):
        return torch.device(entry)
    return torch.device(entry.device)


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


class Mesh:
    """A 2-D (time, targets) grid of device entries.

    ``devices`` is an object array of shape (n_time, n_targets); its entries
    are ``torch.device``s, or (for :func:`multihost.global_mesh`) objects
    carrying ``process_index``, ``id`` and ``device``.  An entry without a
    ``process_index`` belongs to this process.
    """

    axis_names = (TIME_AXIS, TARGET_AXIS)

    def __init__(self, devices):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != 2:
            raise ValueError(f"a mesh needs a 2-D device grid, got shape {devices.shape}")
        self.devices = devices

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device(self, i: int, j: int = 0) -> torch.device:
        """The torch device of entry (i, j)."""
        return _torch_device(self.devices[i, j])

    def is_local(self, i: int, j: int = 0) -> bool:
        """True when entry (i, j) belongs to this process."""
        pid = getattr(self.devices[i, j], "process_index", None)
        return pid is None or pid == _rank()

    def row_is_local(self, i: int) -> bool:
        """True when every entry of time row ``i`` belongs to this process."""
        return all(self.is_local(i, j) for j in range(self.devices.shape[1]))

    @property
    def spans_processes(self) -> bool:
        return not all(self.is_local(i, j) for i in range(self.devices.shape[0])
                       for j in range(self.devices.shape[1]))

    def flat(self) -> list:
        """(flat index, time row, target column) of every entry, row-major:
        the order of the flattened (time x targets) axis."""
        n_t, n_g = self.devices.shape
        return [(i * n_g + j, i, j) for i in range(n_t) for j in range(n_g)]

    def __repr__(self):
        return f"Mesh({self.shape}, {[str(self.device(i, j)) for _, i, j in self.flat()]})"


def visible_devices(device="cuda") -> list:
    """Every device of ``device``'s type: the visible CUDA cards, one each
    (raises without a card; never the CPU in their place), or
    :data:`CPU_DEVICES` entries of the CPU."""
    kind = torch.device(device).type
    if kind == "cpu":
        return [torch.device("cpu")] * CPU_DEVICES
    if kind != "cuda":
        raise ValueError(f"no mesh devices of type {kind!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("a mesh of CUDA devices was asked for, but CUDA is not available")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_time: Optional[int] = None, n_targets: Optional[int] = None,
              devices=None) -> Mesh:
    """A 2-D (time, targets) device mesh.

    ``devices`` (torch devices or device strings; repeats allowed) defaults
    to every visible CUDA device, one each, and raises without a card.
    Without a split every device goes on the time axis (the memory-bound
    axis), as in the JAX package.
    """
    devices = list(devices) if devices is not None else visible_devices("cuda")
    devices = [d if hasattr(d, "process_index") else _torch_device(d) for d in devices]
    n = len(devices)
    if n_time is None and n_targets is None:
        n_time, n_targets = n, 1
    elif n_time is None:
        n_time = n // n_targets
    elif n_targets is None:
        n_targets = n // n_time
    if n_time < 1 or n_targets < 1 or n_time * n_targets != n:
        raise ValueError(f"mesh {n_time}x{n_targets} != {n} devices")
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(n_time, n_targets))


def mesh_axes(spec: str):
    """The (n_time, n_targets) a CLI mesh spec asks for, None for ``auto``;
    ValueError for a malformed spec.  Touches no device (the scheduler's
    master checks a spec with it before it starts a worker)."""
    spec = (spec or "").strip().lower()
    if not spec:
        raise ValueError("empty mesh spec")
    if spec == "auto":
        return None
    kw = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        key, eq, val = part.partition("=")
        key = key.strip() if eq else TIME_AXIS
        val = val if eq else part
        if key not in (TIME_AXIS, TARGET_AXIS):
            raise ValueError(f"unknown mesh axis {key!r} "
                             f"(expected {TIME_AXIS!r} or {TARGET_AXIS!r})")
        if not re.fullmatch(r"\s*\d+\s*", val) or int(val) < 1:
            raise ValueError(f"mesh axis {key!r}: need a positive integer, got {val!r}")
        kw[key] = int(val)
    return kw.get(TIME_AXIS, 1), kw.get(TARGET_AXIS, 1)


def parse_mesh_spec(spec: str, device="cuda") -> Mesh:
    """Build a mesh from a CLI spec like ``time=4,targets=2``.

    Accepted forms: ``time=N``, ``targets=M``, ``time=N,targets=M``, or a
    bare device count ``N`` (all on the time axis); ``auto`` uses every
    device of ``device``'s type on the time axis.  An explicit spec takes
    exactly ``N*M`` of those devices (an omitted axis is 1) and raises
    ValueError when there are fewer (:func:`visible_devices`: the cards,
    or :data:`CPU_DEVICES` CPU entries).  The counterpart of launching the
    reference under ``mpiexec`` (run_tessphot_mpi.py).
    """
    axes = mesh_axes(spec)
    devices = visible_devices(device)
    if axes is None:
        return make_mesh(devices=devices)
    n_time, n_targets = axes
    if n_time * n_targets > len(devices):
        raise ValueError(f"mesh spec {spec!r} needs {n_time * n_targets} devices; only "
                         f"{len(devices)} available")
    return make_mesh(n_time, n_targets, devices[:n_time * n_targets])


class ShardedCube:
    """A ``(T, H, W)`` cube as its time shards: ``shards[i]`` holds frames
    ``[i*F, (i+1)*F)`` of the padded cube on mesh row ``i``'s device, or is
    None where another process holds row ``i``.

    ``shape`` is the padded shape (T a multiple of the time-axis size),
    ``n_times`` the true T; ``dtype`` and ``device`` are those of the first
    shard this process holds.  :meth:`block` hands row ``i``'s frames to
    any entry of that row, copied there only when the entry is another
    device.
    """

    def __init__(self, shards, mesh: Mesh, n_times: Optional[int] = None):
        self.shards = list(shards)
        self.mesh = mesh
        if len(self.shards) != mesh.shape[TIME_AXIS]:
            raise ValueError(f"{len(self.shards)} shards for a time axis of "
                             f"{mesh.shape[TIME_AXIS]}")
        held = [s for s in self.shards if s is not None]
        if not held:
            raise ValueError("this process holds no shard of the cube")
        first = held[0]
        if any(s.shape != first.shape or s.dtype != first.dtype for s in held):
            raise ValueError("the shards differ in shape or dtype")
        self.frames = int(first.shape[0])
        self.shape = (self.frames * len(self.shards),) + tuple(first.shape[1:])
        self.n_times = self.shape[0] if n_times is None else int(n_times)
        self.dtype = first.dtype
        self.device = first.device
        self._copies = {}

    def rows(self) -> list:
        """The time rows this process holds, in mesh order."""
        return [i for i, s in enumerate(self.shards) if s is not None]

    def block(self, i: int, j: int = 0) -> torch.Tensor:
        """Row ``i``'s frames on mesh entry (i, j)'s device (the shard
        itself where it lies there)."""
        dev = self.mesh.device(i, j)
        shard = self.shards[i]
        if shard is None:
            raise ValueError(f"time row {i} is held by another process")
        if shard.device == dev:
            return shard
        key = (i, str(dev))
        if key not in self._copies:
            self._copies[key] = shard.to(dev)
        return self._copies[key]

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "ShardedCube":
        """A cube of ``fn`` of each shard held (a per-frame program)."""
        return ShardedCube([None if s is None else fn(s) for s in self.shards], self.mesh,
                           self.n_times)

    def full(self, device=None) -> torch.Tensor:
        """The true ``(n_times, H, W)`` cube on ``device`` (the first shard's
        if None); every shard must be this process's."""
        return map_time(self, lambda s: s, 0, device)


def map_time(cube, fn: Callable[[torch.Tensor], torch.Tensor], dim: int = 0,
             device=None) -> torch.Tensor:
    """``fn`` of a cube whose result has the cube's time axis at ``dim``.

    For a plain tensor, ``fn(cube)`` moved to ``device``.  For a
    :class:`ShardedCube`, ``fn`` runs on each shard where it lies, the
    parts move to ``device`` (the cube's if None) and are concatenated in
    time order, cut back to the true ``n_times``: what ``fn`` would give on
    the whole cube, as long as ``fn`` treats frames independently.
    """
    if not isinstance(cube, ShardedCube):
        out = fn(cube)
        return out if device is None else out.to(device)
    if cube.mesh.spans_processes and None in cube.shards:
        raise ValueError("the cube's time rows are spread over processes")
    dev = cube.device if device is None else torch.device(device)
    out = torch.cat([fn(s).to(dev) for s in cube.shards], dim=dim)
    if out.shape[dim] != cube.n_times:
        out = out.narrow(dim, 0, cube.n_times).contiguous()
    return out


def _to_device(piece, dev: torch.device) -> torch.Tensor:
    """numpy or tensor -> contiguous tensor on ``dev``, shared where it can be."""
    t = piece if isinstance(piece, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(piece))
    return t.to(dev).contiguous()


def shard_cube(x, mesh: Mesh, fill=float("nan"), put=None) -> ShardedCube:
    """Time-shard a host or device ``(T, H, W)`` array over ``mesh``.

    T is padded to a multiple of the time-axis size with ``fill`` frames
    (NaN for values, 0 for pixel flags), as the JAX package pads a mesh
    context's cubes; the result keeps the true T as ``n_times``.  Each row
    this process holds gets ``put(piece, device)`` of its frames (default:
    moved as they are); where the source already lies on the row's device
    in the right dtype, that shard is a view of it, so a mesh on one card
    holds the cube once.  Only a padded last shard is a copy.
    """
    if isinstance(x, ShardedCube):
        return x
    put = put or _to_device
    T = int(x.shape[0])
    n_time = mesh.shape[TIME_AXIS]
    frames = max(-(-T // n_time), 1)
    shards = []
    for i in range(n_time):
        if not mesh.row_is_local(i):
            shards.append(None)
            continue
        dev = mesh.device(i)
        lo, hi = min(i * frames, T), min((i + 1) * frames, T)
        part = put(x[lo:hi], dev)
        if hi - lo < frames:
            pad = torch.full((frames - (hi - lo),) + tuple(part.shape[1:]), fill,
                             dtype=part.dtype, device=dev)
            part = torch.cat([part, pad])
        shards.append(part)
    return ShardedCube(shards, mesh, n_times=T)
