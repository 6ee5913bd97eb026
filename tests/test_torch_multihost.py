"""The port's multi-process layer (``parallel/multihost.py``) on the CPU,
case for case with tests/test_multihost.py, over ``torch.distributed``.

- The layout logic (the time axis may cross processes, target rows may
  not) with fake device objects carrying ``process_index``/``id``, as the
  JAX tests hold it.
- ``initialize`` is a no-op without a coordinator or a cluster
  environment; the full handshake (``initialize`` -> ``global_mesh`` ->
  ``local_data_slice`` -> a sharded sum -> ``shutdown``) in a one-process
  gloo group, in a subprocess that refuses ``jax`` and ``photometry_tpu``.
- Two gloo processes, each holding two of four CPU shards of one cube:
  ``sharded_time_smooth`` (its halo frames by send/recv) and
  ``sharded_sumimage`` (its partials by ``all_gather``) give the bits of
  the one-process run.
- ``prepare.prepare_photometry`` in a two-process gloo group: each process
  prepares ``process_shard(combos)`` of three CCDs, the two shards
  disjoint and together all three.

Every subprocess and process group has a timeout.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one intra-op thread per test worker)

from photometry_tpu_torch.parallel import multihost
from photometry_tpu_torch.parallel.mesh import TARGET_AXIS, TIME_AXIS, make_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class FakeDev:
    def __init__(self, proc, did):
        self.process_index = proc
        self.id = did

    def __repr__(self):  # pragma: no cover
        return f"d{self.process_index}.{self.id}"


def _fleet(n_proc, per_host):
    # Interleaved + shuffled arrival order: nothing promises a host-blocked one.
    devs = [FakeDev(p, p * 100 + i) for p in range(n_proc) for i in range(per_host)]
    rng = np.random.default_rng(7)
    rng.shuffle(devs)
    return devs


class FakeMesh:
    """Just enough Mesh surface for local_data_slice."""

    def __init__(self, devices, axis_names):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, self.devices.shape))


def test_order_devices_host_blocked_rows():
    ordered = multihost._order_devices(_fleet(n_proc=4, per_host=4), n_targets=4)
    rows = [ordered[i:i + 4] for i in range(0, 16, 4)]
    for row in rows:
        assert len({d.process_index for d in row}) == 1, f"mesh row crosses hosts: {row}"
    assert [r[0].process_index for r in rows] == [0, 1, 2, 3]
    assert [d.id for d in rows[2]] == [200, 201, 202, 203]


def test_order_devices_rejects_row_straddle():
    devs = _fleet(n_proc=2, per_host=4)
    with pytest.raises(ValueError, match="cross hosts"):
        multihost._order_devices(devs, n_targets=8)
    with pytest.raises(ValueError, match="cross hosts"):
        multihost._order_devices(devs, n_targets=3)


def test_global_mesh_single_host_matches_make_mesh():
    """Outside a process group the global mesh is this process's devices:
    the entries carry process 0 and name make_mesh's devices in its order;
    fake global entries are laid out as given."""
    mesh = multihost.global_mesh(n_targets=2, devices=["cpu"] * 8)
    local = make_mesh(n_targets=2, devices=["cpu"] * 8)
    assert mesh.shape == {TIME_AXIS: 4, TARGET_AXIS: 2} == local.shape
    assert [mesh.device(i, j) for _, i, j in mesh.flat()] == \
        [local.device(i, j) for _, i, j in local.flat()]
    assert {d.process_index for d in mesh.devices.flat} == {0}
    assert [d.id for d in mesh.devices.flat] == list(range(8))
    assert all(mesh.is_local(i, j) for _, i, j in mesh.flat()) and not mesh.spans_processes
    fake = multihost.global_mesh(n_targets=2, devices=_fleet(2, 2))
    assert [[d.process_index for d in row] for row in fake.devices] == [[0, 0], [1, 1]]
    assert fake.spans_processes


def test_local_data_slice_per_process_rows():
    # 4 hosts x 4 devices, mesh (time=8, targets=2): each owns 2 contiguous
    # time rows, a quarter of the frames.
    ordered = multihost._order_devices(_fleet(4, 4), n_targets=2)
    mesh = FakeMesh(np.asarray(ordered, dtype=object).reshape(8, 2), (TIME_AXIS, TARGET_AXIS))
    T = 1312
    slices = [multihost.local_data_slice(T, mesh, process_id=p) for p in range(4)]
    assert slices == [slice(0, 328), slice(328, 656), slice(656, 984), slice(984, 1312)]
    with pytest.raises(ValueError, match="not divisible"):
        multihost.local_data_slice(13, mesh, process_id=0)
    with pytest.raises(ValueError, match="owns no devices"):
        multihost.local_data_slice(T, mesh, process_id=9)


def test_local_data_slice_rejects_non_contiguous():
    ordered = multihost._order_devices(_fleet(2, 2), n_targets=1)
    bad = [ordered[0], ordered[2], ordered[1], ordered[3]]       # 0,1,0,1 along time
    mesh = FakeMesh(np.asarray(bad, dtype=object).reshape(4, 1), (TIME_AXIS, TARGET_AXIS))
    with pytest.raises(ValueError, match="not contiguous"):
        multihost.local_data_slice(8, mesh, process_id=0)


def test_process_shard_round_robin():
    items = list(range(10))
    shards = [multihost.process_shard(items, process_id=p, process_count=3) for p in range(3)]
    assert shards == [[0, 3, 6, 9], [1, 4, 7], [2, 5, 8]]
    assert sorted(sum(shards, [])) == items


def test_process_shard_rejects_bad_ids():
    with pytest.raises(ValueError, match="0-based"):
        multihost.process_shard([1, 2, 3], process_id=3, process_count=3)
    with pytest.raises(ValueError, match="0-based"):
        multihost.process_shard([1, 2, 3], process_id=-1, process_count=3)
    with pytest.raises(ValueError, match="process_count"):
        multihost.process_shard([1, 2, 3], process_id=0, process_count=0)


def test_local_data_slice_rejects_shared_rows():
    ordered = multihost._order_devices(_fleet(2, 2), n_targets=1)
    mixed = np.asarray([[ordered[0], ordered[2]], [ordered[1], ordered[3]]], dtype=object)
    mesh = FakeMesh(mixed, (TIME_AXIS, TARGET_AXIS))
    with pytest.raises(ValueError, match="exclusively owned"):
        multihost.local_data_slice(8, mesh, process_id=0)


def test_initialize_noop_without_cluster(monkeypatch):
    for v in ("SLURM_JOB_ID", "OMPI_COMM_WORLD_SIZE", "MASTER_ADDR", "WORLD_SIZE", "RANK",
              "PHOTOMETRY_TPU_COORDINATOR_ADDRESS", "PHOTOMETRY_TPU_MULTIHOST"):
        monkeypatch.delenv(v, raising=False)
    assert multihost.initialize() == 0
    assert not multihost.is_initialized()
    with pytest.raises(ValueError, match="num_processes"):
        multihost.initialize("127.0.0.1:1")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


#: A meta-path finder refusing the JAX stack and the JAX package.
_BLOCK = textwrap.dedent("""
    import importlib.abc, sys

    class _Blocked(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "photometry_tpu"):
                raise ImportError(f"{name} is blocked")
            return None

    sys.meta_path.insert(0, _Blocked())
""")

_SMOKE = _BLOCK + textwrap.dedent("""
    import numpy as np, torch
    from photometry_tpu_torch.parallel import multihost
    from photometry_tpu_torch.parallel.mesh import shard_cube
    from photometry_tpu_torch.parallel.sharded import sharded_sumimage

    pid = multihost.initialize("127.0.0.1:%d", num_processes=1, process_id=0, device="cpu",
                               timeout=60)
    assert pid == 0 and multihost.is_initialized()
    mesh = multihost.global_mesh(n_targets=2, devices=["cpu"] * 4)
    assert mesh.shape == {"time": 2, "targets": 2}, mesh.shape
    sl = multihost.local_data_slice(8, mesh)
    assert sl == slice(0, 8), sl
    x = shard_cube(torch.arange(8.0).reshape(8, 1, 1), mesh)
    s = float(sharded_sumimage(x, np.ones(8, bool), mesh)[0, 0] * 8)
    assert s == 28.0, s
    multihost.shutdown()
    assert not multihost.is_initialized()
    assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "photometry_tpu")]
    print("MULTIHOST_OK")
""")


def _env():
    return dict(os.environ, OMP_NUM_THREADS="1",
                PYTHONPATH=os.pathsep.join([ROOT, os.environ.get("PYTHONPATH", "")]))


def test_distributed_smoke_subprocess():
    """initialize -> global_mesh -> local_data_slice -> a sharded sum
    (through the group's all_gather) -> shutdown, one gloo process, JAX
    refused."""
    proc = subprocess.run([sys.executable, "-c", _SMOKE % _free_port()], capture_output=True,
                          text=True, timeout=240, env=_env(), cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "MULTIHOST_OK" in proc.stdout


_TWO = _BLOCK + textwrap.dedent("""
    import json, numpy as np, torch
    torch.set_num_threads(1)
    from photometry_tpu_torch.parallel import multihost
    from photometry_tpu_torch.parallel.mesh import shard_cube
    from photometry_tpu_torch.parallel.sharded import sharded_sumimage, sharded_time_smooth

    rank, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    multihost.initialize(f"127.0.0.1:{port}", num_processes=2, process_id=rank, device="cpu",
                         timeout=60)
    mesh = multihost.global_mesh(devices=["cpu"] * 2)          # 4 time rows, 2 a process
    assert mesh.shape == {"time": 4, "targets": 1} and mesh.spans_processes
    rng = np.random.default_rng(11)
    x = rng.normal(100, 3, (10, 12, 12)).astype(np.float32)
    x[4, 3, 3] = np.nan
    x[5:7, 0, 0] = np.nan
    good = np.ones(10, bool)
    good[2] = False
    cube = shard_cube(x, mesh)
    assert cube.rows() == [2 * rank, 2 * rank + 1]
    sm = sharded_time_smooth(cube, mesh)
    s = sharded_sumimage(cube, good, mesh)
    np.savez(out, rows=np.array(sm.rows()), smooth=np.stack([sm.shards[i].numpy()
                                                             for i in sm.rows()]),
             sumimage=s.numpy())
    multihost.shutdown()
""")


def test_two_process_gloo_bit_equal_to_one_process(tmp_path):
    """Two gloo processes over four CPU shards (T = 10 padded to 12):
    time smoothing (halo frames by send/recv) and the sum image (partials
    by all_gather, added in mesh order) give the one-process bits."""
    from photometry_tpu_torch.parallel.mesh import shard_cube
    from photometry_tpu_torch.parallel.sharded import sharded_sumimage, sharded_time_smooth
    port = _free_port()
    outs = [str(tmp_path / f"rank{r}.npz") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, "-c", _TWO, str(r), str(port), outs[r]],
                              env=_env(), cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(2)]
    try:
        errs = [p.communicate(timeout=180)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], [e[-2000:] for e in errs]

    mesh = make_mesh(4, 1, ["cpu"] * 4)
    rng = np.random.default_rng(11)
    x = rng.normal(100, 3, (10, 12, 12)).astype(np.float32)
    x[4, 3, 3] = np.nan
    x[5:7, 0, 0] = np.nan
    good = np.ones(10, bool)
    good[2] = False
    cube = shard_cube(x, mesh)
    smooth = sharded_time_smooth(cube, mesh)
    s = sharded_sumimage(cube, good, mesh).numpy()
    for r in range(2):
        got = np.load(outs[r])
        assert list(got["rows"]) == [2 * r, 2 * r + 1]
        want = np.stack([smooth.shards[i].numpy() for i in got["rows"]])
        assert np.array_equal(got["smooth"].view(np.uint32), want.view(np.uint32))
        assert np.array_equal(got["sumimage"].view(np.uint32), s.view(np.uint32))
    np.testing.assert_allclose(s, np.nanmean(np.where(good[:, None, None], x, np.nan), axis=0),
                               rtol=1e-5)


_PREPARE = _BLOCK + textwrap.dedent("""
    import json, os
    from photometry_tpu_torch.parallel import multihost
    from photometry_tpu_torch.prepare import prepare_photometry

    rank, port, folder = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    multihost.initialize(f"127.0.0.1:{port}", num_processes=2, process_id=rank, device="cpu",
                         timeout=120)
    paths = prepare_photometry(folder, device="cpu")
    print("PATHS", json.dumps([os.path.basename(p) for p in paths]))
    multihost.shutdown()
""")


def test_prepare_photometry_splits_ccds_in_a_process_group(tmp_path):
    """Two gloo processes run prepare_photometry on one folder of three
    CCDs: each prepares its process_shard of the sorted (sector, camera,
    ccd) list, disjoint, all three in all."""
    from photometry_tpu.sim.simulator import SimConfig, simulate_sector
    d = str(tmp_path / "ffi")
    for ccd in (1, 2, 3):
        sim = simulate_sector(SimConfig(shape=(48, 48), n_times=4, n_stars=6, ccd=ccd,
                                        seed=20 + ccd, tmag_range=(8.0, 12.0)))
        sim.write_ffis(d)
        sim.write_catalog(d)
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-c", _PREPARE, str(r),
                               str(port), d], env=_env(), cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], [e[-2000:] for _, e in outs]
    got = [json.loads(next(line[6:] for line in o.splitlines() if line.startswith("PATHS ")))
           for o, _ in outs]
    assert [len(g) for g in got] == [2, 1]
    assert not set(got[0]) & set(got[1])
    assert all(os.path.exists(os.path.join(d, p)) for g in got for p in g)
    names = sorted(got[0] + got[1])
    assert len(names) == 3
    # process 0 took combos[0::2] = CCDs 1 and 3, process 1 combos[1::2] = CCD 2:
    assert sorted(got[0]) == [names[0], names[2]] and got[1] == [names[1]]
