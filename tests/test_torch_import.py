"""The port stands without JAX and the JAX package, and its CUDA kernels
agree with their plain versions.

- In a subprocess whose ``sys.meta_path`` refuses ``jax``, ``jaxlib``,
  ``h5py`` and ``photometry_tpu`` (the first dotted component, so
  ``photometry_tpu_torch`` passes), every module of the port imports,
  ``extract_aperture_batch`` and ``extract_psf_batch`` run on a tiny
  ``SectorContext.from_arrays`` context on the CPU, and so do
  ``extract_linpsf_batch`` and ``extract_halo_batch``; ``extract_aperture_batch``
  also runs on a bfloat16 copy of that context, on a host copy
  (``cache="host"``, streamed 4 frames a chunk) and on a ``TpfContext``
  (a simulated TPF) and on a mesh copy of the tiny context
  (``make_mesh(4, 1, ["cpu"] * 4)``, T = 6 padded to 8: the same statuses
  and fluxes); the prepare stage
  (``prepare.prepare_cube``) runs on a tiny simulated sector into
  ``chip_smoke.DictCube``, the in-memory store the card's run uses; and the
  chain catalog -> todo -> merge runs through the port's CLIs on a folder
  of one TPF (a catalog built from a TIC extract, the todo list, a merge
  with a corrections file), which needs no cube and so no ``h5py``; on
  copies of that folder's todo a drain runs without plots, and the
  scheduler with one spawned CPU worker (the blocker is the subprocess's
  ``sitecustomize``, so the worker has it too).  ``matplotlib`` is refused
  as well until then: ``import photometry_tpu_torch``, every module but
  ``plots`` and ``movie`` (``diagnostics`` and ``cli.movie_cmd`` too), the
  drain and the scheduler leave it out of ``sys.modules``; the two import
  last, with it allowed.
- ``photometry_cmd --mesh time=2 --device cpu`` drains a prepared sector
  in a subprocess that refuses ``jax``, ``jaxlib`` and ``photometry_tpu``;
  every entry point that takes a mesh in the JAX package takes one in the
  port, and none of the mesh layer raises ``NotImplementedError``.
- No module of ``photometry_tpu_torch``, and not ``chip_smoke.py``, has an
  import statement naming ``jax``, ``jaxlib`` or ``photometry_tpu``.
- Every public name of ``photometry_tpu`` (each top-level function and
  class of a file, and each method of a class) has one of the same name in
  the port's file of the same path, or stands in ``NO_COUNTERPART`` with its
  counterpart of another name or the reason the port has none.
- The ``*_on_card`` tests need a CUDA card (marker ``cuda``) and skip
  without one.  Run them on the card with
  ``python -m pytest --noconftest -m cuda tests/test_torch_import.py``
  (the repository's conftest.py imports JAX).  Among them the band kernel
  on a mesh's shards (views that start mid-cube and a padded last shard)
  and ``sharded_psf_fit`` against the single-device kernel fit.
"""

import ast
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one intra-op thread per test worker)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "photometry_tpu_torch")

#: ``sitecustomize`` of the subprocess and of the workers it spawns: the
#: blocker, which also refuses ``matplotlib`` until the script lifts that.
_SITE = r'''
import importlib.abc, sys

class _Blocked(importlib.abc.MetaPathFinder):
    blocked = {"jax", "jaxlib", "h5py", "photometry_tpu", "matplotlib"}

    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in self.blocked:
            raise ImportError(f"{name} is blocked")
        return None

sys.meta_path.insert(0, _Blocked())
'''

_SCRIPT = r'''
import os, shutil, sqlite3, sys, tempfile

BLOCKED = ("jax", "jaxlib", "h5py", "photometry_tpu")
BLOCKER = sys.meta_path[0]
assert type(BLOCKER).__name__ == "_Blocked"
import numpy as np
import torch

import photometry_tpu_torch
assert "matplotlib" not in sys.modules
for m in MODULES:
    if m not in FIGURE_MODULES:
        __import__(m)

from photometry_tpu_torch.catalog import make_catalog_from_arrays
from photometry_tpu_torch.core.engine import SectorContext, extract_aperture_batch
from photometry_tpu_torch.core.status import STATUS
from photometry_tpu_torch.io.wcs import TanWCS
from photometry_tpu_torch.models.psf_fit import extract_psf_batch

rng = np.random.default_rng(0)
H = W = 64
T = 6
wcs = TanWCS(crpix=[32.5, 32.5], crval=[80.0, -30.0], cd=[[-21 / 3600, 0], [0, 21 / 3600]])
rows, cols = rng.uniform(12, 52, 4), rng.uniform(12, 52, 4)
tmag = np.array([9.0, 10.0, 11.0, 12.0])
yy, xx = np.mgrid[0:H, 0:W]
img = rng.normal(0, 2.0, (H, W))
for r, c, m in zip(rows, cols, tmag):
    img += 10 ** (-0.4 * (m - 20.451)) * np.exp(-0.5 * ((yy - r) ** 2 + (xx - c) ** 2) / 1.2 ** 2) / (2 * np.pi * 1.44)
images = np.repeat(img[None], T, 0).astype(np.float32) + rng.normal(0, 1, (T, H, W)).astype(np.float32)
ra, dec = wcs.radec_of_rowcol(rows, cols)
d = tempfile.mkdtemp()
path = make_catalog_from_arrays(d, 1, 1, 1, starid=np.arange(1, 5), ra_j2000=ra, dec_j2000=dec,
                                pm_ra=np.zeros(4), pm_dec=np.zeros(4), tmag=tmag,
                                reference_time=2458340.0)
ctx = SectorContext.from_arrays(
    images=images, images_err=np.ones_like(images), backgrounds=np.zeros_like(images),
    pixelflags=np.zeros(images.shape, np.uint8), sumimage=images.mean(0),
    time=1325.0 + np.arange(T) / 48, timecorr=np.zeros(T, np.float32),
    cadenceno=np.arange(T), quality=np.zeros(T, np.int32), catalog_path=path, wcs=wcs,
    sector=1, camera=1, ccd=1, device="cpu")
res = extract_aperture_batch(ctx, [1, 2, 3, 4])
assert all(r.status in (STATUS.OK, STATUS.WARNING) for r in res), [r.status for r in res]
assert all(np.isfinite(r.lightcurve["flux"]).all() for r in res)
psf = extract_psf_batch(ctx, [1, 2, 3, 4])
assert all(r.status in (STATUS.OK, STATUS.WARNING) for r in psf), [r.status for r in psf]
assert all(np.isfinite(r.lightcurve["flux"]).all() for r in psf)
from photometry_tpu_torch.models.halo import extract_halo_batch
from photometry_tpu_torch.models.linpsf import extract_linpsf_batch
for got in (extract_linpsf_batch(ctx, [1, 2, 3, 4]), extract_halo_batch(ctx, [1, 2])):
    assert all(r.status in (STATUS.OK, STATUS.WARNING) for r in got), [r.status for r in got]
    assert all(np.isfinite(r.lightcurve["flux"]).all() for r in got)

ctx16 = SectorContext.from_arrays(
    images=images, images_err=np.ones_like(images), backgrounds=np.zeros_like(images),
    pixelflags=np.zeros(images.shape, np.uint8), sumimage=images.mean(0),
    time=1325.0 + np.arange(T) / 48, timecorr=np.zeros(T, np.float32),
    cadenceno=np.arange(T), quality=np.zeros(T, np.int32), catalog_path=path, wcs=wcs,
    sector=1, camera=1, ccd=1, cube_dtype=torch.bfloat16, device="cpu")
assert ctx16.images.dtype == torch.bfloat16
res16 = extract_aperture_batch(ctx16, [1, 2, 3, 4])
assert [r.status for r in res16] == [r.status for r in res]
import functools
from photometry_tpu_torch.core import engine
engine._extract_flux_streamed = functools.partial(engine._extract_flux_streamed, chunk=4)
ctxh = SectorContext.from_arrays(
    images=images, images_err=np.ones_like(images), backgrounds=np.zeros_like(images),
    pixelflags=np.zeros(images.shape, np.uint8), sumimage=images.mean(0),
    time=1325.0 + np.arange(T) / 48, timecorr=np.zeros(T, np.float32),
    cadenceno=np.arange(T), quality=np.zeros(T, np.int32), catalog_path=path, wcs=wcs,
    sector=1, camera=1, ccd=1, cache="host", device="cpu")
resh = extract_aperture_batch(ctxh, [1, 2, 3, 4])
assert [r.status for r in resh] == [r.status for r in res]
assert all(np.allclose(a.lightcurve["flux"], b.lightcurve["flux"], rtol=1e-6) for a, b in zip(resh, res))
from photometry_tpu_torch.parallel.mesh import ShardedCube, make_mesh
ctxm = SectorContext.from_arrays(
    images=images, images_err=np.ones_like(images), backgrounds=np.zeros_like(images),
    pixelflags=np.zeros(images.shape, np.uint8), sumimage=images.mean(0),
    time=1325.0 + np.arange(T) / 48, timecorr=np.zeros(T, np.float32),
    cadenceno=np.arange(T), quality=np.zeros(T, np.int32), catalog_path=path, wcs=wcs,
    sector=1, camera=1, ccd=1, mesh=make_mesh(4, 1, ["cpu"] * 4), device="cpu")
assert isinstance(ctxm.images, ShardedCube) and ctxm.images.shape[0] == 8 and ctxm.n_times == T
resm = extract_aperture_batch(ctxm, [1, 2, 3, 4])
assert [r.status for r in resm] == [r.status for r in res]
assert all(np.array_equal(a.lightcurve["flux"], b.lightcurve["flux"], equal_nan=True)
           for a, b in zip(resm, res))
from photometry_tpu_torch.core.engine import TpfContext
tpf = TpfContext(SIM_DIR, TPF_STARID, device="cpu")
got = extract_aperture_batch(tpf, [TPF_STARID])[0]
assert got.status in (STATUS.OK, STATUS.WARNING) and got.stamp == (0, tpf.shape[0], 0, tpf.shape[1])
assert np.isfinite(got.lightcurve["flux"]).all() and got.lightcurve["flux"].shape == (60,)

from chip_smoke import DictCube
from photometry_tpu_torch.io.discovery import find_ffi_files
from photometry_tpu_torch.prepare import STAGES, prepare_cube
files = find_ffi_files(SIM_DIR)
cube = DictCube(len(files), (48, 48), keep_frames=2)
walls = prepare_cube(cube, files, SIM_DIR, 1, 3, 2, device="cpu", chunk=4)
assert cube.stages == set(STAGES), cube.stages
assert np.isfinite(cube.arrays["backgrounds"]).all() and all(cube.wcs)
assert cube.kept_resid.shape == (2, 48, 48) and cube.scratch is None

from photometry_tpu_torch.cli import catalog_cmd, todo_cmd, todo_merge_cmd
from photometry_tpu_torch.io.discovery import find_tpf_files
chain = tempfile.mkdtemp()
shutil.copy(find_tpf_files(SIM_DIR)[0], chain)
assert catalog_cmd.main(["-q", "--camera", "3", "--ccd", "2", "--tic-source", TIC, "1",
                         chain]) == 0
assert todo_cmd.main(["-q", chain]) == 0
todo = os.path.join(chain, "todo.sqlite")
with sqlite3.connect(todo) as conn:
    rows = conn.execute("SELECT starid, datasource FROM todolist ORDER BY priority").fetchall()
    conn.execute("UPDATE todolist SET status=1")
assert (TPF_STARID, "tpf") in rows and all(ds.startswith("tpf") for _, ds in rows), rows

# A drain without plots, and the scheduler with one spawned CPU worker (the
# blocker is its sitecustomize too), each on a copy of the chain's todo:
from photometry_tpu_torch.core.drain import run_drain
from photometry_tpu_torch.parallel.scheduler import run_distributed
drained, sched = chain + "-drain", chain + "-sched"
for dst in (drained, sched):
    shutil.copytree(chain, dst)
    with sqlite3.connect(os.path.join(dst, "todo.sqlite")) as conn:
        conn.execute("UPDATE todolist SET status=NULL")
assert run_drain(drained, 1, device="cpu") == len(rows)
summary = run_distributed(sched, n_workers=1, version=1, device="cpu")
assert summary["drained"] and summary["tasks_run"] == len(rows), summary
for dst in (drained, sched):
    with sqlite3.connect(os.path.join(dst, "todo.sqlite")) as conn:
        done = conn.execute("SELECT COUNT(*) FROM todolist WHERE status IN (1, 3, 5)").fetchone()[0]
    assert done == len(rows), (dst, done)
assert "matplotlib" not in sys.modules
derived = os.path.join(chain, "todo-corr.sqlite")
shutil.copy(todo, derived)
with sqlite3.connect(derived) as conn:
    conn.execute("ALTER TABLE todolist ADD COLUMN corr_status INTEGER DEFAULT NULL")
    conn.execute("UPDATE todolist SET corr_status=1")
merged = os.path.join(chain, "merged.sqlite")
assert todo_merge_cmd.main(["-q", todo, derived, merged]) == 0
with sqlite3.connect(merged) as conn:
    assert conn.execute("SELECT COUNT(*) FROM todolist WHERE corr_status=1").fetchone()[0] == len(rows)

assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
BLOCKER.blocked.discard("matplotlib")
for m in FIGURE_MODULES:
    __import__(m)
assert "matplotlib" in sys.modules
print("OK", len(res), len(psf), len(files))
'''

_IGNORED = {"_build", "__pycache__"}

#: The modules that import matplotlib, and only they.
FIGURE_MODULES = ("photometry_tpu_torch.plots", "photometry_tpu_torch.movie")


def _modules():
    """Every module of photometry_tpu_torch, by dotted name."""
    out = []
    for dirpath, dirs, files in os.walk(PKG):
        dirs[:] = sorted(d for d in dirs if d not in _IGNORED)
        rel = os.path.relpath(dirpath, ROOT).replace(os.sep, ".")
        for f in sorted(files):
            if f == "__init__.py":
                out.append(rel)
            elif f.endswith(".py"):
                out.append(f"{rel}.{f[:-3]}")
    return out


def test_slice_runs_with_jax_blocked(tmp_path):
    from photometry_tpu.sim.simulator import SimConfig, simulate_sector
    sim = simulate_sector(SimConfig(shape=(48, 48), n_times=6, n_stars=8, seed=5))
    sim.write_ffis(str(tmp_path))
    sim.write_tpf(str(tmp_path), int(sim.starid[0]), n_times=60)
    sim.write_catalog(str(tmp_path))
    tic = str(tmp_path.parent / f"{tmp_path.name}-tic.npz")
    arr = sim.catalog_arrays()
    np.savez(tic, starid=arr["starid"], ra=arr["ra_j2000"], dec=arr["dec_j2000"],
             pm_ra=arr["pm_ra"], pm_dec=arr["pm_dec"], tmag=arr["tmag"])
    site = tmp_path.parent / f"{tmp_path.name}-site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(_SITE)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(site), ROOT, os.environ.get("PYTHONPATH", "")]))
    modules = _modules()
    assert {"photometry_tpu_torch.models.psf_fused", "photometry_tpu_torch.prepare",
            "photometry_tpu_torch.todolist", "photometry_tpu_torch.todo_merge",
            "photometry_tpu_torch.sim.simulator", "photometry_tpu_torch.tools.fuzz_e2e",
            "photometry_tpu_torch.cli.catalog_cmd", "photometry_tpu_torch.parallel.scheduler",
            "photometry_tpu_torch.parallel.multihost", "photometry_tpu_torch.cli.scheduler_cmd",
            "photometry_tpu_torch.parallel.mesh", "photometry_tpu_torch.parallel.sharded",
            "photometry_tpu_torch.diagnostics", "photometry_tpu_torch.cli.movie_cmd",
            *FIGURE_MODULES} <= set(modules)
    script = (f"MODULES = {modules!r}\nFIGURE_MODULES = {FIGURE_MODULES!r}\n"
              f"SIM_DIR = {str(tmp_path)!r}\nTIC = {tic!r}\n"
              f"TPF_STARID = {int(sim.starid[0])}\n" + _SCRIPT)
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "OK 4 4 6" in proc.stdout


#: ``sitecustomize`` of the mesh CLI's subprocess: the JAX stack and the
#: JAX package refused (h5py allowed: the drain reads a cube file).
_SITE_MESH = r'''
import importlib.abc, sys

class _Blocked(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "photometry_tpu"):
            raise ImportError(f"{name} is blocked")
        return None

sys.meta_path.insert(0, _Blocked())
'''

_MESH_SCRIPT = r'''
import sqlite3, sys
from photometry_tpu_torch.cli import photometry_cmd
assert photometry_cmd.main(["-q", "--all", "--version", "1", "--mesh", "time=2",
                            "--device", "cpu", FOLDER]) == 0
with sqlite3.connect(FOLDER + "/todo.sqlite") as conn:
    left = conn.execute("SELECT COUNT(*) FROM todolist WHERE status IS NULL").fetchone()[0]
    done = conn.execute("SELECT COUNT(*) FROM diagnostics").fetchone()[0]
assert left == 0 and done > 0, (left, done)
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "photometry_tpu")]
print("MESH OK", done)
'''


def test_mesh_cli_runs_with_jax_blocked(tmp_path):
    """``photometry_cmd --mesh time=2 --device cpu`` drains a prepared sector
    (T = 7, padded to 8) in a subprocess that refuses jax, jaxlib and
    photometry_tpu."""
    from photometry_tpu.cli import prepare_cmd, todo_cmd
    from photometry_tpu.sim.simulator import SimConfig, simulate_sector
    d = tmp_path / "sector"
    sim = simulate_sector(SimConfig(shape=(48, 48), n_times=7, n_stars=8, seed=6))
    sim.write_ffis(str(d))
    sim.write_catalog(str(d))
    assert prepare_cmd.main(["-q", str(d)]) == 0 and todo_cmd.main(["-q", str(d)]) == 0
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(_SITE_MESH)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(site), ROOT, os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", f"FOLDER = {str(d)!r}\n" + _MESH_SCRIPT],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "MESH OK" in proc.stdout


def test_mesh_entry_points_exist():
    """Every entry point that takes a mesh in the JAX package takes one in
    the port, and none of them, nor any function of parallel/mesh.py,
    parallel/sharded.py or multihost's mesh layer, raises
    NotImplementedError."""
    import inspect
    from photometry_tpu_torch.cli import photometry_cmd, scheduler_cmd
    from photometry_tpu_torch.core import dispatcher, drain, engine
    from photometry_tpu_torch.parallel import mesh, multihost, scheduler, sharded
    takes = {engine.SectorContext.__init__: "mesh", engine.SectorContext.from_arrays: "mesh",
             dispatcher.open_context: "mesh", dispatcher.ContextCache.__init__: "mesh",
             drain.run_drain: "mesh", scheduler.run_distributed: "mesh_spec",
             scheduler.worker_loop: "mesh_spec", scheduler.worker_remote: "mesh_spec"}
    for fn, arg in takes.items():
        assert arg in inspect.signature(fn).parameters, fn.__qualname__
    names = {mesh: ["make_mesh", "parse_mesh_spec", "ShardedCube", "shard_cube"],
             sharded: ["pad_to_multiple", "sharded_time_smooth", "sharded_sumimage",
                       "sharded_extract_flux", "sharded_band_extract", "prepare_step",
                       "extraction_step", "sharded_psf_fit", "sharded_linpsf_fit",
                       "sharded_halo_weights"],
             multihost: ["initialize", "shutdown", "is_initialized", "global_mesh",
                         "local_data_slice", "process_shard", "_order_devices"],
             engine: ["_extract_flux_sharded", "context_from_jax"]}
    for mod, fns in names.items():
        for name in fns:
            assert "NotImplementedError" not in inspect.getsource(getattr(mod, name)), name
    for mod in (engine, dispatcher, drain, scheduler, photometry_cmd, scheduler_cmd,
                mesh, sharded, multihost):
        assert "raise NotImplementedError" not in inspect.getsource(mod), mod.__name__
    for cmd in (photometry_cmd, scheduler_cmd):
        assert '"--mesh"' in inspect.getsource(cmd.main)


def _py_files():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_no_module_imports_jax():
    """No import statement (absolute; relative ones stay inside the port)
    names jax, jaxlib or the JAX package."""
    offenders = []
    paths = list(_py_files())
    assert {os.path.join(PKG, *f.split("/")) for f in (
        "tools/fuzz_e2e.py", "tools/profile_psf.py", "tools/profile_k2p2.py",
        "tools/tiebreak_corpus_scale.py", "tools/validate_prf.py", "tools/validate_ecc.py",
        "tools/make_ephemeris.py", "download_cache.py", "utils/downloads.py",
        "cli/download_cache_cmd.py", "todolist.py", "sim/simulator.py", "parallel/__init__.py",
        "parallel/scheduler.py", "parallel/multihost.py", "parallel/mesh.py",
        "parallel/sharded.py", "plots.py", "diagnostics.py",
        "movie.py", "cli/scheduler_cmd.py", "cli/movie_cmd.py")} <= set(paths)
    for path in paths:
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            if any(n.split(".")[0] in ("jax", "jaxlib", "photometry_tpu") for n in names):
                offenders.append(f"{os.path.relpath(path, ROOT)}:{node.lineno}")
    assert not offenders, offenders


#: JAX names without a counterpart of the same name and path in the port:
#: ``"file"`` (all of it) or ``"file:name"`` -> the counterpart
#: (``"port file:name"``) or the reason there is none.
NO_COUNTERPART = {
    "utils/aot.py": "ahead-of-time compilation of XLA programs; PyTorch runs eagerly and each "
                    "CUDA kernel is built once per process",
    "utils/fetch.py": "overlapped device->host copies of JAX arrays; the port's host copies "
                      "are grouped where they are made",
    "models/psf_fit.py:prefetch_psf_programs": "AOT prefetch of the XLA fit programs; nothing "
                                               "is compiled ahead in the port",
    "models/linpsf.py:prefetch_linpsf_programs": "AOT prefetch of the XLA linPSF programs",
    "cli/common.py:enable_compile_cache": "the persistent XLA compile cache; the port's "
                                          "--device replaces the JAX platform flag",
    "parallel/mesh.py:cube_sharding": "a JAX NamedSharding; the port shards with ShardedCube "
                                      "and shard_cube",
    "parallel/mesh.py:replicated": "a JAX NamedSharding; a replicated tensor is one the port "
                                   "copies to each mesh entry",
    "parallel/mesh.py:targets_sharding": "a JAX NamedSharding; the port splits targets in "
                                         "_extract_flux_sharded",
    "ops/bandext.py:bands_supported": "the TPU's 64x128 band layout; band_extract.cu takes "
                                      "every shape, TPF stamps included",
    "ops/bandext.py:build_piece_patches": "the TPU's 64x128 band layout (pieces of cells)",
    "ops/bandext.py:use_banded": "the TPU's 64x128 band layout gate",
    "models/psf_pallas.py:fused_ok": "models/psf_fused.py:fused_ok",
    "models/psf_pallas.py:fused_warm_fit": "models/psf_fused.py:fused_warm_fit",
    "ops/median_pallas.py:median15_tpu": "ops/median15.py:median15_cuda",
    "ops/median_pallas.py:median_pallas_supported": "median15.cu takes every frame shape; "
                                                    "median_filter picks kernel or plain "
                                                    "by the tensor's device",
    "ops/hist_pallas.py:segment_histogram_tpu": "ops/seghist.py:segment_histogram_cuda",
    "ops/hist_pallas.py:pallas_supported": "segment_histogram picks kernel or plain by the "
                                           "tensor's device",
}


def _public_names(path):
    """Top-level functions and classes of a file not starting with ``_``,
    and the methods of its classes (defined or assigned in the class body)
    as ``Class.method``."""
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            if not node.name.startswith("_"):
                out.add(node.name)
        if isinstance(node, ast.ClassDef):
            for sub in node.body:
                names = ([sub.name] if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef))
                         else [t.id for t in sub.targets if isinstance(t, ast.Name)
                               and isinstance(sub.value, ast.Attribute)]
                         if isinstance(sub, ast.Assign) else [])
                out.update(f"{node.name}.{m}" for m in names if not m.startswith("_"))
    return out


def test_every_public_name_has_a_counterpart():
    """The port does all that the JAX package does: a JAX public name the
    port lacks fails here unless NO_COUNTERPART maps it to a counterpart
    that exists or gives the reason it has none."""
    jax_pkg = os.path.join(ROOT, "photometry_tpu")
    missing, used = [], set()
    for dirpath, dirs, files in os.walk(jax_pkg):
        dirs[:] = sorted(d for d in dirs if d not in _IGNORED)
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(dirpath, f), jax_pkg).replace(os.sep, "/")
            names = _public_names(os.path.join(dirpath, f))
            if rel in NO_COUNTERPART:
                used.add(rel)
                continue
            port = os.path.join(PKG, *rel.split("/"))
            have = _public_names(port) if os.path.exists(port) else set()
            for name in sorted(names - have):
                key = f"{rel}:{name}"
                if key not in NO_COUNTERPART:
                    missing.append(key)
                    continue
                used.add(key)
                target = NO_COUNTERPART[key]
                if re.fullmatch(r"[\w/]+\.py:\w+", target):          # a counterpart, not a reason
                    tfile, tname = target.split(":")
                    assert tname in _public_names(os.path.join(PKG, *tfile.split("/"))), target
    assert not missing, missing
    assert used == set(NO_COUNTERPART), sorted(set(NO_COUNTERPART) - used)


def test_psf_bound_counts_the_same_work():
    """chip_smoke's PSF operation count, split into the normal equations
    (which may run on the tensor cores) and the rest, sums to the count of
    the first design's code at every S, K and stamp."""
    from chip_smoke import psf_flops
    for B, S, K, h, it in ((92160, 5, 3, 15, 6), (180, 5, 3, 15, 12), (7, 8, 4, 32, 0),
                           (3, 1, 1, 11, 2)):
        P3, npix = 3 * S, h * h
        axis = S * 2 * h * (64 + 16 * K + 4)
        pixel = npix * (S * (10 + 6 * K) + 1 + P3 * (P3 + 1) + 3 * P3)
        chol = 2 * P3 ** 3 // 3 + 3 * P3
        step = axis + pixel + chol + 2 * P3 ** 2 + 10 * S
        final = axis + pixel + 2 * npix + chol + S * P3 ** 2
        normal, rest = psf_flops(B, S, K, h, h, it)
        assert normal + rest == B * (5 * npix + it * step + final)
        assert normal == B * (it + 1) * npix * (P3 * (P3 + 1) + 3 * P3)


@pytest.mark.cuda
def test_band_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from photometry_tpu_torch.ops import bandext
    from photometry_tpu_torch.ops._kernels import BAND_EXTRACT
    rng = np.random.default_rng(0)
    T, H, W, N, h, w = 37, 256, 384, 200, 33, 33
    imgs = rng.normal(100, 5, (T, H, W)).astype(np.float32)
    imgs[1, 10:40, 10:40] = np.nan
    imgs[3] = 0.0
    errs = (np.sqrt(np.abs(imgs)) + 1.0).astype(np.float32)
    errs[2, 20, 20] = np.nan
    bkgs = rng.normal(20, 1, (T, H, W)).astype(np.float32)
    flags = (rng.uniform(size=(T, H, W)) < 0.01).astype(np.uint8) * 4
    r0s = rng.integers(0, H - h, N).astype(np.int32)
    c0s = rng.integers(0, W - w, N).astype(np.int32)
    masks = rng.uniform(size=(N, h, w)) < 0.4
    windows = np.zeros_like(masks)
    windows[:, 2:30, 1:31] = True
    masks &= windows
    args = [torch.as_tensor(a, device="cuda")
            for a in (imgs, errs, bkgs, flags, masks, r0s, c0s)]
    win = torch.as_tensor(windows, device="cuda")
    before = BAND_EXTRACT.launches
    got = bandext.band_sums_cuda(*args, windows=win)
    torch.cuda.synchronize()
    assert BAND_EXTRACT.launches == before + 1
    want = bandext.band_sums_plain(*args, windows=win)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
def test_streamed_band_sums_equal_device_path_on_card():
    """Host planes streamed through the card (``band_sums_streamed``, T = 37
    in chunks of 16: three launches) give the device path's sums bit for
    bit, from pageable host memory (the pinned staging buffers) and from
    pinned host memory (copied as it is), in float32 and in bfloat16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from photometry_tpu_torch.ops import bandext
    from photometry_tpu_torch.ops._kernels import BAND_EXTRACT, BAND_EXTRACT_BF16
    rng = np.random.default_rng(3)
    T, H, W, N, h = 37, 256, 384, 200, 33
    imgs = rng.normal(100, 5, (T, H, W)).astype(np.float32)
    imgs[1, 10:40, 10:40] = np.nan
    imgs[3] = 0.0
    errs = (np.sqrt(np.abs(imgs)) + 1.0).astype(np.float32)
    bkgs = rng.normal(20, 1, (T, H, W)).astype(np.float32)
    flags = (rng.uniform(size=(T, H, W)) < 0.01).astype(np.uint8) * 4
    r0s = rng.integers(0, H - h + 1, N).astype(np.int32)
    c0s = rng.integers(0, W - h + 1, N).astype(np.int32)
    masks = rng.uniform(size=(N, h, h)) < 0.4
    windows = np.zeros_like(masks)
    windows[:, 2:30, 1:31] = True
    targets = [torch.as_tensor(a, device="cuda") for a in (masks, r0s, c0s)]
    win = torch.as_tensor(windows, device="cuda")
    for dtype, kernel in ((torch.float32, BAND_EXTRACT), (torch.bfloat16, BAND_EXTRACT_BF16)):
        host = [torch.as_tensor(a).to(dtype) for a in (imgs, errs, bkgs)] + [torch.as_tensor(flags)]
        want = bandext.band_sums_cuda(*[x.cuda() for x in host], *targets, windows=win)
        for planes in (host, [x.pin_memory() for x in host]):
            before = kernel.launches
            got = bandext.band_sums_streamed(*planes, *targets, windows=win, device="cuda",
                                             chunk=16)
            torch.cuda.synchronize()
            assert kernel.launches == before + 3
            assert got.is_cuda and torch.equal(got.view(torch.int32), want.view(torch.int32))


def _mesh_band_inputs(T, rng):
    H, W, N, h = 256, 384, 200, 33
    imgs = rng.normal(100, 5, (T, H, W)).astype(np.float32)
    imgs[11, 10:40, 10:40] = np.nan
    imgs[3] = 0.0
    errs = (np.sqrt(np.abs(imgs)) + 1.0).astype(np.float32)
    bkgs = rng.normal(20, 1, (T, H, W)).astype(np.float32)
    flags = (rng.uniform(size=(T, H, W)) < 0.01).astype(np.uint8) * 4
    r0s = rng.integers(0, H - h + 1, N).astype(np.int32)
    c0s = rng.integers(0, W - h + 1, N).astype(np.int32)
    masks = rng.uniform(size=(N, h, h)) < 0.4
    windows = np.zeros_like(masks)
    windows[:, 2:30, 1:31] = True
    return [imgs, errs, bkgs, flags], [masks, r0s, c0s, windows], h


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


@pytest.mark.cuda
def test_band_kernel_on_mesh_shards_on_card():
    """The band kernel on the shards of a mesh of one card (``["cuda:0"] *
    4``, T = 37 in shards of 10): three views that start mid-cube (frames
    0, 10 and 20: the cube's own storage) and a padded last shard (7
    frames and 3 NaN ones, a copy).  Each shard's launch against the plain
    version on the same shard; ``sharded_band_extract`` (4 launches) and the
    (time=2, targets=2) ``sharded_extract_flux`` (4 launches) joined and cut
    to T == the single-device extraction bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from photometry_tpu_torch.ops import bandext
    from photometry_tpu_torch.ops._kernels import BAND_EXTRACT
    from photometry_tpu_torch.parallel.mesh import make_mesh, shard_cube
    from photometry_tpu_torch.parallel.sharded import sharded_band_extract, sharded_extract_flux
    T = 37
    planes, targets, h = _mesh_band_inputs(T, np.random.default_rng(4))
    planes = [torch.as_tensor(a, device="cuda") for a in planes]
    masks, r0s, c0s, win = (torch.as_tensor(a, device="cuda") for a in targets)
    mesh = make_mesh(4, 1, ["cuda:0"] * 4)
    cubes = [shard_cube(x, mesh, fill=0 if x.dtype == torch.uint8 else float("nan"))
             for x in planes]
    for i in range(3):
        assert all(c.shards[i].data_ptr() == x[10 * i].data_ptr() for c, x in zip(cubes, planes))
    assert cubes[0].shards[3].data_ptr() != planes[0][30].data_ptr()
    for i in range(4):
        shard = [c.shards[i] for c in cubes]
        before = BAND_EXTRACT.launches
        got = bandext.band_sums_cuda(*shard, masks, r0s, c0s, windows=win)
        torch.cuda.synchronize()
        assert BAND_EXTRACT.launches == before + 1
        want = bandext.band_sums_plain(*shard, masks, r0s, c0s, windows=win)
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4, atol=1e-3)
    single = bandext.band_extract_flux_batch(*planes, masks, r0s, c0s, h, h, windows=win)
    for run, m in ((sharded_band_extract, mesh),
                   (sharded_extract_flux, make_mesh(2, 2, ["cuda:0"] * 4))):
        cubes_m = [shard_cube(x, m, fill=0 if x.dtype == torch.uint8 else float("nan"))
                   for x in planes]
        before = BAND_EXTRACT.launches
        got = run(*cubes_m, masks, r0s, c0s, m, h, h, windows=win)
        torch.cuda.synchronize()
        assert BAND_EXTRACT.launches == before + 4, run.__name__
        for a, b in zip(got, single):
            assert torch.equal(_bits(a[:, :T].contiguous()), _bits(b)), run.__name__


@pytest.mark.cuda
def test_sharded_psf_fit_matches_single_on_card(tmp_path):
    """sharded_psf_fit over a mesh of one card (11 targets on 4 entries,
    padded to 12) runs psf_warm_fit once a shard and phase, and gives the
    single-device kernel fit's bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from chip_smoke import psf_instances, table_prf
    from photometry_tpu_torch.models import psf_fit
    from photometry_tpu_torch.models.prf import PRF
    from photometry_tpu_torch.ops._kernels import PSF_WARM_FIT
    from photometry_tpu_torch.parallel.mesh import make_mesh
    from photometry_tpu_torch.parallel.sharded import sharded_psf_fit
    prf = table_prf(PRF, str(tmp_path), 3, "cuda")
    N, T, S, side = 11, 6, 5, 15
    imgs, bkg, p0, valid, mini, _ = psf_instances(np.random.default_rng(5), prf, N * T, S,
                                                  side, side, n_cfg=N, nan_frac=0.01)

    def per_target(a):                      # instance t*N + n is target n's cadence t
        return a.reshape((T, N) + a.shape[1:]).swapaxes(0, 1)
    args = [torch.as_tensor(np.ascontiguousarray(a), device="cuda") for a in
            (per_target(imgs), per_target(bkg), p0[:N], valid[:N], mini[:N],
             np.zeros(N, np.int32))]
    before = PSF_WARM_FIT.launches
    single = psf_fit.fit_psf_timeseries_batch(args[0], args[1], 1.0, *args[2:], prf,
                                              (side, side), S)
    torch.cuda.synchronize()
    assert PSF_WARM_FIT.launches == before + 2
    before = PSF_WARM_FIT.launches
    got = sharded_psf_fit(*args[:2], 1.0, *args[2:], prf, (side, side), S,
                          make_mesh(4, 1, ["cuda:0"] * 4))
    torch.cuda.synchronize()
    assert PSF_WARM_FIT.launches == before + 8
    for k in single:
        assert got[k].shape == single[k].shape
        assert torch.equal(got[k].view(torch.int32), single[k].view(torch.int32)), k


@pytest.mark.cuda
def test_psf_kernel_matches_plain_on_card(tmp_path):
    """psf_warm_fit against its plain version at S=3 (the well-posed problems
    of tests/test_psf_pallas.py, its tight bounds) and S=5, K=3 (a two-star
    table PRF, its crowded-stamp percentile bounds); then the edges of the
    tensor-core design under the crowded bounds: S = 1, 5, 6 and 8 (one and
    two 16-column groups), K = 1 and 4, stamps of 11, 15, 17 and 32 px (pixel
    counts not multiples of 8 or 32), an all-NaN stamp that must not move,
    and n_iters = 0, which must return the start."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from photometry_tpu_torch.models.prf import PRF
    from photometry_tpu_torch.models.psf_fused import fused_warm_fit_cuda, fused_warm_fit_plain
    from photometry_tpu_torch.ops._kernels import PSF_WARM_FIT
    m = 72
    offs = np.arange(-m, m + 1) / 9
    rng = np.random.default_rng(0)
    for S, terms, n_iters in ((3, [(1.0, 1.2)], 4), (5, [(0.7, 1.1), (0.3, 2.0)], 6)):
        g = sum(a * np.exp(-0.5 * (offs[:, None] ** 2 + offs[None, :] ** 2) / s ** 2)
                for a, s in terms)
        path = str(tmp_path / f"tess-s{S}-1-1-characterized-prf.mat")
        PRF.write_mat(path, [g / (g.sum() / 81)], [1024.0], [1024.0])
        prf = PRF.from_mat(path, 1, 1, 1, (0, 15, 0, 15), device="cuda")
        B, h = 256, 11 if S == 3 else 15
        rows = h / 2 - 0.5 + rng.uniform(-2, 2, (B, S))
        cols = h / 2 - 0.5 + rng.uniform(-2, 2, (B, S))
        flux = 800.0 + 3000.0 * rng.uniform(size=(B, S))
        par = torch.as_tensor(np.stack([rows, cols, flux], -1), dtype=torch.float32,
                              device="cuda")
        imgs = prf.integrate_to_image(par, (h, h), 5.0).cpu().numpy() + 5.0
        imgs = (imgs + 0.8 * rng.normal(size=imgs.shape)).astype(np.float32)
        imgs[1, 2, 3] = np.nan
        p0 = np.concatenate([rows, cols, flux], 1) + 0.25 * rng.normal(size=(B, 3 * S))
        valid = np.ones((B, S), bool)
        valid[::3, S - 1] = False
        mini = np.zeros((B, h, h), bool)
        mini[:, h // 2 - 2:h // 2 + 3, h // 2 - 2:h // 2 + 3] = True
        onehot = np.zeros((B, S), np.float32)
        onehot[:, 0] = 1.0
        args = [torch.as_tensor(a, device="cuda") for a in
                (imgs, np.full_like(imgs, 2.0), p0.astype(np.float32), valid, mini, onehot)]
        before = PSF_WARM_FIT.launches
        got = fused_warm_fit_cuda(args[0], args[1], 1.0, *args[2:], prf, (h, h), S, n_iters)
        torch.cuda.synchronize()
        assert PSF_WARM_FIT.launches == before + 1
        want = fused_warm_fit_plain(args[0], args[1], 1.0, *args[2:], prf, (h, h), S, n_iters)
        pg, pw = got["params"].cpu().numpy(), want["params"].cpu().numpy()
        assert np.isfinite(pg).all()
        pos = np.abs(pg[:, :2 * S] - pw[:, :2 * S])[np.concatenate([valid, valid], 1)]
        rel = (np.abs(pg[:, 2 * S:] - pw[:, 2 * S:]) / np.maximum(pw[:, 2 * S:], 10.0))[valid]
        assert np.percentile(pos, 90) < 5e-3 and np.percentile(rel, 90) < 5e-3, S
        if S == 3:
            assert np.percentile(rel, 95) < 1e-3, np.percentile(rel, 95)
    from chip_smoke import psf_fit_check, psf_instances, table_prf
    prfs = {K: table_prf(PRF, str(tmp_path), K, "cuda") for K in (1, 3, 4)}
    for S, K, side, n_iters, B in ((1, 1, 11, 12, 256), (5, 4, 15, 6, 512), (6, 3, 17, 6, 256),
                                   (8, 4, 32, 6, 128), (5, 1, 15, 0, 256)):
        inputs = psf_instances(rng, prfs[K], B, S, side, side, nan_frac=0.01)
        inputs[0][0] = np.nan
        args = [torch.as_tensor(a, device="cuda") for a in inputs]
        before = PSF_WARM_FIT.launches
        got = fused_warm_fit_cuda(args[0], args[1], 1.0, *args[2:], prfs[K], (side, side), S,
                                  n_iters)
        torch.cuda.synchronize()
        assert PSF_WARM_FIT.launches == before + 1
        want = fused_warm_fit_plain(args[0], args[1], 1.0, *args[2:], prfs[K], (side, side), S,
                                    n_iters)
        pg = got["params"].cpu().numpy()
        assert np.array_equal(pg[0], inputs[2][0]), (S, K, side)
        if n_iters == 0:
            assert np.array_equal(pg, inputs[2])
        psf_fit_check(got, want, inputs[3], S, "crowded", f"S={S} K={K} {side}x{side}")


@pytest.mark.cuda
def test_median15_kernel_matches_plain_on_card():
    """The 15x15 median kernel against its plain version, bit for bit: a
    3.4e38 outlier, a flat region, signed zeros, a frame narrower than the
    halo, and odd sizes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from photometry_tpu_torch.ops import median15
    from photometry_tpu_torch.ops._kernels import MEDIAN15
    rng = np.random.default_rng(0)
    frames = rng.normal(100, 30, (3, 131, 257)).astype(np.float32)
    frames[0, 60, 60] = 3.4028235e38
    frames[1, :40, :40] = 7.0
    frames[2, :20, :20] = rng.choice([0.0, -0.0], (20, 20))
    for x in (frames, rng.normal(5, 2, (2, 6, 5)).astype(np.float32)):
        xt = torch.as_tensor(x, device="cuda")
        before = MEDIAN15.launches
        got = median15.median15_cuda(xt)
        torch.cuda.synchronize()
        assert MEDIAN15.launches == before + 1
        want = median15.median_filter_plain(xt)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
def test_median15_kernel_adversarial_on_card():
    """The shared-probe median against its plain version, bit for bit, where
    it is hardest: a few distinct values (most windows all ties), negative
    frames, +-3.4e38 side by side and in blocks large enough to hold a
    window's median, denormals with zeros of both signs, frames of only
    -0.0 and +0.0 (the float probes never split that pair), and frames whose
    sides are not multiples of the 32 x 32 block tile."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from photometry_tpu_torch.ops import median15
    rng = np.random.default_rng(5)
    big = 3.4028235e38
    huge = rng.normal(0.0, 1.0, (1, 131, 257)).astype(np.float32)
    huge[0, 20, 20], huge[0, 20, 21] = big, -big
    huge[0, 40:52, 40:52] = big
    huge[0, 40:52, 52:64] = -big
    cases = [rng.choice([1.0, 2.0, 3.0, 5.0], (2, 300, 200), p=[0.6, 0.2, 0.1, 0.1]),
             rng.choice([-1.0, 1.0], (1, 33, 65)),
             rng.normal(-50.0, 20.0, (2, 131, 257)), huge,
             np.where(rng.uniform(size=(1, 70, 90)) < 0.2, rng.choice([0.0, -0.0], (1, 70, 90)),
                      rng.normal(0.0, 1e-39, (1, 70, 90))),
             rng.choice([0.0, -0.0], (1, 80, 70)),
             rng.normal(0.0, 15.0, (1, 2078, 2136))]
    for x in cases:
        xt = torch.as_tensor(np.asarray(x, np.float32), device="cuda")
        got = median15.median15_cuda(xt)
        torch.cuda.synchronize()
        want = median15.median_filter_plain(xt)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), tuple(x.shape)


@pytest.mark.cuda
def test_band_kernel_stamp_cases_on_card():
    """The band kernel's compacted lists on the stamps that stress them: a
    1-pixel mask, a full one, masks on each edge and on the border ring, an
    empty mask, windows cut short, 33x33 and 60x60 stamps (two chunks of the
    box) flush with the frame, and T = 37 (not a multiple of the 32-cadence
    block); counts exact, sums at rtol 1e-4 + atol 1e-3, the same bits on
    two runs, and a corner outside the frame refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from photometry_tpu_torch.ops import bandext
    rng = np.random.default_rng(6)
    T, H, W = 37, 128, 192
    imgs = rng.normal(100, 5, (T, H, W)).astype(np.float32)
    imgs[2, 40:50, 40:50] = np.nan
    imgs[5] = 0.0
    errs = (np.sqrt(np.abs(imgs)) + 1.0).astype(np.float32)
    errs[7, 10, 10] = np.inf
    bkgs = rng.normal(20, 1, (T, H, W)).astype(np.float32)
    flags = (rng.uniform(size=(T, H, W)) < 0.05).astype(np.uint8) * 4
    cube = [torch.as_tensor(a, device="cuda") for a in (imgs, errs, bkgs, flags)]
    for hw in (33, 60):
        masks = np.zeros((10, hw, hw), bool)
        masks[0, hw // 2, hw // 2] = True
        masks[1] = True
        masks[2, 0, :] = True
        masks[3, -1, :] = True
        masks[4, :, 0] = True
        masks[5, :, -1] = True
        masks[6, [0, -1], :] = True
        masks[6, :, [0, -1]] = True
        masks[8] = rng.uniform(size=(hw, hw)) < 0.4
        masks[9] = rng.uniform(size=(hw, hw)) < 0.05
        windows = np.ones_like(masks)
        windows[7:, :, hw - 8:] = False
        masks &= windows
        r0s = rng.integers(0, H - hw + 1, 10).astype(np.int32)
        c0s = rng.integers(0, W - hw + 1, 10).astype(np.int32)
        r0s[:2], c0s[:2] = [0, H - hw], [W - hw, 0]
        args = [torch.as_tensor(a, device="cuda") for a in (masks, r0s, c0s)]
        for win in (None, torch.as_tensor(windows, device="cuda")):
            got = bandext.band_sums_cuda(*cube, *args, windows=win)
            again = bandext.band_sums_cuda(*cube, *args, windows=win)
            torch.cuda.synchronize()
            assert torch.equal(got.view(torch.int32), again.view(torch.int32))
            want = bandext.band_sums_plain(*cube, *args, windows=win)
            counts = [1, 2, 8, 9]
            assert torch.equal(got[:, counts], want[:, counts])
            np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4,
                                       atol=1e-3)
    bad = args[2].clone()
    bad[3] = W - 60 + 1
    with pytest.raises(ValueError, match="outside"):
        bandext.band_sums_cuda(*cube, args[0], args[1], bad)


@pytest.mark.cuda
def test_segment_hist_kernel_matches_plain_on_card():
    """The segment-histogram kernel against its bincount, bit for bit:
    invalid and out-of-range samples, empty segments, one bucket, a 64-ring
    table, N not a multiple of 4 (scalar loop on 3 frames, 4-wide loads and
    a tail on 1), arrays starting one element in (a scalar head) and a
    bucket array alone misaligned (the scalar loop), F = 1 and F = 64, N <
    32, one cell with 2^20 samples of one frame, and a table too large for
    shared memory refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from photometry_tpu_torch.ops import seghist
    from photometry_tpu_torch.ops._kernels import SEGMENT_HIST, KernelError
    rng = np.random.default_rng(1)
    n = 200_001
    seg = rng.integers(-2, 44, n).astype(np.int32)
    seg[(seg >= 5) & (seg <= 9)] = 11
    cases = [(seg, rng.integers(-3, 515, (4, n)), rng.uniform(size=(4, n)) < 0.7, 40),
             (seg, np.full((2, n), 3), np.ones((2, n), bool), 40),
             (seg, rng.integers(0, 512, (2, n)), np.ones((2, n), bool), 64),
             (seg, rng.integers(0, 512, (1, n)), rng.uniform(size=(1, n)) < 0.9, 40),
             (seg[:1 << 16], rng.integers(0, 512, (64, 1 << 16)), np.ones((64, 1 << 16), bool),
              40),
             (seg[:13], rng.integers(0, 512, (2, 13)), np.ones((2, 13), bool), 40),
             (np.zeros(1 << 20, np.int32), np.full((1, 1 << 20), 5), np.ones((1, 1 << 20), bool),
              40)]
    for sg, b, good, n_seg in cases:
        args = [torch.as_tensor(a, device="cuda") for a in (sg, b.astype(np.int32), good)]
        before = SEGMENT_HIST.launches
        got = seghist.segment_histogram_cuda(*args, n_seg, 512)
        torch.cuda.synchronize()
        assert SEGMENT_HIST.launches == before + 1
        assert torch.equal(got, seghist.segment_histogram_plain(*args, n_seg, 512))
    assert float(got[0, 0, 5]) == 1 << 20
    N = 65540
    sb = torch.randint(0, 40, (N + 1,), device="cuda", dtype=torch.int32)
    bb = torch.randint(0, 512, (4 * N + 1,), device="cuda", dtype=torch.int32)
    gb = torch.rand(4 * N + 1, device="cuda") < 0.8
    b1, g1 = bb[1:].view(4, N), gb[1:].view(4, N)
    for sg, head in ((sb[1:], 3), (sb[:N], -1)):
        assert seghist.vector_head(sg.data_ptr(), b1.data_ptr(), g1.data_ptr(), 4, N) == head
        assert torch.equal(seghist.segment_histogram_cuda(sg, b1, g1, 40, 512),
                           seghist.segment_histogram_plain(sg, b1, g1, 40, 512))
    with pytest.raises(KernelError):
        seghist.segment_histogram_cuda(sb[:N], b1, g1, 128, 512)


@pytest.mark.cuda
def test_stamp_flux_kernel_matches_plain_on_card():
    """The stamp-flux kernel against its plain version (RTOL/ATOL of the
    extraction: float32 sums in another order; the NaN pattern exact, two
    runs bit-equal): NaN and ±inf pixels, an empty mask, an all-NaN
    cadence, stamps flush with and past the edges, N = 1 / 7 / 9, masks of
    1 to 64 px, T = 8, 37 and 512, 40 crowded targets whose masks share
    sectors handed over in reverse frame order, planes that do not start on
    16 bytes (41 x 259, and a cube one float into its storage), and a mask
    too large for shared memory refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from chip_smoke import stamp_case, stamp_crowded_case
    from photometry_tpu_torch.ops import stamp_flux as sf
    from photometry_tpu_torch.ops._kernels import STAMP_FLUX, KernelError
    rng = np.random.default_rng(2)
    cases = [stamp_case(rng, T, H, W, N, h) + (h,)
             for T, H, W, N, h in ((8, 40, 256, 1, 1), (8, 64, 256, 7, 17), (512, 64, 256, 9, 17),
                                   (512, 96, 384, 9, 64), (37, 64, 256, 9, 17),
                                   (8, 41, 259, 7, 17))]
    cases.append(stamp_crowded_case(rng, 37, 48, 96, 40, 17) + (17,))
    imgs = cases[4][0]
    flat = torch.empty(imgs.size + 1, device="cuda")
    off16 = flat[1:].view(imgs.shape)
    off16.copy_(torch.as_tensor(imgs))
    for i, (*arrays, h) in enumerate(cases + [(off16,) + cases[4][1:]]):
        args = [torch.as_tensor(a, device="cuda") for a in arrays]
        before = STAMP_FLUX.launches
        got = sf.stamp_flux_cuda(*args)
        again = sf.stamp_flux_cuda(*args)
        torch.cuda.synchronize()
        assert STAMP_FLUX.launches == before + 2
        assert torch.equal(got.view(torch.int32), again.view(torch.int32)), f"case {i}"
        want = sf.stamp_flux_plain(*args).cpu().numpy()
        np.testing.assert_array_equal(np.isnan(got.cpu().numpy()), np.isnan(want))
        np.testing.assert_allclose(got.cpu().numpy(), want, rtol=torch_parity.RTOL,
                                   atol=torch_parity.ATOL, equal_nan=True)
        if args[0].shape[0] % 8 == 0:
            assert torch.equal(sf.stamp_extract_flux(*args, h, h).view(torch.int32),
                               got.view(torch.int32))
    with pytest.raises(KernelError):
        sf.stamp_flux_cuda(args[0], torch.ones(1, 300, 300, dtype=torch.bool, device="cuda"),
                           args[2][:1], args[3][:1])


def _switch_field(path, device):
    """A 64x64, 16-cadence context on ``device``: a Tmag 5.5 star with a 1%
    sinusoid, a 4 px pair (Tmag 10.0 and 10.3) and two isolated stars."""
    from photometry_tpu_torch.catalog import make_catalog_from_arrays
    from photometry_tpu_torch.core.engine import SectorContext
    from photometry_tpu_torch.io.wcs import TanWCS
    rng = np.random.default_rng(4)
    H = W = 64
    T = 16
    rows = np.array([32.3, 14.2, 14.2 + 2.8, 50.6, 12.4])
    cols = np.array([30.7, 40.1, 40.1 + 2.86, 12.3, 12.8])
    tmag = np.array([5.5, 10.0, 10.3, 9.0, 11.0])
    yy, xx = np.mgrid[0:H, 0:W]
    amp = np.ones((T, len(tmag)))
    amp[:, 0] += 0.01 * np.sin(np.arange(T) / 2.0)
    images = np.full((T, H, W), 100.0)
    for k, (r, c, m) in enumerate(zip(rows, cols, tmag)):
        psf = np.exp(-0.5 * ((yy - r) ** 2 + (xx - c) ** 2) / 1.2 ** 2) / (2 * np.pi * 1.44)
        images += amp[:, k, None, None] * 10 ** (-0.4 * (m - 20.451)) * psf
    images = (images + rng.normal(0, 1, images.shape) * np.sqrt(images)).astype(np.float32)
    wcs = TanWCS(crpix=[32.5, 32.5], crval=[80.0, -30.0],
                 cd=[[-21 / 3600, 0], [0, 21 / 3600]])
    ra, dec = wcs.radec_of_rowcol(rows, cols)
    cat = make_catalog_from_arrays(str(path), 1, 1, 1, starid=np.arange(1, 6), ra_j2000=ra,
                                   dec_j2000=dec, pm_ra=np.zeros(5), pm_dec=np.zeros(5),
                                   tmag=tmag, reference_time=2458340.0)
    return SectorContext.from_arrays(
        images=images - 100.0, images_err=np.sqrt(images), backgrounds=np.full_like(images, 100.0),
        pixelflags=np.zeros(images.shape, np.uint8), sumimage=images.mean(0) - 100.0,
        time=1325.0 + np.arange(T) / 48, timecorr=np.zeros(T, np.float32),
        cadenceno=np.arange(T), quality=np.zeros(T, np.int32), catalog_path=cat, wcs=wcs,
        sector=1, camera=1, ccd=1, header={"PSFSIGMA": 1.2}, device=device)


@pytest.mark.cuda
def test_linpsf_and_halo_match_cpu_on_card(tmp_path):
    """``extract_linpsf_batch`` and ``extract_halo_batch`` on the card equal
    the port's CPU run: linPSF fluxes, errors and contamination to rtol
    1e-4 (tests/test_psf_models.py:190), halo light curves and weightmaps to
    the weights' rtol 5e-4 (tests/test_halo.py:62-66); statuses exact."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from photometry_tpu_torch.models.halo import extract_halo_batch
    from photometry_tpu_torch.models.linpsf import extract_linpsf_batch
    cpu, card = _switch_field(tmp_path, "cpu"), _switch_field(tmp_path, "cuda")
    for g, w in zip(extract_linpsf_batch(card, [2, 3, 4, 5]),
                    extract_linpsf_batch(cpu, [2, 3, 4, 5])):
        assert g.status == w.status and g.details["n_stars_fit"] == w.details["n_stars_fit"]
        for k in ("flux", "flux_err", "flux_background"):
            np.testing.assert_allclose(g.lightcurve[k], w.lightcurve[k], rtol=1e-4,
                                       atol=1e-4 * np.nanmedian(np.abs(w.lightcurve["flux"])),
                                       err_msg=f"{g.starid} {k}")
        np.testing.assert_allclose(g.details["contamination"], w.details["contamination"],
                                   rtol=1e-4, atol=1e-7)
    for kw in ({}, {"objective": "tv_o2", "sigclip": True, "maxiter": 41}):
        got, want = extract_halo_batch(card, [1, 4], **kw), extract_halo_batch(cpu, [1, 4], **kw)
        for g, w in zip(got, want):
            assert g.status == w.status and g.details.get("errors") == w.details.get("errors")
            for k in ("flux", "flux_err"):
                np.testing.assert_allclose(g.lightcurve[k], w.lightcurve[k], rtol=5e-4,
                                           err_msg=f"{g.starid} {k}")
            gw, ww = g.details["halo_weightmap"], w.details["halo_weightmap"]
            np.testing.assert_allclose(gw["weightmap"], ww["weightmap"], rtol=5e-4,
                                       atol=1e-6 * np.abs(ww["weightmap"]).max())
            assert gw["sat_pixels"] == ww["sat_pixels"]
    cpu.close()
    card.close()


@pytest.mark.cuda
def test_band_kernel_bf16_matches_plain_on_card():
    """A bfloat16 cube goes to the kernel's bfloat16 instantiation (its
    launch count rises, the float32 one's does not); its sums equal the plain
    ones on the same cube (counts exact, rtol 1e-4, atol 1e-3) and the
    float32 kernel's on the cube widened, bit for bit.  Also at a TPF's
    shape: whole 11x11 frames (planes of 242 bytes, off 16-byte bounds) at
    T = 19,728 (617 blocks on the grid's y axis)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from photometry_tpu_torch.ops import bandext
    from photometry_tpu_torch.ops._kernels import BAND_EXTRACT, BAND_EXTRACT_BF16
    rng = np.random.default_rng(1)
    for T, H, W, N, h in ((37, 256, 384, 200, 33), (19728, 11, 11, 1, 11)):
        imgs = rng.normal(100, 5, (T, H, W)).astype(np.float32)
        imgs[1, :8, :8] = np.nan
        imgs[2, :3, :3] = [[np.inf, -np.inf, 3.397e38], [-3.397e38, 1e-39, -0.0], [0, 1e-45, 5]]
        errs = (np.sqrt(np.abs(imgs)) + 1.0).astype(np.float32)
        bkgs = rng.normal(20, 1, (T, H, W)).astype(np.float32)
        flags = (rng.uniform(size=(T, H, W)) < 0.01).astype(np.uint8) * 4
        r0s = rng.integers(0, H - h + 1, N).astype(np.int32)
        c0s = rng.integers(0, W - h + 1, N).astype(np.int32)
        r0s[0] = c0s[0] = 0
        masks = rng.uniform(size=(N, h, h)) < 0.4
        masks[0, :3, :3] = True
        cube = [torch.as_tensor(a, device="cuda").to(torch.bfloat16) for a in (imgs, errs, bkgs)]
        rest = [torch.as_tensor(a, device="cuda") for a in (flags, masks, r0s, c0s)]
        before, before32 = BAND_EXTRACT_BF16.launches, BAND_EXTRACT.launches
        got = bandext.band_sums_cuda(*cube, *rest)
        torch.cuda.synchronize()
        assert BAND_EXTRACT_BF16.launches == before + 1 and BAND_EXTRACT.launches == before32
        want = bandext.band_sums_plain(*cube, *rest).cpu().numpy()
        g = got.cpu().numpy()
        np.testing.assert_array_equal(g[:, [1, 2, 8, 9]], want[:, [1, 2, 8, 9]])
        np.testing.assert_allclose(g, want, rtol=1e-4, atol=1e-3)
        wide = bandext.band_sums_cuda(*[x.float() for x in cube], *rest)
        assert torch.equal(got.view(torch.int32), wide.view(torch.int32))


@pytest.mark.cuda
def test_tpf_extraction_on_card(tmp_path):
    """A TpfContext on the card (a TPF written by chip_smoke.write_tpf):
    ``extract_aperture_batch`` launches the band kernel and equals the
    port's CPU run: statuses, masks and APERTURE bits exact, fluxes to
    rtol 1e-4, atol 1e-3, pos_corr within 2e-5 px."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from chip_smoke import write_tpf
    from photometry_tpu_torch.catalog import make_catalog_from_arrays
    from photometry_tpu_torch.core.engine import TpfContext, extract_aperture_batch
    from photometry_tpu_torch.io import fits as pf
    from photometry_tpu_torch.io.wcs import TanWCS
    from photometry_tpu_torch.ops._kernels import BAND_EXTRACT
    rng = np.random.default_rng(2)
    wcs = TanWCS(crpix=[1024.5, 1024.5], crval=[95.0, -60.0],
                 cd=[[-21.0 / 3600, 0.0], [0.0, 21.0 / 3600]])
    rows, cols = np.array([505.2, 507.9, 498.0]), np.array([300.4, 296.8, 303.1])
    tmag = np.array([9.0, 10.5, 12.0])
    ra, dec = wcs.radec_of_rowcol(rows, cols)
    make_catalog_from_arrays(str(tmp_path), 1, 1, 1, starid=np.arange(1, 4), ra_j2000=ra,
                             dec_j2000=dec, pm_ra=np.zeros(3), pm_dec=np.zeros(3), tmag=tmag,
                             reference_time=2458340.0)
    T, side, r0, c0 = 3000, 15, 498, 293
    t = 1325.3 + (np.arange(T) + 0.5) * 120 / 86400
    pos = np.stack([0.3 * (t - t[0]) / 4, -0.2 * (t - t[0]) / 4], 1).astype(np.float32)
    yy, xx = np.mgrid[r0:r0 + side, c0:c0 + side]
    flux = np.zeros((T, side, side))
    for r, c, m in zip(rows, cols, tmag):
        g = np.exp(-0.5 * ((yy - r - pos[:, 1, None, None]) ** 2
                           + (xx - c - pos[:, 0, None, None]) ** 2) / 1.2 ** 2)
        flux += 10 ** (-0.4 * (m - 20.451)) * g / (2 * np.pi * 1.44)
    flux = (flux + rng.normal(0, 3, flux.shape)).astype(np.float32)
    flux[5, 0, 0] = np.nan
    aperture = np.full((side, side), 1 | 64, np.int32)
    aperture[6:9, 6:9] |= 2 | 8
    hdr = wcs.shifted(drow=r0, dcol=c0).to_header(pf.Header())
    hdr.set("CRVAL1P", c0 + 1)
    hdr.set("CRVAL2P", r0 + 1)
    write_tpf(str(tmp_path / "tess2020186164531-s0001-0000000000000001-0120-s_tp.fits"), 1, 1, 1,
              1, {"TIME": t, "TIMECORR": np.zeros(T, np.float32),
                  "CADENCENO": np.arange(T, dtype=np.int32), "FLUX": flux,
                  "FLUX_ERR": np.full_like(flux, 3.0), "FLUX_BKG": np.full_like(flux, 20.0),
                  "QUALITY": np.zeros(T, np.int32), "POS_CORR1": pos[:, 0],
                  "POS_CORR2": pos[:, 1]}, aperture, hdr)
    card = TpfContext(str(tmp_path), 1, device="cuda")
    cpu = TpfContext(str(tmp_path), 1, device="cpu")
    assert card.images.is_cuda and card.images.dtype == torch.float32
    before = BAND_EXTRACT.launches
    got = extract_aperture_batch(card, [1, 2])
    assert BAND_EXTRACT.launches == before + 1
    for g, w in zip(got, extract_aperture_batch(cpu, [1, 2])):
        assert g.status == w.status and g.stamp == w.stamp == (0, side, 0, side)
        np.testing.assert_array_equal(g.mask, w.mask)
        np.testing.assert_array_equal(g.aperture_image, w.aperture_image)
        for k in ("flux", "flux_err", "flux_background", "pos_centroid"):
            np.testing.assert_allclose(g.lightcurve[k], w.lightcurve[k], rtol=1e-4, atol=1e-3,
                                       equal_nan=True, err_msg=k)
        np.testing.assert_allclose(g.lightcurve["pos_corr"], w.lightcurve["pos_corr"], atol=2e-5)
    card.close()
    cpu.close()


@pytest.mark.cuda
def test_profile_psf_fused_route_on_card():
    """``tools/profile_psf`` at a small size on the card takes the fused
    route: each ``full`` call one group (two kernel launches), phase 2 one
    launch over all N*T instances, and the fluxes equal the plain fitter's
    within phase 4's bounds (99% within rtol 2e-2) on the targets whose
    fits are well-posed (``chip_smoke.psf_stable_share``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from photometry_tpu_torch.models import psf_fused
    from photometry_tpu_torch.ops._kernels import PSF_WARM_FIT
    from photometry_tpu_torch.tools import profile_psf
    from photometry_tpu_torch.utils.profiling import StageTimer
    sizes = []
    real = psf_fused.fused_warm_fit_cuda

    def recording(images, *a, **kw):
        sizes.append(images.shape[0])
        return real(images, *a, **kw)

    before = PSF_WARM_FIT.launches
    psf_fused.fused_warm_fit_cuda = recording
    recorder = StageTimer()
    try:
        with recorder.recording():
            summary, full, inp = profile_psf.profile(["--chunk", "8", "--T", "40",
                                                      "--reps", "1"])
    finally:
        psf_fused.fused_warm_fit_cuda = real
    torch.cuda.synchronize()
    assert summary["config"]["backend"].startswith("cuda")
    n = recorder.timings
    assert n["psf_fused_instances"] == n["psf_instances"] > 0, n
    assert PSF_WARM_FIT.launches - before == 6 and sorted(set(sizes)) == [8, 320]
    assert torch.isfinite(full["flux"]).all()
    from chip_smoke import psf_stable_share
    held = psf_stable_share(full["flux"], inp, 8, 40)
    assert 0 in held["posed"] and len(held["posed"]) >= 4 and held["share"] >= 0.99, held


@pytest.mark.cuda
def test_images_stage_on_card_equals_cpu_path_bit_for_bit(monkeypatch):
    """Prepare's stage 2 on the card writes the bytes its CPU path writes
    (which tests/test_torch_prepare.py holds to the frame-by-frame numpy
    arithmetic): NaN CAL pixels and a NaN background keep their bits
    through the subtraction, a frame has BACKAPP, one no UNCERT, one a
    failing DQUALITY; T = 11 in chunks of 4 (a partial last chunk)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from chip_smoke import DictCube
    from photometry_tpu_torch import prepare as prep
    from photometry_tpu_torch.io.tess import FFIFrame
    rng = np.random.default_rng(7)
    T, H, W = 11, 96, 160
    frames = []
    for k in range(T):
        data = rng.normal(200, 50, (H, W)).astype(np.float32)
        data[rng.uniform(size=(H, W)) < 0.02] = np.nan
        data[k, 3] = np.inf
        data[5, 5] = np.nan                      # 0 / 0 in the sum image
        data[0, 5] = (2.0 ** 57, 1, -2.0 ** 57, 1, 2.0 ** 55, 3, -2.0 ** 55, 1, 1, 1, 1)[k]
        unc = None if k == 6 else np.sqrt(np.abs(data)).astype(np.float32) + 1
        hdr = {"TSTART": 1325.3 + k / 48, "TSTOP": 1325.3 + (k + 1) / 48, "BARYCORR": 0.002,
               "FFIINDEX": 4697 + k, "DQUALITY": 4 if k == 3 else 0, "BACKAPP": k == 8}
        frames.append(FFIFrame(data=data, uncertainty=unc, header=hdr))
    bkg = rng.normal(80, 5, (T, H, W)).astype(np.float32)
    bkg[2, 7, 9] = np.nan
    flags = (rng.uniform(size=(T, H, W)) < 0.3).astype(np.uint8)
    flags |= (rng.uniform(size=(T, H, W)) < 0.05).astype(np.uint8) * 2
    cubes = {}
    for dev in ("cpu", "cuda"):
        cubes[dev] = cube = DictCube(T, (H, W))
        cube.write_block("backgrounds", 0, bkg)
        cube.write_block("pixelflags", 0, flags)
        monkeypatch.setattr(prep, "iter_frames", lambda files: iter(frames))
        prep._images_stage(cube, [None] * T, frames[0], 1, 3, 2, 4, 0.5, torch.device(dev))
    a, b = cubes["cpu"], cubes["cuda"]
    assert np.isnan(a.arrays["images"]).any() and np.isnan(a.sumimage).any()
    for k in ("images", "images_err"):
        np.testing.assert_array_equal(b.arrays[k].view(np.uint32), a.arrays[k].view(np.uint32))
    np.testing.assert_array_equal(b.sumimage.view(np.uint64), a.sumimage.view(np.uint64))
    np.testing.assert_array_equal(b.pixels_used, a.pixels_used)
    for k in ("time", "timecorr", "cadenceno", "quality", "time_start", "time_stop"):
        np.testing.assert_array_equal(b.vectors[k], a.vectors[k], err_msg=k)
    assert b.wcs_strings() == a.wcs_strings()
