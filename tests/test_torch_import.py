"""The port stands without JAX, and its CUDA kernel agrees with its plain version.

- In a subprocess whose ``sys.meta_path`` refuses ``jax``/``jaxlib``, every
  module of the slice imports and ``extract_aperture_batch`` runs on a tiny
  ``SectorContext.from_arrays`` context on the CPU.
- No module of ``photometry_tpu_torch`` has an ``import jax`` statement.
- ``test_band_kernel_matches_plain_on_card`` needs a CUDA card (marker
  ``cuda``) and skips without one.  Run it on the card with
  ``python -m pytest --noconftest -m cuda tests/test_torch_import.py``
  (the repository's conftest.py imports JAX).
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one intra-op thread per test worker)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "photometry_tpu_torch")

_SCRIPT = r'''
import importlib.abc, sys, tempfile

class _NoJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError(f"jax is blocked: {name}")
        return None

sys.meta_path.insert(0, _NoJax())
import numpy as np
import torch

MODULES = ["photometry_tpu_torch", "photometry_tpu_torch.device",
           "photometry_tpu_torch.io.wcs", "photometry_tpu_torch.utils.mathutils",
           "photometry_tpu_torch.utils.logutils", "photometry_tpu_torch.ops.filters",
           "photometry_tpu_torch.ops.labeling", "photometry_tpu_torch.ops._kernels",
           "photometry_tpu_torch.ops.bandext", "photometry_tpu_torch.models.k2p2",
           "photometry_tpu_torch.core.metrics", "photometry_tpu_torch.core.motion",
           "photometry_tpu_torch.core.timecorr", "photometry_tpu_torch.core.engine",
           "photometry_tpu_torch.core.dispatcher", "photometry_tpu_torch.core.drain",
           "photometry_tpu_torch.cli.photometry_cmd"]
for m in MODULES:
    __import__(m)

from photometry_tpu.catalog import make_catalog_from_arrays
from photometry_tpu.core.status import STATUS
from photometry_tpu_torch.core.engine import SectorContext, extract_aperture_batch
from photometry_tpu_torch.io.wcs import TanWCS

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
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")]
print("OK", len(res))
'''


def test_slice_runs_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "OK 4" in proc.stdout


def _py_files():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_module_imports_jax():
    offenders = []
    for path in _py_files():
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            if any(n.split(".")[0] in ("jax", "jaxlib") for n in names):
                offenders.append(f"{os.path.relpath(path, ROOT)}:{node.lineno}")
    assert not offenders, offenders


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
