"""The last of the JAX package in the port: the tools, the offline cache and
download helpers, and the public functions the earlier slices left out.

Each case holds the port against the JAX package on the same seeded numpy
input, on the CPU:

- ``native_ops.bswap_crop_f32`` and ``moving_median_f32`` on the native
  library and on the numpy fallback, against the JAX binding and numpy;
- ``ops.filters.binary_dilation``, ``binary_erosion`` (both
  connectivities, 1 and 3 iterations) and ``fill_holes``, exact;
- ``ops.stats.kde_mode`` equal to JAX's, and within
  tests/test_ops_stats_filters.py's 0.15 of the density peak;
- ``models.k2p2.build_mask`` against JAX's ``build_mask`` (masks and the
  ``debug`` images exact, ``blurred`` to tests/test_torch_plots.py's
  bounds) and equal to its row of ``build_masks_batch``;
- ``MotionModel.jitter`` within 2e-5 px; ``ListHandler``; the quality
  flags' ``decode`` and ``binary_repr``; ``bicubic_coeffs``;
- ``download_cache``: Horizons exports (the shipped sample, verbose blocks
  in AU, a file without a data block) parsed to equal arrays,
  ``make_ephemeris`` as a module CLI, ``download_cache(testing=True)`` and
  its CLI in both packages, the URL branches through ``file://`` URLs,
  ``download_file``'s retries on a missing file and ``download_catalogs``;
- the tools on ``--device cpu`` at small sizes: ``profile_psf``'s JSON
  keys and ``profile_k2p2``'s stage names are the JAX tools' (read from
  their sources: the JAX profile compiles for half a minute),
  ``tiebreak_corpus_scale``'s summary equals the JAX tool's at 100 stamps,
  ``validate_prf`` gives the JAX tool's exit codes and deviations, and
  ``validate_ecc``'s corpus agrees with cv2 as tests/test_imagemotion.py
  requires.
"""

import ast
import configparser
import functools
import importlib.util
import io
import json
import logging
import os
import subprocess
import sys
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch

from photometry_tpu import catalog as jax_catalog
from photometry_tpu import download_cache as jax_dc
from photometry_tpu import native_ops as jax_native
from photometry_tpu.core.engine import DEFAULT_K2P2_PARAMS as JAX_K2P2
from photometry_tpu.core.motion import MotionModel as JaxMotion
from photometry_tpu.io import settings as jax_settings
from photometry_tpu.models.k2p2 import build_mask as jax_build_mask
from photometry_tpu.models.prf import PRF as JaxPRF
from photometry_tpu.ops import filters as jax_filters
from photometry_tpu.ops import stats as jax_stats
from photometry_tpu.quality import TESSQualityFlags as JaxFlags
from photometry_tpu.utils import downloads as jax_downloads
from photometry_tpu.utils.logutils import ListHandler as JaxListHandler
from photometry_tpu.utils.mathutils import np_moving_median_central
from photometry_tpu_torch import catalog, download_cache, native_ops
from photometry_tpu_torch.cli import download_cache_cmd
from photometry_tpu_torch.core.motion import MotionModel
from photometry_tpu_torch.io import settings
from photometry_tpu_torch.models.k2p2 import K2P2Params, build_mask, build_masks_batch
from photometry_tpu_torch.ops import filters, stats
from photometry_tpu_torch.ops.spline import bicubic_coeffs
from photometry_tpu_torch.quality import CorrectorQualityFlags, TESSQualityFlags
from photometry_tpu_torch.tools import (profile_k2p2, profile_psf, tiebreak_corpus_scale,
                                        validate_ecc, validate_prf)
from photometry_tpu_torch.utils import downloads
from photometry_tpu_torch.utils.logutils import ListHandler, capture_warnings
from torch_parity import n, t

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(ROOT, "photometry_tpu_torch", "data", "ephemeris",
                      "tess_horizons_sample.txt")


def _load_tool(name):
    """A JAX tool of ``tools/`` as a module (they are scripts, not a package)."""
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}",
                                                  os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _same_npz(a, b):
    with np.load(a) as x, np.load(b) as y:
        assert sorted(x.files) == sorted(y.files)
        for k in x.files:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


# --- native_ops ---------------------------------------------------------------

@pytest.fixture(params=["native", "fallback"])
def path_kind(request, monkeypatch):
    """Run a test on the native library, then on the numpy fallback."""
    if request.param == "fallback":
        monkeypatch.setattr(native_ops, "_load", lambda: None)
    else:
        assert native_ops.native_available()
    return request.param


def test_bswap_crop_f32(path_kind):
    img = np.random.default_rng(1).standard_normal((64, 80)).astype("<f4")
    raw = img.astype(">f4").tobytes()
    for box in ((10, 50, 4, 76), (0, 64, 0, 80), (63, 64, 79, 80)):
        got = native_ops.bswap_crop_f32(raw, 64, 80, *box)
        assert got.dtype == np.dtype("<f4")
        np.testing.assert_array_equal(got, img[box[0]:box[1], box[2]:box[3]])
        np.testing.assert_array_equal(got, jax_native.bswap_crop_f32(raw, 64, 80, *box))


def test_moving_median_f32(path_kind):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((40, 3, 7)).astype(np.float32)
    x[5, 1, 3] = np.nan
    x[:, 2, 2] = np.nan                        # an all-NaN pixel
    for w in (1, 3, 4, 9, 81):
        got = native_ops.moving_median_f32(x, w)
        assert got.dtype == np.float32 and got.shape == x.shape
        want = np_moving_median_central(x, w, axis=0).astype(np.float32)
        jax_got = jax_native.moving_median_f32(x, w)
        if path_kind == "fallback":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_array_equal(got, jax_got)   # the one library source
        np.testing.assert_allclose(got, want, atol=1e-6, equal_nan=True)
    np.testing.assert_array_equal(native_ops.moving_median_f32(x[:, 0, 0], 5),
                                  native_ops.moving_median_f32(x, 5)[:, 0, 0])


# --- ops and models -----------------------------------------------------------

@pytest.mark.parametrize("connectivity", [1, 2])
@pytest.mark.parametrize("iterations", [1, 3])
def test_binary_morphology(connectivity, iterations):
    rng = np.random.default_rng(10 * connectivity + iterations)
    for shape, p in (((20, 23), 0.4), ((9, 9), 0.8), ((1, 6), 0.5)):
        m = rng.uniform(size=shape) < p
        for ours, theirs in ((filters.binary_dilation, jax_filters.binary_dilation),
                             (filters.binary_erosion, jax_filters.binary_erosion)):
            got = ours(t(m), connectivity, iterations)
            assert got.dtype == torch.bool
            np.testing.assert_array_equal(n(got), n(theirs(m, connectivity, iterations)))
    stack = rng.uniform(size=(3, 12, 14)) < 0.5        # leading dimensions are a batch
    np.testing.assert_array_equal(
        n(filters.binary_dilation(t(stack), connectivity, iterations))[1],
        n(filters.binary_dilation(t(stack[1]), connectivity, iterations)))


def test_fill_holes():
    rng = np.random.default_rng(4)
    ring = np.zeros((15, 15), bool)
    ring[3:10, 3:10] = True
    ring[5:8, 5:8] = False                        # a hole
    spiral = np.ones((12, 12), bool)
    spiral[1:-1, 1:-1] = False
    spiral[2:-2, 2:-2] = True
    spiral[3:-3, 3:-3] = False
    spiral[1, 5] = True                           # the ring's gap closed: a deep hole
    for m in (ring, spiral, rng.uniform(size=(30, 30)) < 0.6, np.zeros((5, 5), bool)):
        for max_iters in (1, 256):
            got = filters.fill_holes(t(m), max_iters)
            np.testing.assert_array_equal(n(got), n(jax_filters.fill_holes(m, max_iters)))
    assert n(filters.fill_holes(t(ring)))[6, 6]


def test_kde_mode():
    rng = np.random.default_rng(2)
    # tests/test_ops_stats_filters.py's asymmetric sample: mode != mean != median
    x = np.concatenate([rng.normal(10.0, 0.5, 20000),
                        rng.normal(13.0, 2.0, 8000)]).astype(np.float32)
    mode = float(stats.kde_mode(t(x)))
    assert mode == pytest.approx(10.0, abs=0.15)
    x[::97] = np.nan
    mask = rng.uniform(size=x.shape) < 0.1
    for kw in ({}, {"mask": mask}, {"lo": 8.0, "hi": 14.0},
               {"n_buckets": 128, "smooth_sigma_frac": 0.03}):
        got = stats.kde_mode(t(x.reshape(4, -1)), **kw)
        assert got.ndim == 0
        assert float(got) == pytest.approx(float(jax_stats.kde_mode(x, **kw)), rel=1e-6), kw
    assert np.isnan(float(stats.kde_mode(t(np.full(8, np.nan, np.float32)))))
    # The same math as segment_kde_mode's one-segment case:
    seg = torch.zeros(x.size, dtype=torch.int32)
    assert float(stats.kde_mode(t(x))) == float(stats.segment_kde_mode(t(x), seg, 1)[0])


def test_bicubic_coeffs_and_quality_flags():
    g = np.random.default_rng(0).standard_normal((5, 6))
    got = bicubic_coeffs(g)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(n(got), g.astype(np.float32))
    for q in (0, 33, 4096 + 1024 + 2, 2 ** 31):
        assert TESSQualityFlags.decode(q) == JaxFlags.decode(q)
        assert TESSQualityFlags.binary_repr(q) == JaxFlags.binary_repr(q)
    arr = np.array([1, 5, 4096])
    np.testing.assert_array_equal(TESSQualityFlags.binary_repr(torch.as_tensor(arr)),
                                  JaxFlags.binary_repr(arr))
    assert TESSQualityFlags.HARD_BITMASK == JaxFlags.HARD_BITMASK
    assert CorrectorQualityFlags.decode(256) == ["Background Shenanigans detected in stamp"]


@pytest.fixture(scope="module")
def mask_stamps():
    """Six 21x21 stamps of the tie-break corpus, one with uncollected
    columns and one without flux."""
    arrays = tiebreak_corpus_scale.corpus(np.random.default_rng(1), 6)
    imgs = arrays[0].copy()
    imgs[4, :, :3] = np.nan
    imgs[5] = -np.abs(imgs[5]) * 1e-3
    return (imgs,) + arrays[1:5]


@pytest.mark.parametrize("segmentation", [True, False], ids=["watershed", "dbscan-only"])
def test_build_mask_matches_jax(mask_stamps, segmentation):
    imgs, cc, cr, ct, cv = mask_stamps
    jparams = JAX_K2P2._replace(segmentation=segmentation)
    params = K2P2Params(**jparams._asdict())
    sid = np.arange(1, cc.shape[1] + 1, dtype=np.int64)
    fn = jax.jit(functools.partial(jax_build_mask, params=jparams, debug=True))
    batch = build_masks_batch(t(imgs), t(cc), t(cr), t(ct), t(np.tile(sid, (6, 1))), t(cv),
                              t(cr[:, 0]), t(cc[:, 0]), t(ct[:, 0]), params=params, debug=True)
    for i in range(len(imgs)):
        args = (imgs[i], cc[i], cr[i], ct[i], sid, cv[i], cr[i, 0], cc[i, 0], ct[i, 0])
        want = fn(*args)
        got = build_mask(*(t(a) for a in args), params=params, debug=True)
        assert sorted(got) == sorted(want)
        for key in ("mask", "found_mask", "no_flux", "in_mask", "edge", "mask_size",
                    "above", "labels", "seg"):
            assert got[key].shape == want[key].shape, key
            np.testing.assert_array_equal(n(got[key]), n(want[key]), err_msg=f"{i} {key}")
        np.testing.assert_allclose(n(got["cut"]), n(want["cut"]), rtol=1e-5)
        np.testing.assert_allclose(n(got["blurred"]), n(want["blurred"]), rtol=1e-5, atol=1e-3,
                                   err_msg=f"stamp {i} blurred")
        for key in got:                         # the batch's row (NaN where it is NaN)
            np.testing.assert_array_equal(n(got[key]), n(batch[key][i]), err_msg=key)
    # A single stamp's collected-pixel map is passed through to the batch:
    coll = np.isfinite(imgs[4]) & (np.arange(21) < 18)[None, :]
    args = [t(a) for a in (imgs[4], cc[4], cr[4], ct[4], sid, cv[4], cr[4, 0], cc[4, 0],
                           ct[4, 0])]
    got = build_mask(*args, collected=t(coll), params=params)
    want = build_masks_batch(*(a[None] for a in args), collected=t(coll)[None], params=params)
    for key in got:
        np.testing.assert_array_equal(n(got[key]), n(want[key][0]), err_msg=key)


def test_motion_jitter_matches_jax():
    times = np.linspace(0.0, 10.0, 7)
    rng = np.random.default_rng(5)
    for mode, kern in (("translation", rng.normal(0, 0.3, (7, 2))),
                       ("euclidian", np.column_stack([rng.normal(0, 0.3, (7, 2)),
                                                      rng.normal(0, 1e-3, 7)])),
                       ("affine", np.tile([1.0, 0.0, 0.2, 0.0, 1.0, -0.1], (7, 1))
                        + rng.normal(0, 1e-3, (7, 6)))):
        ours, theirs = MotionModel(mode), JaxMotion(mode)
        ours.load_series(times, kern)
        theirs.load_series(times, kern)
        ev = np.linspace(-1.0, 11.0, 25)
        # Stamp-scale positions: the warps run in float32 in both packages,
        # and at CCD scale one ulp is 1.2e-4 px (tests/test_torch_metrics_
        # motion_wcs.py holds jitter_batch there to 5e-4).
        for col, row in ((10.0, 20.0), (90.5, 3.25)):
            got = ours.jitter(ev, col, row)
            assert got.shape == (25, 2) and got.dtype == np.float64
            np.testing.assert_allclose(got, theirs.jitter(ev, col, row), atol=2e-5)
            np.testing.assert_array_equal(got, ours.jitter_batch(ev, [col], [row])[:, 0])
    assert MotionModel("unchanged").jitter([1.0, 2.0], 3.0, 4.0).shape == (2, 2)


def test_list_handler():
    logger = logging.getLogger("test_torch_tools.list_handler")
    logger.propagate = False
    got, want = [], []
    for handler in (ListHandler(got), JaxListHandler(want)):
        logger.addHandler(handler)
    logger.info("dropped below WARNING")
    logger.warning("low flux in %d pixels", 3)
    logger.error("stamp\n")
    assert got == want == ["WARNING: low flux in 3 pixels", "ERROR: stamp"]
    with capture_warnings("photometry_tpu_torch") as queue:
        logging.getLogger("photometry_tpu_torch.x").warning("w")
    assert queue == ["WARNING: w"]


# --- download_cache, make_ephemeris, downloads, catalogs ----------------------

def test_horizons_to_ephemeris_matches_jax(tmp_path):
    jax_sample = os.path.join(ROOT, "photometry_tpu", "data", "ephemeris",
                              "tess_horizons_sample.txt")
    with open(SAMPLE, "rb") as a, open(jax_sample, "rb") as b:
        assert a.read() == b.read()
    got = download_cache.horizons_to_ephemeris(SAMPLE, output=str(tmp_path / "a.npz"),
                                               earth_source=SAMPLE)
    want = jax_dc.horizons_to_ephemeris(jax_sample, output=str(tmp_path / "b.npz"),
                                        earth_source=jax_sample)
    for key in ("time", "pos", "pos_earth"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key), err_msg=key)
    _same_npz(tmp_path / "a.npz", tmp_path / "b.npz")
    assert download_cache.AU_KM == jax_dc.AU_KM
    # Verbose blocks in AU (tests/test_cache_catalog_timecorr.py:68-93), and an
    # Earth export on another grid, interpolated onto the spacecraft's:
    text = """Output units    : AU-D
*******************************************************************************
$$SOE
2458324.500000000 = A.D. 2018-Jul-25 00:00:00.0000 TDB
 X = 5.000000000000000E-01 Y =-8.000000000000000E-01 Z = 1.000000000000000E-02
 VX= 1.0E-02 VY= 2.0E-03 VZ= 1.0E-04
2458325.500000000 = A.D. 2018-Jul-26 00:00:00.0000 TDB
 X = 5.100000000000000E-01 Y =-7.900000000000000E-01 Z = 1.100000000000000E-02
 VX= 1.0E-02 VY= 2.0E-03 VZ= 1.0E-04
$$EOE
"""
    src = tmp_path / "verbose.txt"
    src.write_text(text)
    earth = tmp_path / "earth.txt"
    earth.write_text(text.replace("2458325.5", "2458326.5"))
    for eph_src in (None, str(earth)):
        got = download_cache.horizons_to_ephemeris(str(src), earth_source=eph_src)
        want = jax_dc.horizons_to_ephemeris(str(src), earth_source=eph_src)
        np.testing.assert_array_equal(got.time, want.time)
        np.testing.assert_array_equal(got.pos, want.pos)
        np.testing.assert_array_equal(got.pos_earth, want.pos_earth)
    np.testing.assert_allclose(got.pos[0], np.array([0.5, -0.8, 0.01]) * download_cache.AU_KM)
    bad = tmp_path / "bad.txt"
    bad.write_text("no block here")
    empty = tmp_path / "empty.txt"
    empty.write_text("$$SOE\nnothing\n$$EOE\n")
    for path in (bad, empty):
        for fn in (download_cache.horizons_to_ephemeris, jax_dc.horizons_to_ephemeris):
            with pytest.raises(ValueError):
                fn(str(path))


def test_make_ephemeris_module_cli(tmp_path):
    out = str(tmp_path / "cli.npz")
    proc = subprocess.run([sys.executable, "-m", "photometry_tpu_torch.tools.make_ephemeris",
                           SAMPLE, "-o", out, "--earth", SAMPLE], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "samples" in proc.stdout and "Einstein" in proc.stdout
    want = str(tmp_path / "jax.npz")
    with redirect_stdout(io.StringIO()):
        assert _load_tool("make_ephemeris").main([SAMPLE, "-o", want, "--earth", SAMPLE]) == 0
    _same_npz(out, want)


@pytest.fixture
def no_urls(monkeypatch):
    """Neither package sees a download source, and both read fresh settings."""
    for var in ("PHOTOMETRY_TPU_EPHEMERIS_URL", "PHOTOMETRY_TPU_CATALOG_URL",
                "PHOTOMETRY_TPU_SETTINGS"):
        monkeypatch.delenv(var, raising=False)
    settings.load_settings.cache_clear()
    jax_settings.load_settings.cache_clear()
    yield monkeypatch
    settings.load_settings.cache_clear()
    jax_settings.load_settings.cache_clear()


def test_download_cache_offline_matches_jax(tmp_path, no_urls, capsys):
    no_urls.setenv("PHOTOMETRY_TPU_CACHE", str(tmp_path / "torch"))
    p = download_cache.download_cache(testing=True)
    assert p == download_cache.ephemeris_path() == str(tmp_path / "torch" /
                                                       "spacecraft_ephemeris.npz")
    eph = download_cache.load_cached_ephemeris()
    for s in (1, 27):
        assert eph.time[0] <= settings.sector_info(s).reference_time <= eph.time[-1]
    assert download_cache.download_cache() == p             # present: kept
    no_urls.setenv("PHOTOMETRY_TPU_CACHE", str(tmp_path / "jax"))
    _same_npz(p, jax_dc.download_cache(testing=True))
    # The CLI, in a cache of its own, against the JAX CLI's file:
    no_urls.setenv("PHOTOMETRY_TPU_CACHE", str(tmp_path / "cli"))
    assert download_cache_cmd.main(["--testing", "-q"]) == 0
    printed = capsys.readouterr().out.strip().splitlines()[-1]
    assert printed == str(tmp_path / "cli" / "spacecraft_ephemeris.npz")
    _same_npz(printed, p)
    # Without testing: the whole mission; the dispatcher's corrector reads it.
    no_urls.setenv("PHOTOMETRY_TPU_CACHE", str(tmp_path / "full"))
    eph = download_cache.load_cached_ephemeris()
    no_urls.setenv("PHOTOMETRY_TPU_CACHE", str(tmp_path / "full_jax"))
    want = jax_dc.load_cached_ephemeris()
    np.testing.assert_array_equal(eph.time, want.time)
    np.testing.assert_array_equal(eph.pos, want.pos)


def test_download_cache_url_branches(tmp_path, no_urls):
    from photometry_tpu.core.timecorr import SpacecraftEphemeris
    src = tmp_path / "published.npz"
    t_ = np.arange(2458300.0, 2458320.0, 0.5)
    SpacecraftEphemeris(time=t_, pos=np.stack([t_, t_ * 0 + 1e8, t_ * 0], 1)).save(str(src))
    # The environment variable:
    no_urls.setenv("PHOTOMETRY_TPU_EPHEMERIS_URL", src.as_uri())
    no_urls.setenv("PHOTOMETRY_TPU_CACHE", str(tmp_path / "env"))
    p = download_cache.download_cache()
    with open(p, "rb") as a, open(src, "rb") as b:
        assert a.read() == b.read()
    assert not os.path.exists(p + ".part")
    np.testing.assert_array_equal(download_cache.load_cached_ephemeris().time, t_)
    # The [timecorr] ephemeris_url settings key, read by both packages:
    no_urls.delenv("PHOTOMETRY_TPU_EPHEMERIS_URL")
    ini = tmp_path / "settings.ini"
    cfg = configparser.ConfigParser()
    cfg.read(os.path.join(settings.data_dir(), "settings.ini"))
    cfg.set("timecorr", "ephemeris_url", src.as_uri())
    with open(ini, "w") as fh:
        cfg.write(fh)
    no_urls.setenv("PHOTOMETRY_TPU_SETTINGS", str(ini))
    settings.load_settings.cache_clear()
    jax_settings.load_settings.cache_clear()
    for name, fn in (("torch", download_cache.download_cache),
                     ("jax", jax_dc.download_cache)):
        no_urls.setenv("PHOTOMETRY_TPU_CACHE", str(tmp_path / name))
        with np.load(fn()) as d:
            np.testing.assert_array_equal(d["time"], t_)


def test_download_file_retries_and_parallel(tmp_path, monkeypatch):
    slept = []
    monkeypatch.setattr(downloads.time, "sleep", slept.append)
    src = tmp_path / "src.bin"
    src.write_bytes(os.urandom(3 << 20))          # several 1 MiB reads
    dest = tmp_path / "sub" / "dest.bin"
    assert downloads.download_file(src.as_uri(), str(dest)) == str(dest)
    assert dest.read_bytes() == src.read_bytes() and not os.path.exists(str(dest) + ".part")
    # A missing file: three attempts, backoff 2 ** attempt, no partial file left.
    missing = (tmp_path / "missing.bin").as_uri()
    with pytest.raises(OSError, match="Could not download"):
        downloads.download_file(missing, str(tmp_path / "x.bin"))
    assert slept == [1.0, 2.0, 4.0]
    assert not os.path.exists(tmp_path / "x.bin") and not os.path.exists(tmp_path / "x.bin.part")
    slept.clear()
    with pytest.raises(OSError):
        downloads.download_file(missing, str(tmp_path / "y.bin"), retries=2, backoff=0.0)
    assert slept == [1.0, 0.0]
    # The JAX helper behaves the same:
    with pytest.raises(OSError, match="Could not download"):
        jax_downloads.download_file(missing, str(tmp_path / "z.bin"), retries=2, backoff=0.0)
    jobs = []
    for i in range(5):
        f = tmp_path / f"in{i}.txt"
        f.write_text(f"file {i}")
        jobs.append((f.as_uri(), str(tmp_path / "par" / f"out{i}.txt")))
    assert downloads.download_parallel(jobs, workers=3) == [d for _, d in jobs]
    assert [open(d).read() for _, d in jobs] == [f"file {i}" for i in range(5)]


def test_download_catalogs(tmp_path, no_urls):
    served = tmp_path / "served"
    served.mkdir()
    for cam, ccd in ((1, 1), (1, 2), (2, 1)):
        (served / catalog.catalog_filename(5, cam, ccd)).write_bytes(b"sqlite %d %d" % (cam, ccd))
    tpl = (served.as_uri() + "/catalog_sector{sector:03d}_camera{camera}_ccd{ccd}.sqlite")
    results = {}
    for name, fn in (("torch", catalog.download_catalogs), ("jax", jax_catalog.download_catalogs)):
        folder = tmp_path / name
        folder.mkdir()
        (folder / catalog.catalog_filename(5, 2, 2)).write_bytes(b"present")
        # No source: only what is there.
        assert fn(str(folder), 5, camera=2) == [str(folder / catalog.catalog_filename(5, 2, 2))]
        no_urls.setenv("PHOTOMETRY_TPU_CATALOG_URL", tpl)
        got = fn(str(folder), 5, camera=[1, 2], ccd=[1, 2])
        no_urls.delenv("PHOTOMETRY_TPU_CATALOG_URL")
        results[name] = [os.path.basename(p) for p in got]
        assert (folder / catalog.catalog_filename(5, 1, 2)).read_bytes() == b"sqlite 1 2"
        assert (folder / catalog.catalog_filename(5, 2, 2)).read_bytes() == b"present"
    assert results["torch"] == results["jax"] == [
        catalog.catalog_filename(5, c, d) for c, d in ((1, 1), (1, 2), (2, 1), (2, 2))]
    # The [catalog] url settings key; a template the server lacks raises.
    ini = tmp_path / "settings.ini"
    ini.write_text(f"[catalog]\nurl = {tpl}\n")
    no_urls.setenv("PHOTOMETRY_TPU_SETTINGS", str(ini))
    settings.load_settings.cache_clear()
    folder = tmp_path / "from_settings"
    folder.mkdir()
    assert len(catalog.download_catalogs(str(folder), 5, camera=1, ccd=[1, 2])) == 2
    no_urls.setattr(downloads.time, "sleep", lambda s: None)
    with pytest.raises(OSError):
        catalog.download_catalogs(str(folder), 5, camera=3, ccd=1)


# --- the tools ------------------------------------------------------------------

def _jax_json_keys(name):
    """The keys of the dict literal the JAX tool prints with json.dumps, with
    its nested literals' keys as "outer.inner"."""
    tree = ast.parse(open(os.path.join(ROOT, "tools", f"{name}.py")).read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "dumps"
                and isinstance(node.args[0], ast.Dict)):
            keys = []
            for k, v in zip(node.args[0].keys, node.args[0].values):
                keys.append(k.value)
                if isinstance(v, ast.Dict):
                    keys += [f"{k.value}.{kk.value}" for kk in v.keys]
            return keys
    raise AssertionError(f"no json.dumps of a dict literal in tools/{name}.py")


def test_profile_psf_on_cpu(capsys):
    summary, full, inp = profile_psf.profile(["--device", "cpu", "--chunk", "3", "--T", "5",
                                              "--reps", "1"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == summary
    keys = [key for k, v in summary.items()
            for key in [k] + ([f"{k}.{kk}" for kk in v] if isinstance(v, dict) else [])]
    assert keys == _jax_json_keys("profile_psf")
    assert summary["config"] == {"chunk": 3, "T": 5, "S": 4, "side": 13, "backend": "cpu"}
    assert all(summary[k] > 0 for k in ("full_s", "phase2_s", "render_all_s",
                                        "lm_algebra_1iter_s"))
    assert inp["imgs"].shape == (3, 5, 13, 13) and inp["imgs"].device.type == "cpu"
    assert full["flux"].shape == (3, 5) and torch.isfinite(full["flux"]).all()
    # The same seed draws the same problem:
    again = profile_psf.make_inputs(3, 5, 4, 13, "cpu")
    assert torch.equal(again["imgs"], inp["imgs"]) and torch.equal(again["p0"], inp["p0"])
    assert profile_psf.parse_args([]).device == "cuda"


def test_profile_k2p2_on_cpu(capsys):
    times = profile_k2p2.main(["--device", "cpu", "-n", "24", "--reps", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    tree = ast.parse(open(os.path.join(ROOT, "tools", "profile_k2p2.py")).read())
    jax_stages = [node.args[0].value for node in sorted(
        (node for node in ast.walk(tree)
         if isinstance(node, ast.Call) and getattr(node.func, "id", "") == "timed"),
        key=lambda node: node.lineno)]
    assert list(times) == jax_stages == [line[:34].rstrip() for line in lines]
    assert all(v > 0 for v in times.values())
    # The tool's batch is the JAX tool's: the same numpy draws.
    a = profile_k2p2.make_inputs(24, 17)
    assert a["imgs"].shape == (24, 17, 17) and a["cat_valid"].sum(1).min() >= 1


def test_tiebreak_corpus_scale_matches_jax():
    pytest.importorskip("sklearn")
    jt = _load_tool("tiebreak_corpus_scale")
    with redirect_stdout(io.StringIO()):
        got = tiebreak_corpus_scale.main(["100", "--device", "cpu"])
        want = jt.main(["100", "--jax-platform", "cpu"])
    assert got == want
    assert got["single_star"]["stamps"] + got["multi_star"]["stamps"] <= 100
    # The port's copy of the corpus and the reference composition:
    tb = jt._load_corpus_module()
    tb.N_STAMPS = 8
    want_arrays = tb._corpus(np.random.default_rng(3))
    got_arrays = tiebreak_corpus_scale.corpus(np.random.default_rng(3), 8)
    for a, b in zip(got_arrays, want_arrays):
        np.testing.assert_array_equal(a, b)
    imgs, cc, cr, ct, cv = got_arrays[:5]
    for i in range(8):
        args = (imgs[i], 20.0, cc[i], cr[i], ct[i], cv[i], cr[i, 0], cc[i, 0])
        for ours, theirs in ((tiebreak_corpus_scale.flood_watershed, tb._flood_watershed),
                             (tiebreak_corpus_scale.flood_watershed_lifo,
                              jt._flood_watershed_lifo)):
            m_ours, f_ours = tiebreak_corpus_scale.ref_mask(*args, flood=ours)
            orig = tb._flood_watershed
            tb._flood_watershed = theirs
            try:
                m_want, f_want = tb._ref_mask(*args)
            finally:
                tb._flood_watershed = orig
            np.testing.assert_array_equal(m_ours, m_want)
            assert f_ours == f_want


@pytest.fixture(scope="module")
def prf_mat(tmp_path_factory):
    """A two-Gaussian PRF in the TESS .mat layout (tests/test_torch_psf.py's)."""
    path = str(tmp_path_factory.mktemp("prf") / "tess-t-1-1-characterized-prf.mat")
    offs = np.arange(-72, 73) / 9
    g = sum(a * np.exp(-0.5 * (offs[:, None] ** 2 + offs[None, :] ** 2) / s ** 2)
            for a, s in ((0.7, 1.1), (0.3, 2.0)))
    JaxPRF.write_mat(path, [g / (g.sum() / 81)], [1024.0], [1024.0])
    return path


@pytest.mark.parametrize("tol", ["2e-3", "1e-9"])
def test_validate_prf_matches_jax(prf_mat, tol, monkeypatch):
    argv = [prf_mat, "--stamp", "0", "11", "0", "11", "--tol", tol]
    renders = []
    real = JaxPRF.integrate_to_image

    def recording(self, *a, **kw):
        out = real(self, *a, **kw)
        renders.append(np.asarray(out))
        return out

    monkeypatch.setattr(JaxPRF, "integrate_to_image", recording)
    out = io.StringIO()
    with redirect_stdout(out):
        want_rc = _load_tool("validate_prf").main(argv + ["--jax-platform", "cpu"])
        got_rc = validate_prf.main(argv + ["--device", "cpu"])
        rep = validate_prf.validate(validate_prf.parse_args(argv + ["--device", "cpu"]))
    assert got_rc == want_rc == (0 if tol == "2e-3" else 1)
    lines = out.getvalue().splitlines()
    assert lines[0] == lines[3]                   # the SVD report of the same table
    peak = rep["want"].max()
    jax_dev = float(np.abs(renders[-1] - rep["want"]).max() / peak)
    assert rep["dev"] == pytest.approx(jax_dev, rel=1e-6)
    assert 0 < rep["dev"] < 2e-3 and rep["flux_err"] < 1e-3


def test_validate_ecc_against_cv2():
    pytest.importorskip("cv2")
    rows = validate_ecc.run_corpus(verbose=False, device="cpu")
    noiseless = [r for r in rows if r["noise"] == 0]
    noisy = [r for r in rows if r["noise"] > 0]
    assert len(rows) == 18
    assert max(r["max_delta"] for r in noiseless) < 0.01, noiseless
    lowdim = [r for r in noisy if r["mode"] in ("translation", "euclidian")]
    assert max(r["delta_translation"] for r in lowdim) < 0.01, lowdim
    aff = [r for r in noisy if r["mode"] == "affine"]
    assert max(abs(r["obj_delta"]) for r in aff) < 1e-4, aff
    assert max(r["delta_translation"] for r in aff) < 0.05, aff
    # The corpus is the JAX tool's:
    ve = _load_tool("validate_ecc")
    for case in range(len(ve.CASES)):
        np.testing.assert_array_equal(validate_ecc.starfield(seed=3 + case, noise=2.0),
                                      ve.starfield(seed=3 + case, noise=2.0))
    M = np.array([[1.0, 0.01, 0.4], [-0.01, 1.0, -0.2]])
    ref, img = validate_ecc.starfield(), validate_ecc.starfield(shift=(0.4, -0.2))
    assert validate_ecc.ecc_objective(ref, img, M) == ve.ecc_objective(ref, img, M)
