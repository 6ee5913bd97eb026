"""Port parity of the simulator, the host modules of the chain, and the chain
itself, on the CPU.

- ``sim.simulator``: three configurations (random field with TPFs at 120 s
  and 20 s, an explicit star list written raw-geometry, a noiseless sector
  of another camera and CCD): every truth array equal to the JAX
  simulator's, and the FFIs, TPFs and catalog written byte-equal.
- ``io.wcs.fit_tan_wcs`` and ``TanWCS.pixel_scale`` (float64, 1e-12
  relative), the full ``TimeCorrector`` (1e-12 days), ``core.metrics
  .compute_metrics`` (rtol 1e-4, tests/test_torch_metrics_motion_wcs.py's),
  ``io.fits.verify_checksums`` (equal results), ``utils.profiling`` and
  ``version``.
- The chain through the CLIs of each package on the same FFIs: simulate
  -> prepare -> todo -> photometry --all -> todo_merge.  Todo rows,
  statuses, methods and the merged file exact.  Each package prepares its
  own cube, and the cubes agree to the prepare stage's tolerance (rtol 1e-3
  + atol 0.05 e-/s, tests/test_torch_prepare.py), which the fluxes inherit
  summed over the aperture.  The port's photometry on the JAX package's
  cube holds the photometry tolerances: products to the extraction
  tolerance (tests/test_bandext.py:41), diagnostics to the slice's
  (tests/test_torch_slice.py): positions and fluxes rtol 1e-4, the
  variability metrics rtol 1e-4 plus a 1e-6 perturbation of rel.
- The port's fuzz harness, one iteration on the CPU: no violation but the
  reference-faithful ``I2_ref_faithful_errors``.
"""

import glob
import os
import shutil
import sqlite3

import h5py
import jax.numpy as jnp
import numpy as np
import pytest

from torch_parity import ATOL, RTOL, n, t

from photometry_tpu.cli import photometry_cmd as jax_photometry_cmd
from photometry_tpu.cli import prepare_cmd as jax_prepare_cmd
from photometry_tpu.cli import todo_cmd as jax_todo_cmd
from photometry_tpu.cli import todo_merge_cmd as jax_todo_merge_cmd
from photometry_tpu.core import dispatcher as jax_dispatcher
from photometry_tpu.core.metrics import compute_metrics as jax_compute_metrics
from photometry_tpu.core.timecorr import SpacecraftEphemeris as JaxEphemeris
from photometry_tpu.core.timecorr import TimeCorrector as JaxTimeCorrector
from photometry_tpu.io import fits as jax_fits
from photometry_tpu.io.wcs import fit_tan_wcs as jax_fit_tan_wcs
from photometry_tpu.sim import simulator as jax_sim
from photometry_tpu.utils import profiling as jax_profiling
from photometry_tpu import version as jax_version

from photometry_tpu_torch import version
from photometry_tpu_torch.cli import photometry_cmd, prepare_cmd, simulate_cmd, todo_cmd
from photometry_tpu_torch.cli import todo_merge_cmd
from photometry_tpu_torch.core import dispatcher
from photometry_tpu_torch.core.metrics import compute_metrics
from photometry_tpu_torch.core.status import STATUS
from photometry_tpu_torch.core.timecorr import SpacecraftEphemeris, TimeCorrector
from photometry_tpu_torch.io import fits as pf
from photometry_tpu_torch.io.wcs import TanWCS, fit_tan_wcs
from photometry_tpu_torch.sim import simulator
from photometry_tpu_torch.tools import fuzz_e2e
from photometry_tpu_torch.utils import profiling
from photometry_tpu_torch.utils.mathutils import MAD_TO_SIGMA
from test_torch_slice import DREL

CONFIGS = {
    "random_tpfs": dict(shape=(64, 48), n_times=8, n_stars=14, seed=3),
    "stars_raw": dict(shape=(40, 40), n_times=2, seed=8, stars=((10.5, 12.0, 9.0),
                                                               (30.2, 25.7, 7.5),
                                                               (20.0, 20.0, 12.0))),
    "noiseless": dict(sector=27, camera=1, ccd=4, shape=(48, 64), n_times=12, n_stars=9,
                      noise=False, variable_fraction=1.0, seed=12),
}


def _files(d):
    return sorted(os.listdir(d))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_simulator_matches_jax(tmp_path, name):
    kw = CONFIGS[name]
    got = simulator.simulate_sector(simulator.SimConfig(**kw))
    want = jax_sim.simulate_sector(jax_sim.SimConfig(**kw))
    for field in ("time", "cadenceno", "quality", "images", "uncert", "bkg_true", "starid",
                  "ra_j2000", "dec_j2000", "pm_ra", "pm_dec", "tmag", "row_ref", "col_ref",
                  "flux_true", "jitter"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    assert got.header == want.header
    for attr in ("crpix", "crval", "cd"):
        np.testing.assert_array_equal(getattr(got.wcs, attr), getattr(want.wcs, attr))
    for sim, side in ((got, "torch"), (want, "jax")):
        d = str(tmp_path / side)
        sim.write_ffis(d, raw_geometry=name == "stars_raw", gzip=name != "noiseless")
        sim.write_catalog(d)
        if name == "random_tpfs":
            sim.write_tpf(d, int(sim.starid[0]), n_times=30)
            sim.write_tpf(d, int(sim.starid[3]), stamp=(13, 9), cadence=20, n_times=50,
                          gzip=False)
    names = _files(str(tmp_path / "torch"))
    assert names == _files(str(tmp_path / "jax"))
    assert len(names) == kw["n_times"] + 1 + 2 * (name == "random_tpfs")
    for f in names:
        with open(tmp_path / "torch" / f, "rb") as a, open(tmp_path / "jax" / f, "rb") as b:
            assert a.read() == b.read(), f


def test_simulate_cmd(tmp_path):
    d = str(tmp_path / "sim")
    argv = ["-q", "-s", "6", "-t", "3", "--shape", "32", "--tpf", "1", "--seed", "4", d]
    assert simulate_cmd.main(argv) == 0
    want = jax_sim.simulate_sector(jax_sim.SimConfig(shape=(32, 32), n_times=3, n_stars=6,
                                                     seed=4))
    want.write_ffis(str(tmp_path / "jax"))
    want.write_catalog(str(tmp_path / "jax"))
    want.write_tpf(str(tmp_path / "jax"), int(want.starid[0]))
    assert _files(d) == _files(str(tmp_path / "jax"))
    for f in _files(d):
        with open(os.path.join(d, f), "rb") as a, open(tmp_path / "jax" / f, "rb") as b:
            assert a.read() == b.read(), f


@pytest.mark.parametrize("noise", [0.0, 1e-3])
def test_fit_tan_wcs_and_pixel_scale(noise):
    rng = np.random.default_rng(2)
    truth = TanWCS(crpix=[1024.5, 1000.5], crval=[83.6, -27.3],
                   cd=[[-5.8e-3, 1.1e-4], [9.0e-5, 5.8e-3]])
    x, y = rng.uniform(1, 2048, 40), rng.uniform(1, 2048, 40)
    ra, dec = truth.pixel_to_world(x, y)
    x, y = x + rng.normal(0, noise, 40), y + rng.normal(0, noise, 40)
    got, want = fit_tan_wcs(x, y, ra, dec), jax_fit_tan_wcs(x, y, ra, dec)
    for attr in ("crpix", "crval", "cd"):
        np.testing.assert_allclose(getattr(got, attr), getattr(want, attr), rtol=1e-12,
                                   atol=0, err_msg=attr)
    assert got.pixel_scale == pytest.approx(want.pixel_scale, rel=1e-12)
    assert got.pixel_scale == pytest.approx(truth.pixel_scale, rel=1e-6 + noise)
    xx, yy = got.world_to_pixel(ra, dec)
    assert np.abs(xx - x).max() < 1e-6 + 5 * noise and np.abs(yy - y).max() < 1e-6 + 5 * noise
    with pytest.raises(ValueError):
        fit_tan_wcs(x[:3], y[:3], ra[:3], dec[:3])


@pytest.mark.parametrize("earth", [True, False])
def test_time_corrector_matches_jax(earth):
    eph, jeph = (SpacecraftEphemeris.synthetic(2458320.0, 2458360.0),
                 JaxEphemeris.synthetic(2458320.0, 2458360.0))
    if not earth:
        eph.pos_earth = jeph.pos_earth = None
    tc, jtc = TimeCorrector(eph), JaxTimeCorrector(jeph)
    rng = np.random.default_rng(6)
    btjd = 1325.3 + np.sort(rng.uniform(0, 27, 200))
    jd = btjd + 2457000.0
    ra, dec = rng.uniform(0, 360, 5), rng.uniform(-89, 89, 5)
    np.testing.assert_allclose(tc.position(jd), jtc.position(jd), rtol=1e-12)
    for a, b in zip(tc.position_velocity(jd), jtc.position_velocity(jd)):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-9)
    assert tc.time_coverage() == jtc.time_coverage()
    np.testing.assert_array_equal(tc.sclk2jd([0.0, 8.64e4, 1.5e8]),
                                  jtc.sclk2jd([0.0, 8.64e4, 1.5e8]))
    for a, b in zip(tc.apply(btjd, ra[0], dec[0]), jtc.apply(btjd, ra[0], dec[0])):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    for r, d_ in ((ra, dec), (ra[1], dec[1])):
        for btjd_ in (True, False):
            times = btjd if btjd_ else jd
            got = tc.barycentric_correction_full(times, r, d_, btjd=btjd_)
            want = jtc.barycentric_correction_full(times, r, d_, btjd=btjd_)
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    # Shapiro and Einstein terms: microseconds, beside a Rømer delay of minutes.
    extra = tc.barycentric_correction_full(btjd, ra, dec) - tc.barycentric_correction(btjd, ra, dec)
    assert 0 < np.abs(extra).max() * 86400 < 1e-3


def test_compute_metrics_matches_jax():
    rng = np.random.default_rng(3)
    T = 96
    time = (1325.3 + np.arange(T) / 48.0).astype(np.float32)
    flux = (1e4 * (1 + 0.01 * np.sin(time * 2)) + rng.normal(0, 30, T)).astype(np.float32)
    flux[5] = np.nan
    ferr = np.full(T, 30.0, np.float32)
    quality = np.zeros(T, np.int32)
    quality[10] = 1
    cent = np.stack([50 + rng.normal(0, 0.1, T), 60 + rng.normal(0, 0.1, T)], -1).astype(np.float32)
    arrs = (time, flux, ferr, quality, cent)
    want = jax_compute_metrics(*[jnp.asarray(a) for a in arrs])
    got = compute_metrics(*[t(a) for a in arrs])
    assert got.keys() == want.keys()
    for k in want:
        assert n(got[k]).shape == np.asarray(want[k]).shape, k
        np.testing.assert_allclose(n(got[k]), np.asarray(want[k]), rtol=1e-4, err_msg=k)


def test_verify_checksums_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    hdus = [pf.PrimaryHDU(None), pf.ImageHDU(rng.normal(size=(20, 30)).astype(np.float32),
                                             name="IMG"),
            pf.BinTableHDU({"A": np.arange(7, dtype=np.int32), "B": rng.normal(size=7)},
                           name="TAB")]
    paths = {}
    for gz in (False, True):
        p = str(tmp_path / ("f.fits.gz" if gz else "f.fits"))
        pf.write_fits(p, hdus)
        paths[gz] = p
        got = pf.verify_checksums(p)
        assert got == jax_fits.verify_checksums(p)
        assert got == [{"checksum_ok": True, "datasum_ok": True}] * 3
    raw = bytearray(open(paths[False], "rb").read())
    raw[2880 * 2 + 100] ^= 0xFF                       # a byte of the image's data
    bad = str(tmp_path / "bad.fits")
    open(bad, "wb").write(bytes(raw))
    got = pf.verify_checksums(bad)
    assert got == jax_fits.verify_checksums(bad)
    assert got[1] == {"checksum_ok": False, "datasum_ok": False} and got[0]["checksum_ok"]
    plain = str(tmp_path / "plain.fits")
    pf.write_fits(plain, hdus, checksum=False)
    assert pf.verify_checksums(plain) == [{"checksum_ok": None, "datasum_ok": None}] * 3


def test_profiling_and_version(tmp_path, monkeypatch):
    timers = []
    for mod in (profiling, jax_profiling):
        st = mod.StageTimer()
        for name in ("a", "b", "a"):
            with st.stage(name):
                pass
        timers.append((sorted(st.timings), sorted(st.as_details())))
    assert timers[0] == timers[1] == (["a", "b"], ["time_a", "time_b"])
    with profiling.device_trace():                 # no directory: nothing written
        pass
    monkeypatch.setenv("PHOTOMETRY_TPU_TRACE_DIR", str(tmp_path / "trace"))
    with profiling.device_trace():
        import torch
        torch.ones(4).sum()
    traces = glob.glob(str(tmp_path / "trace" / "trace_*.json"))
    assert len(traces) == 1 and os.path.getsize(traces[0]) > 0
    assert version.__version__ == jax_version.__version__
    assert version.get_version().split(" ")[0] == jax_version.get_version().split(" ")[0]
    assert version.get_version(pep440=True).startswith(version.__version__)


# --- the chain through the CLIs -------------------------------------------------

@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """One sector (FFIs, catalog, two TPFs: the brightest star's and that of
    the star with the nearest neighbour, a secondary in its stamp) simulated
    by the port, then each package's CLIs on its own copy: prepare, todo,
    photometry --all; and the port's todo and photometry CLIs once more on a
    copy of the JAX package's prepared folder ("torch_on_jax"), so that its
    photometry reads the same cube as the JAX package's."""
    root = tmp_path_factory.mktemp("chain")
    src = str(root / "src")
    sim = simulator.simulate_sector(simulator.SimConfig(shape=(96, 96), n_times=12, n_stars=16,
                                                        seed=21, tmag_range=(7.5, 13.0)))
    sim.write_ffis(src)
    sim.write_catalog(src)
    dist = np.hypot(sim.row_ref[:, None] - sim.row_ref, sim.col_ref[:, None] - sim.col_ref)
    np.fill_diagonal(dist, np.inf)
    for i in {0, int(np.argmin(dist.min(axis=1)))}:
        sim.write_tpf(src, int(sim.starid[i]), n_times=40)
    t0 = float(sim.time[0]) + 2457000.0
    dirs = {side: str(root / side) for side in ("jax", "torch", "torch_on_jax")}
    port = ["--device", "cpu"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_dispatcher, "default_time_corrector",
                   lambda: JaxTimeCorrector(JaxEphemeris.synthetic(t0 - 5, t0 + 10)))
        mp.setattr(dispatcher, "default_time_corrector",
                   lambda: TimeCorrector(SpacecraftEphemeris.synthetic(t0 - 5, t0 + 10)))
        for side, (prep, todo, phot), dev in (
                ("jax", (jax_prepare_cmd, jax_todo_cmd, jax_photometry_cmd), []),
                ("torch", (prepare_cmd, todo_cmd, photometry_cmd), port)):
            d = dirs[side]
            shutil.copytree(src, d)
            assert prep.main(["-q"] + dev + [d]) == 0
            if side == "jax":
                shutil.copytree(d, dirs["torch_on_jax"])
            assert todo.main(["-q", d]) == 0
            assert phot.main(["-q", "--all", "--version", "5"] + dev + [d]) == 0
        d = dirs["torch_on_jax"]
        assert todo_cmd.main(["-q", d]) == 0
        assert photometry_cmd.main(["-q", "--all", "--version", "5"] + port + [d]) == 0
    return sim, dirs


def _todo_rows(d):
    with sqlite3.connect(os.path.join(d, "todo.sqlite")) as conn:
        return conn.execute("SELECT * FROM todolist ORDER BY priority").fetchall()


def _diagnostics(d):
    """Diagnostics rows by priority, product paths relative to ``d``, and the
    products' light curves."""
    with sqlite3.connect(os.path.join(d, "todo.sqlite")) as conn:
        conn.row_factory = sqlite3.Row
        rows = {r["priority"]: dict(r) for r in conn.execute("SELECT * FROM diagnostics")}
    for r in rows.values():
        if r["lightcurve"]:
            path = os.path.join(d, r["lightcurve"])
            r["lightcurve"] = os.path.relpath(path, d)
            r["lc"] = pf.read_fits(path)[1].data
    return rows


_LABELS = ("lightcurve", "method_used", "mask_size", "stamp_width", "stamp_height",
           "stamp_resizes", "errors")


@pytest.mark.parametrize("side", ["torch", "torch_on_jax"])
def test_chain_todo_and_statuses_exact(chain, side):
    """Todo rows, statuses and methods exact on either cube; on the same
    cube, every label of the diagnostics too (masks are thresholds of the
    cube's sum image, which on the port's own cube may move a pixel)."""
    sim, dirs = chain
    rows = _todo_rows(dirs[side])
    assert rows == _todo_rows(dirs["jax"])
    sources = {r[3].split(":")[0] for r in rows}
    assert sources == {"ffi", "tpf"} and any(":" in r[3] for r in rows)
    assert all(r[9] is not None for r in rows)                        # every task drained
    good = (STATUS.OK.value, STATUS.WARNING.value, STATUS.SKIPPED.value)
    assert sum(r[9] in good for r in rows) >= 0.9 * len(rows)
    want, got = _diagnostics(dirs["jax"]), _diagnostics(dirs[side])
    assert got.keys() == want.keys()
    labels = _LABELS if side == "torch_on_jax" else ("lightcurve", "method_used")
    for prio, w in want.items():
        assert [got[prio][k] for k in labels] == [w[k] for k in labels], prio


def test_chain_photometry_matches_jax(chain):
    """The port's photometry on the JAX package's cube: products to the
    extraction tolerance, diagnostics to the slice's: rtol 1e-4 plus the
    effect of a DREL perturbation of every cadence's rel = flux / median - 1
    (binned means move by DREL, so rms_hour, 1.4826 times their median
    absolute deviation, by 2 * 1.4826 * DREL; ptp, a median of differences,
    by 2 * DREL; the variance by 2 * std * DREL; the variability by 2 *
    DREL over the median relative error)."""
    sim, dirs = chain
    want, got = _diagnostics(dirs["jax"]), _diagnostics(dirs["torch_on_jax"])
    n_lc = 0
    for prio, w in want.items():
        g = got[prio]
        if w["lightcurve"] is None:
            continue
        n_lc += 1
        for k in ("FLUX_RAW", "FLUX_RAW_ERR", "FLUX_BKG", "MOM_CENTR1", "MOM_CENTR2"):
            np.testing.assert_allclose(g["lc"][k], w["lc"][k], rtol=RTOL, atol=ATOL,
                                       equal_nan=True, err_msg=f"{prio} {k}")
        for k in ("TIME", "QUALITY", "PIXEL_QUALITY"):
            np.testing.assert_array_equal(g["lc"][k], w["lc"][k], err_msg=f"{prio} {k}")
        for k in ("mean_flux", "pos_row", "pos_column", "contamination", "edge_flux"):
            if w[k] is not None:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=f"{prio} {k}")
        std = np.sqrt(w["variance"])
        rel_err = np.nanmedian(w["lc"]["FLUX_RAW_ERR"]) / abs(w["mean_flux"])
        for k, atol in (("rms_hour", 2 * MAD_TO_SIGMA * DREL), ("ptp", 2 * DREL),
                        ("variance", 2 * std * DREL), ("variability", 2 * DREL / rel_err)):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=atol, err_msg=f"{prio} {k}")
    assert n_lc >= 0.9 * len(want)


def test_chain_cube_and_fluxes_within_prepare_tolerance(chain):
    """The port's own cube against the JAX package's at the prepare stage's
    tolerance (rtol 1e-3 + atol 0.05 e-/s, tests/test_torch_prepare.py);
    where a target's mask is the same on both cubes, its fluxes on the
    port's cube against those on the JAX cube at that tolerance summed over
    the mask's pixels."""
    sim, dirs = chain
    with h5py.File(os.path.join(dirs["torch"], "sector001_camera3_ccd2.hdf5"), "r") as a, \
            h5py.File(os.path.join(dirs["jax"], "sector001_camera3_ccd2.hdf5"), "r") as b:
        for k in ("images", "backgrounds"):
            np.testing.assert_allclose(np.nan_to_num(a[k][:]), np.nan_to_num(b[k][:]),
                                       rtol=1e-3, atol=0.05, err_msg=k)
        np.testing.assert_array_equal(a["images_err"][:], b["images_err"][:])
    own, other = _diagnostics(dirs["torch"]), _diagnostics(dirs["torch_on_jax"])
    same = [p for p, w in other.items() if w["lightcurve"] is not None
            and own[p]["mask_size"] == w["mask_size"]]
    assert len(same) >= 0.9 * sum(w["lightcurve"] is not None for w in other.values())
    for prio in same:
        w = other[prio]
        atol = 0.05 * w["mask_size"]
        for k in ("FLUX_RAW", "FLUX_BKG"):
            np.testing.assert_allclose(own[prio]["lc"][k], w["lc"][k], rtol=1e-3, atol=atol,
                                       equal_nan=True, err_msg=f"{prio} {k}")
        np.testing.assert_allclose(own[prio]["mean_flux"], w["mean_flux"], rtol=1e-3,
                                   atol=atol, err_msg=f"{prio} mean_flux")


def test_chain_merge_matches_jax(chain, tmp_path):
    """todo_merge_cmd of each package on its own drained todo list and a
    corrections file derived from it as test_todo_merge derives one."""
    sim, dirs = chain
    merged = {}
    for side, main in (("jax", jax_todo_merge_cmd.main), ("torch", todo_merge_cmd.main)):
        todo = os.path.join(dirs[side], "todo.sqlite")
        derived = str(tmp_path / f"{side}-corr.sqlite")
        shutil.copy(todo, derived)
        with sqlite3.connect(derived) as conn:
            conn.execute("ALTER TABLE todolist ADD COLUMN corr_status INTEGER DEFAULT NULL;")
            conn.execute("UPDATE todolist SET corr_status=status;")
            conn.execute("CREATE TABLE diagnostics_corr (priority INTEGER PRIMARY KEY, "
                         "lightcurve TEXT);")
            conn.execute("INSERT INTO diagnostics_corr SELECT priority, lightcurve "
                         "FROM diagnostics;")
            conn.execute("UPDATE todolist SET status=4 WHERE priority=2;")
        out = str(tmp_path / f"{side}-merged.sqlite")
        assert main(["-q", todo, derived, out]) == 0
        with sqlite3.connect(out) as conn:
            rows = conn.execute("SELECT * FROM todolist ORDER BY priority").fetchall()
            corr = conn.execute("SELECT priority, lightcurve FROM diagnostics_corr "
                                "ORDER BY priority").fetchall()
        merged[side] = (rows, [(p, os.path.relpath(lc, dirs[side]) if lc else lc)
                               for p, lc in corr])
    assert merged["torch"] == merged["jax"]
    rows, corr = merged["torch"]
    assert rows[1][-1] is None and all(r[-1] == r[9] for r in rows if r[0] != 2)
    assert [r[0] for r in corr] == [r[0] for r in rows if r[-1] is not None]


def test_fuzz_harness_one_iteration():
    cfg = fuzz_e2e.draw_config(np.random.default_rng(0), 0)
    viol, stats = fuzz_e2e.run_one(0, cfg, device="cpu")
    assert {v["kind"] for v in viol} <= {"I2_ref_faithful_errors"}, viol
    assert stats["n_tasks"] > 0 and stats["n_lc"] > 0 and stats["n_truth_checked"] > 0
