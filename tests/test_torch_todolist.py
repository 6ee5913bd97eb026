"""Port parity of the todo list and the task manager's queue calls, on the CPU.

Mirrors tests/test_taskmanager_todolist.py.  One sector folder holds a cube
written by the JAX package's prepare stage, its catalog, two TPFs whose
stamps overlap (two stars lie in both, so each is a secondary of both, and
each primary lies in the other's stamp) and a star of Tmag 1.8; both
packages' ``data_dir`` point at one folder whose exclusion and method
tables are not empty.  ``make_todo`` of both packages must write the same
rows, row for row (floats exact: both put stars on silicon with the same
float64 WCS), and the same schema and indexes.  ``calc_cbv_area`` and
``edge_distance`` must be exact.  The numpy host helpers of
``utils.mathutils`` are held to the JAX package's (jnp in float32 there:
float32 tolerances, stated in the test).
"""

import os
import shutil
import sqlite3

import h5py
import numpy as np
import pytest

import torch_parity  # noqa: F401  (one intra-op thread per test worker)

from photometry_tpu import taskmanager as jax_taskmanager
from photometry_tpu import todolist as jax_todolist
from photometry_tpu.cli import todo_cmd as jax_todo_cmd
from photometry_tpu.prepare import prepare_photometry
from photometry_tpu.sim.simulator import SimConfig, simulate_sector

from photometry_tpu_torch import taskmanager, todolist
from photometry_tpu_torch.cli import todo_cmd

#: (row, col, tmag) of the fixed stars: two TPF primaries 4-5 px apart, two
#: stars inside both their 11x11 stamps, and one star of Tmag 1.8.
FIXED = [(40.0, 40.0, 8.0), (44.0, 45.0, 8.5), (42.3, 42.6, 12.0), (41.0, 44.0, 11.5),
         (70.0, 20.0, 1.8)]


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_todo")
    d = str(root / "sector")
    rng = np.random.default_rng(31)
    stars = FIXED + list(zip(rng.uniform(4, 92, 20), rng.uniform(4, 92, 20),
                             rng.uniform(6.0, 14.0, 20)))
    sim = simulate_sector(SimConfig(shape=(96, 96), n_times=8, stars=tuple(stars), seed=31))
    sim.write_ffis(d)
    sim.write_catalog(d)

    def sid(row, col):
        return int(sim.starid[np.argmin(np.hypot(sim.row_ref - row, sim.col_ref - col))])

    ids = {k: sid(r, c) for k, (r, c, _) in zip("ABCDE", FIXED)}
    for k in "AB":
        sim.write_tpf(d, ids[k], n_times=20)
    prepare_photometry(d)
    # Exclusion and method tables: one random FFI star excluded, C forced to
    # psf in the FFIs, D to linpsf as a TPF target (it is a secondary there):
    tables = str(root / "data")
    os.makedirs(tables)
    excluded = int(sim.starid[-1])
    with open(os.path.join(tables, "todolist-exclude.dat"), "w") as fh:
        fh.write(f"# starid sector datasource data_rel\n{excluded} 1 ffi 99\n")
    with open(os.path.join(tables, "todolist-methods.dat"), "w") as fh:
        fh.write(f"# starid sector datasource method\n{ids['C']} 1 ffi PSF\n"
                 f"{ids['D']} 1 tpf linpsf\n")
    return sim, d, tables, ids, excluded


def _dump(path):
    """Every row of every table, and the schema, of a SQLite file."""
    with sqlite3.connect(path) as conn:
        schema = conn.execute("SELECT type, name, tbl_name, sql FROM sqlite_master "
                              "ORDER BY type, name").fetchall()
        tables = [r[1] for r in schema if r[0] == "table"]
        rows = {t: conn.execute(f"SELECT * FROM {t} ORDER BY rowid").fetchall() for t in tables}
    return schema, rows


def _todos(folder, tmp_path, **kw):
    """make_todo of both packages with the fixture's data tables."""
    sim, d, tables, _, _ = folder
    out = []
    for mod, name in ((jax_todolist, "jax"), (todolist, "torch")):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(mod, "data_dir", lambda: tables)
            out.append(mod.make_todo(d, output_file=str(tmp_path / f"{name}.sqlite"), **kw))
    return out


def test_make_todo_rows_equal_jax(folder, tmp_path):
    sim, d, tables, ids, excluded = folder
    want, got = _todos(folder, tmp_path)
    assert _dump(got) == _dump(want)
    with sqlite3.connect(got) as conn:
        conn.row_factory = sqlite3.Row
        rows = [dict(r) for r in conn.execute("SELECT * FROM todolist ORDER BY priority")]
    by = {(r["starid"], r["datasource"]): r for r in rows}
    assert [r["priority"] for r in rows] == list(range(1, len(rows) + 1))
    assert [r["tmag"] for r in rows] == sorted(r["tmag"] for r in rows)
    # Every star on the frame is an FFI target but the excluded one:
    assert {s for s, ds in by if ds == "ffi"} == set(int(s) for s in sim.starid) - {excluded}
    assert by[(ids["E"], "ffi")]["method"] == "halo"            # Tmag <= 2
    assert by[(ids["C"], "ffi")]["method"] == "psf"             # table, lower-cased
    # The primaries, each not a secondary of the other; C and D once each:
    assert by[(ids["A"], "tpf")]["method"] is None and (ids["B"], "tpf") in by
    sec = [r for r in rows if r["datasource"].startswith("tpf:")]
    assert {r["starid"] for r in sec} >= {ids["C"], ids["D"]}
    assert not {r["starid"] for r in sec} & {ids["A"], ids["B"]}
    assert len(sec) == len({r["starid"] for r in sec})
    assert by[(ids["D"], sec[[r["starid"] for r in sec].index(ids["D"])]["datasource"])][
        "method"] == "linpsf"
    assert {r["cbv_area"] for r in rows} <= {321, 322, 323, 324}


@pytest.mark.parametrize("kw", [
    {"find_secondary_targets": False}, {"cameras": 3, "ccds": [2]}, {"sectors": [1]},
    {"cameras": [1]}], ids=["no_secondaries", "camera_ccd", "sectors", "no_targets"])
def test_make_todo_options_equal_jax(folder, tmp_path, kw):
    want, got = _todos(folder, tmp_path, **kw)
    if kw.get("cameras") == [1]:
        assert want is None and got is None
        return
    assert _dump(got) == _dump(want)


def test_make_todo_keeps_or_overwrites(folder, tmp_path):
    sim, d, tables, _, _ = folder
    path = str(tmp_path / "todo.sqlite")
    assert todolist.make_todo(d, output_file=path) == path
    with sqlite3.connect(path) as conn:
        conn.execute("DELETE FROM todolist WHERE priority=1")
    assert todolist.make_todo(d, output_file=path) == path             # kept as it is
    with sqlite3.connect(path) as conn:
        n_kept = conn.execute("SELECT COUNT(*) FROM todolist").fetchone()[0]
    assert todolist.make_todo(d, output_file=path[:-7], overwrite=True) == path
    with sqlite3.connect(path) as conn:
        assert conn.execute("SELECT COUNT(*) FROM todolist").fetchone()[0] == n_kept + 1


def test_todo_cmd_matches_jax(folder, tmp_path):
    sim, d, tables, _, _ = folder
    for main, name in ((jax_todo_cmd.main, "jax"), (todo_cmd.main, "torch")):
        assert main(["-q", "--no-secondaries", "--output", str(tmp_path / name), d]) == 0
    assert _dump(str(tmp_path / "torch.sqlite")) == _dump(str(tmp_path / "jax.sqlite"))
    assert todo_cmd.main(["-q", "--camera", "1", "--output", str(tmp_path / "none"), d]) == 1


def test_calc_cbv_area_and_edge_distance_exact():
    """test_calc_cbv_area_and_edge_distance's cases, then random inputs:
    equal to the JAX package's, element for element."""
    class S:
        camera = 3
        ccd = 2
        camera_centre_ra = 100.0
        camera_centre_dec = 0.0
    for mod in (jax_todolist, todolist):
        assert mod.calc_cbv_area(100.0, 0.0, S()) == 321
        assert mod.calc_cbv_area(100.0, 16.0, S()) == 324
    rng = np.random.default_rng(4)
    ra, dec = rng.uniform(85, 115, 4000), rng.uniform(-15, 15, 4000)
    got = todolist.calc_cbv_area(ra, dec, S())
    np.testing.assert_array_equal(got, jax_todolist.calc_cbv_area(ra, dec, S()))
    assert set(np.unique(got)) == {321, 322, 323, 324}

    ed = todolist.edge_distance(np.array([0.0, 5.0]), np.array([0.0, 5.0]), image_shape=(11, 11))
    np.testing.assert_array_equal(ed, [0.5, 5.5])
    ap = np.ones((11, 11), bool)
    ap[5, 5] = False
    assert todolist.edge_distance(np.array([5.0]), np.array([3.0]), aperture=ap)[0] == 1.5
    with pytest.raises(ValueError):
        todolist.edge_distance(1, 1)
    rows, cols = rng.uniform(-0.5, 20.5, 300), rng.uniform(-0.5, 14.5, 300)
    ap = rng.uniform(size=(21, 15)) < 0.9
    for kw in ({"image_shape": (21, 15)}, {"aperture": ap}, {"aperture": np.ones_like(ap)}):
        np.testing.assert_array_equal(todolist.edge_distance(rows, cols, **kw),
                                      jax_todolist.edge_distance(rows, cols, **kw))


def test_taskmanager_queue_calls_match_jax(folder, tmp_path):
    """get_number_tasks, start_task and release_tasks, the same calls on
    copies of one todo file: the same returns, summaries and statuses."""
    sim, d, tables, _, _ = folder
    src = todolist.make_todo(d, output_file=str(tmp_path / "todo.sqlite"))
    out = []
    for mod, name in ((jax_taskmanager, "jax"), (taskmanager, "torch")):
        path = str(tmp_path / f"{name}.sqlite")
        shutil.copy(src, path)
        calls = []
        with mod.TaskManager(path) as tm:
            calls.append(tm.get_number_tasks())
            calls.append(tm.get_number_tasks(datasource="ffi"))
            calls.append(tm.get_number_tasks(camera=3, ccd=2, tmag_max=10.0))
            first = tm.get_task()
            tm.start_task(first["priority"])
            batch = [t["priority"] for t in tm.get_task_batch(batch_size=5, datasource="ffi")]
            tm.start_tasks(batch)
            calls.append((first["priority"], batch, tm.get_number_tasks(),
                          tm.summary["STARTED"]))
            calls.append(tm.release_tasks(batch[:3] + [first["priority"], 10 ** 6]))
            calls.append((tm.get_number_tasks(), tm.summary["STARTED"]))
            calls.append(tm.release_tasks(batch[:3]))                 # no longer STARTED
            calls.append(tm.get_task()["priority"])
        with sqlite3.connect(path) as conn:
            calls.append(conn.execute("SELECT priority, status FROM todolist "
                                      "ORDER BY priority").fetchall())
        out.append(calls)
    assert out[1] == out[0]
    assert out[1][4] == 4 and out[1][6] == 0


def test_ffi_targets_ignore_the_pixel_offset(folder, tmp_path):
    """A cube of flight FFIs (PIXEL_OFFSET_COLUMN 44) keeps its WCS on the
    science grid: the port puts every star of the frame on silicon, where
    the JAX package, subtracting the offset once more, loses the stars of
    the first 44 science columns (ROADMAP.md, Queue C)."""
    sim, d, tables, _, _ = folder
    d2 = str(tmp_path / "flight")
    shutil.copytree(d, d2, ignore=shutil.ignore_patterns("*.fits.gz", "*_tp.fits*"))
    with h5py.File(os.path.join(d2, "sector001_camera3_ccd2.hdf5"), "r+") as h5:
        h5.attrs["PIXEL_OFFSET_COLUMN"] = 44
    sets = []
    for mod, name in ((jax_todolist, "jax"), (todolist, "torch")):
        path = mod.make_todo(d2, output_file=str(tmp_path / f"{name}.sqlite"))
        with sqlite3.connect(path) as conn:
            sets.append({r[0] for r in conn.execute("SELECT starid FROM todolist")})
    want, got = sets
    assert got == set(int(s) for s in sim.starid)
    lost = {int(s) for s, c in zip(sim.starid, sim.col_ref) if c < 43.5}
    assert lost and want == got - lost


def _jax_helper(name):
    from photometry_tpu.utils import mathutils as jm
    return getattr(jm, name)


@pytest.mark.parametrize("name", ["sphere_distance", "radec_to_cartesian", "cartesian_to_radec",
                                  "add_proper_motion", "find_nearest", "flux2mag", "nanmad",
                                  "integrated_gaussian", "np_moving_median_central"])
def test_host_helpers_match_jax(name):
    """utils.mathutils' numpy host helpers against the JAX package's (jnp in
    float32 there: float32 tolerances; the numpy ones exact)."""
    from photometry_tpu_torch.utils import mathutils
    rng = np.random.default_rng(8)
    ra, dec = rng.uniform(0, 360, 50), rng.uniform(-89, 89, 50)
    args = {
        "sphere_distance": (ra, dec, ra[::-1], dec[::-1]),
        "radec_to_cartesian": (np.stack([ra, dec], 1),),
        "cartesian_to_radec": (mathutils.radec_to_cartesian(np.stack([ra, dec], 1)),),
        "add_proper_motion": (ra, dec, rng.normal(0, 50, 50), rng.normal(0, 50, 50), 2458650.0),
        "find_nearest": (np.where(rng.uniform(size=50) < 0.1, np.nan, ra), 123.4),
        "flux2mag": (rng.uniform(10, 1e6, 50),),
        "nanmad": (np.where(rng.uniform(size=(5, 50)) < 0.1, np.nan, rng.normal(size=(5, 50))),),
        "integrated_gaussian": (*np.mgrid[0:9, 0:9].astype(float), 1e4, 4.3, 3.8, 1.2),
        "np_moving_median_central": (np.where(rng.uniform(size=(40, 3)) < 0.1, np.nan,
                                              rng.normal(size=(40, 3))), 7),
    }[name]
    got, want = getattr(mathutils, name)(*args), _jax_helper(name)(*args)
    if name == "find_nearest":
        assert got == int(want)
        return
    if name == "np_moving_median_central":
        np.testing.assert_array_equal(got, want)
        return
    # integrated_gaussian: a float32 erf difference near 1 is good to ~2 ulp
    # (1.2e-7) absolute, times flux / 4 and the other axis' factor (<= 2):
    tol = {"sphere_distance": (1e-5, 1e-4), "add_proper_motion": (0, 3e-5),
           "cartesian_to_radec": (0, 3e-5),
           "integrated_gaussian": (0, 1e4 * 1.2e-7)}.get(name, (2e-6, 1e-6))
    for a, b in zip(np.atleast_1d(got) if not isinstance(got, tuple) else got,
                    np.atleast_1d(np.asarray(want)) if not isinstance(want, tuple) else want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=tol[0], atol=tol[1], err_msg=name)
    if name == "nanmad":
        np.testing.assert_allclose(mathutils.nanmad(args[0], axis=1, scale_to_sigma=True),
                                   _jax_helper(name)(args[0], axis=1, scale_to_sigma=True),
                                   rtol=2e-6)
