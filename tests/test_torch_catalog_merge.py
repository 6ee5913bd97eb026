"""Port parity of the catalog build, the footprint query and the todo merge, on the CPU.

- ``make_catalog`` from a TIC extract (``.npz`` and text) and the catalog
  CLI: every row of the ``settings`` and ``catalog`` tables equal to the JAX
  package's (mirrors test_make_catalog_from_tic_extract).
- ``query_footprint`` and ``StarCatalog.query_footprint``: the same result
  sets as the JAX package's across RA=0 (mirrors
  test_query_footprint_ra0_straddle), near a pole and in a plain box.
- ``todo_merge`` and its CLI: every table, row and ``corr_status`` of the
  final file equal to the JAX package's (mirrors test_todo_merge), in
  folders whose names hold a space or a ``?``, where both packages take the
  same paths into their ``file:`` URIs and must fail or succeed alike.
"""

import os
import shutil
import sqlite3

import numpy as np
import pytest

import torch_parity  # noqa: F401  (one intra-op thread per test worker)

from photometry_tpu import catalog as jax_catalog
from photometry_tpu.cli import todo_merge_cmd as jax_todo_merge_cmd
from photometry_tpu.prepare import prepare_photometry
from photometry_tpu.sim.simulator import SimConfig, simulate_sector
from photometry_tpu.todo_merge import todo_merge as jax_todo_merge

from photometry_tpu_torch import catalog
from photometry_tpu_torch.cli import catalog_cmd, todo_merge_cmd
from photometry_tpu_torch.todo_merge import todo_merge
from photometry_tpu_torch.todolist import make_todo


def _dump(path):
    """Every row of every table, and the schema, of a SQLite file."""
    with sqlite3.connect(path) as conn:
        schema = conn.execute("SELECT type, name, tbl_name, sql FROM sqlite_master "
                              "ORDER BY type, name").fetchall()
        tables = [r[1] for r in schema if r[0] == "table"]
        rows = {t: conn.execute(f"SELECT * FROM {t} ORDER BY rowid").fetchall() for t in tables}
    return schema, rows


def _tic(tmp_path, n=12, seed=5, fmt="npz"):
    rng = np.random.default_rng(seed)
    cols = dict(starid=np.arange(1, n + 1), ra=rng.uniform(10, 12, n),
                dec=rng.uniform(-40, -38, n), pm_ra=rng.normal(0, 20, n),
                pm_dec=rng.normal(0, 20, n), tmag=rng.uniform(6, 14, n),
                teff=np.where(rng.uniform(size=n) < 0.3, np.nan, rng.uniform(3e3, 9e3, n)))
    path = str(tmp_path / f"tic.{fmt}")
    if fmt == "npz":
        np.savez(path, **cols)
    else:
        np.savetxt(path, np.stack(list(cols.values()), axis=1)[:, :6])
    return path


@pytest.mark.parametrize("fmt", ["npz", "txt"])
def test_make_catalog_matches_jax(tmp_path, fmt):
    tic = _tic(tmp_path, fmt=fmt)
    paths = []
    for mod, name in ((jax_catalog, "jax"), (catalog, "torch")):
        d = tmp_path / name
        d.mkdir()
        paths.append(mod.make_catalog(str(d), 27, 1, 1, tic_source=tic))
    assert _dump(paths[1]) == _dump(paths[0])
    with catalog.StarCatalog(paths[1]) as cat:
        assert len(cat) == 12 and cat.settings.ticver == "tic-extract"
    with pytest.raises(ValueError):
        catalog.make_catalog(str(tmp_path), 1, 1, 2)


def test_catalog_cmd(tmp_path):
    """The CLI builds the missing catalogs from the extract, keeps the ones
    present, rebuilds them with --overwrite and exits 1 without a source."""
    tic = _tic(tmp_path)
    d = str(tmp_path / "sector")
    os.makedirs(d)
    argv = ["-q", "--camera", "1", "--camera", "2", "--ccd", "3", "--tic-source", tic, "27", d]
    assert catalog_cmd.main(argv) == 0
    built = sorted(f for f in os.listdir(d) if f.endswith(".sqlite"))
    assert built == ["catalog_sector027_camera1_ccd3.sqlite", "catalog_sector027_camera2_ccd3.sqlite"]
    want = jax_catalog.make_catalog(str(tmp_path), 27, 1, 3, tic_source=tic, coord_buffer=0.2)
    assert _dump(os.path.join(d, built[0])) == _dump(want)
    path = os.path.join(d, built[1])
    with sqlite3.connect(path) as conn:
        conn.execute("DELETE FROM catalog WHERE starid=1")
    assert catalog_cmd.main(["-q", "--camera", "2", "--ccd", "3", "27", d]) == 0     # present
    with catalog.StarCatalog(path) as cat:
        assert len(cat) == 11
    assert catalog_cmd.main(argv[:-2] + ["-o"] + argv[-2:]) == 0
    with catalog.StarCatalog(path) as cat:
        assert len(cat) == 12
    assert catalog_cmd.main(["-q", "--camera", "3", "--ccd", "3", "27", d]) == 1


@pytest.fixture(scope="module")
def footprint_catalog(tmp_path_factory):
    """Stars along the equator across RA=0, and around the south pole."""
    ras = np.array([359.7, 359.95, 0.05, 0.3, 90.0, 180.0, 270.0, 10.0, 100.0, 200.0, 300.0])
    decs = np.array([0, 0, 0, 0, 0, 0, 0, -89.9, -89.95, -89.8, -88.0], float)
    n = len(ras)
    path = catalog.make_catalog_from_arrays(
        str(tmp_path_factory.mktemp("footprint") / "catalog_sector001_camera1_ccd1.sqlite"),
        1, 1, 1, starid=np.arange(1, n + 1), ra_j2000=ras, dec_j2000=decs, pm_ra=np.zeros(n),
        pm_dec=np.zeros(n), tmag=np.full(n, 10.0), reference_time=2458325.5,
        footprint=np.array([[359.5, -1.0], [359.5, 1.0], [0.5, 1.0], [0.5, -1.0]]))
    return path


@pytest.mark.parametrize("foot, want", [
    ([[359.9, -0.5], [359.9, 0.5], [0.1, 0.5], [0.1, -0.5]], [2, 3]),         # straddle
    ([[355.0, -0.5], [355.0, 0.5], [5.0, 0.5], [5.0, -0.5]], [1, 2, 3, 4]),    # wider
    ([[89.0, -0.5], [89.0, 0.5], [91.0, 0.5], [91.0, -0.5]], [5]),             # plain box
    ([[0.02, -0.5], [0.02, 0.5], [1.0, 0.5], [1.0, -0.5]], [3, 4]),            # corner at RA=0
    ([[30.0, -89.99], [120.0, -89.9], [210.0, -89.99], [300.0, -89.9]], [8, 9]),    # pole
], ids=["straddle", "wide_straddle", "box", "near_ra0", "pole"])
def test_query_footprint_matches_jax(footprint_catalog, foot, want):
    foot = np.array(foot)
    with sqlite3.connect(footprint_catalog) as conn:
        conn.row_factory = sqlite3.Row
        cur = conn.cursor()
        got = sorted(r["starid"] for r in catalog.query_footprint(cur, foot))
        ref = sorted(r["starid"] for r in jax_catalog.query_footprint(cur, foot))
        assert got == ref == want
        kw = dict(columns="starid, ra", constraints="starid != 3", buffer_size=2)
        assert (catalog.query_footprint(cur, foot, **kw)
                == jax_catalog.query_footprint(cur, foot, **kw))
    with catalog.StarCatalog(footprint_catalog) as cat, \
            jax_catalog.StarCatalog(footprint_catalog) as jcat:
        a, b = cat.query_footprint(foot), jcat.query_footprint(foot)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.fixture(scope="module")
def drained_todo(tmp_path_factory):
    """A todo list of a prepared sim sector, made by the port, every task done."""
    d = str(tmp_path_factory.mktemp("merge"))
    sim = simulate_sector(SimConfig(shape=(64, 64), n_times=6, n_stars=10, seed=41))
    sim.write_ffis(d)
    sim.write_catalog(d)
    prepare_photometry(d)
    todo = make_todo(d)
    with sqlite3.connect(todo) as conn:
        conn.execute("UPDATE todolist SET status=1;")
        conn.execute("UPDATE todolist SET status=NULL WHERE priority=3;")   # never drained
    return todo


def _derived(todo, path):
    """test_todo_merge's corrections file: corr_status on every row, an
    extra table, and one row's photometry status changed."""
    shutil.copy(todo, path)
    with sqlite3.connect(path) as conn:
        conn.execute("ALTER TABLE todolist ADD COLUMN corr_status INTEGER DEFAULT NULL;")
        conn.execute("UPDATE todolist SET corr_status=1;")
        conn.execute("CREATE TABLE diagnostics_corr (priority INTEGER PRIMARY KEY, lightcurve TEXT);")
        conn.execute("CREATE INDEX diagnostics_corr_lc ON diagnostics_corr (lightcurve);")
        conn.execute("INSERT INTO diagnostics_corr SELECT priority, 'x.fits' FROM todolist;")
        conn.execute("UPDATE todolist SET status=3 WHERE priority=2;")
    return path


def _merge(fn, todo, derived, out):
    try:
        return fn(todo, derived, out)
    except Exception as exc:         # compared between the packages
        return type(exc).__name__


@pytest.mark.parametrize("dirname", ["plain", "with space", "what?mode=rw"])
def test_todo_merge_matches_jax(drained_todo, tmp_path, dirname):
    outs = []
    for fn, name in ((jax_todo_merge, "jax"), (todo_merge, "torch")):
        d = tmp_path / name / dirname
        d.mkdir(parents=True)
        todo = str(d / "todo.sqlite")
        shutil.copy(drained_todo, todo)
        derived = _derived(todo, str(d / "todo-corr.sqlite"))
        outs.append(_merge(fn, todo, derived, str(d / "merged.sqlite")))
    if dirname == "plain":
        assert isinstance(outs[0], str) and outs[0].endswith("merged.sqlite")
    if not os.path.isfile(str(outs[0])):
        assert outs[1] == outs[0]                   # the same exception
        return
    want, got = _dump(outs[0]), _dump(outs[1])
    assert got == want
    schema, rows = got
    corr = dict((r[0], r[-1]) for r in rows["todolist"])
    assert corr[1] == 1 and corr[2] is None and corr[3] is None
    assert sum(v is None for v in corr.values()) == 2
    assert sorted(r[0] for r in rows["diagnostics_corr"]) == sorted(
        p for p, v in corr.items() if v is not None)
    assert ("index", "diagnostics_corr_lc") in {(r[0], r[1]) for r in schema}


def test_todo_merge_cmd_and_refusals(drained_todo, tmp_path):
    todo = str(tmp_path / "todo.sqlite")
    shutil.copy(drained_todo, todo)
    derived = _derived(todo, str(tmp_path / "todo-corr.sqlite"))
    for main, name in ((jax_todo_merge_cmd.main, "jax"), (todo_merge_cmd.main, "torch")):
        assert main(["-q", todo, derived, str(tmp_path / f"{name}.sqlite")]) == 0
    assert _dump(str(tmp_path / "torch.sqlite")) == _dump(str(tmp_path / "jax.sqlite"))
    with pytest.raises(FileExistsError):
        todo_merge(todo, derived, str(tmp_path / "torch.sqlite"))
    assert todo_merge_cmd.main(["-q", "-o", todo, derived, str(tmp_path / "torch.sqlite")]) == 0
    # An incompatible file is refused, as by the JAX package:
    with sqlite3.connect(derived) as conn:
        conn.execute("DELETE FROM todolist WHERE priority=1;")
    for fn in (jax_todo_merge, todo_merge):
        with pytest.raises(RuntimeError):
            fn(todo, derived, str(tmp_path / "m2.sqlite"))
