"""The benchmark's files against its contract: names, units, files found by
name, a cell added from new files alone, the import guard, and a reference
that imports nothing of the program or of JAX.  CPU only."""

import ast
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

from perfbench import bench  # noqa: E402

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
SPEC = bench.spec()


def line_ok(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "perfbench/run.py"]
    assert SPEC["paths"] == ["perfbench"]
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_every_name_and_unit_uses_the_allowed_characters(kind):
    names = [e["name"] for e in SPEC[kind]]
    assert len(names) == len(set(names))
    for e in SPEC[kind]:
        assert NAME.fullmatch(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.fullmatch(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
            assert e["source"] in SOURCES
        for key in ("config", "traffic"):
            if key in e:
                assert NAME.fullmatch(e[key])
        for key in e.get("reduced", []):
            assert NAME.fullmatch(key)
        for key in {"configs": ("why", "source"), "workloads": ("why",),
                    "per_layer": ("layer",)}.get(kind, ()):
            assert line_ok(e[key]), (e["name"], key)


def test_entries_have_only_the_contract_keys():
    allowed = {"configs": {"name", "source", "file", "reduced", "why"},
               "workloads": {"name", "config", "traffic", "chips", "why"},
               "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
               "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"}}
    for kind, keys in allowed.items():
        for e in SPEC[kind]:
            assert set(e) <= keys, (kind, e["name"], set(e) - keys)


def test_bounds_and_metric_rules():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", cells):
            assert w in cells
            assert w in e2e[m["moves"]].get("workloads", cells)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for w in SPEC["workloads"]:
        assert w["chips"] in (1, 4)
        reported = [m for m in bench.metrics_of(SPEC, w["name"], "end_to_end")]
        assert {"setup_s"} < {m["name"] for m in reported}
        assert bench.metrics_of(SPEC, w["name"], "per_layer")
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(1, len(SPEC["workloads"]) // 4)


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cells_files_are_found_by_name(cell):
    wl, cfg, mix, limits = bench.cell(SPEC, cell)
    assert bench.driver(mix).setup
    assert limits and all(isinstance(v, (int, float)) for v in limits.values())
    conf = next(c for c in SPEC["configs"] if c["name"] == wl["config"])
    assert conf["file"].startswith("perfbench/") and set(conf["reduced"]) <= set(cfg)
    for kind in ("end_to_end", "per_layer"):
        for m in bench.metrics_of(SPEC, cell, kind):
            assert callable(bench.reader(m["name"]))


def _digests(folder):
    out = {}
    for base, _, files in os.walk(folder):
        for f in files:
            if "__pycache__" not in base:
                path = os.path.join(base, f)
                with open(path, "rb") as fh:
                    out[os.path.relpath(path, folder)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_a_cell_added_from_new_files_runs_with_no_edit(tmp_path):
    """A new traffic mix, limits file, metric reader and cell entry, all new
    files in a copy of the benchmark: the harness finds and runs them."""
    import torch
    root = tmp_path / "checkout"
    shutil.copytree(HERE, root / "perfbench", ignore=shutil.ignore_patterns("__pycache__",
                                                                             "_cache"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    before = _digests(root / "perfbench")
    here = root / "perfbench"
    (here / "traffic" / "drain_small.json").write_text(json.dumps(
        {"driver": "drain", "method": None, "batch_size": 64, "todo": 120, "bright": 4,
         "pairs": 4, "tail": 40, "warm_tasks": 16, "check": {"aperture_sample": 8}}))
    (here / "limits" / "ffi1800.small.json").write_text(json.dumps(
        {"unfinished": 0, "aperture_gap": 1e-4, "halo_gap": 1e-4, "linpsf_gap": 1e-4}))
    (here / "metrics" / "drain.lease_ms_per_task.py").write_text(
        "def read(run):\n    t = run['timers']\n    return 1e3 * t['lease'] / t['n_done']\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "ffi1800.small", "config": "ffi1800",
                              "traffic": "drain_small", "chips": 1, "why": "a test cell"})
    spec["per_layer"].append({"name": "drain.lease_ms_per_task", "unit": "ms",
                              "better": "lower", "source": "program_span", "layer": "todo list",
                              "moves": "tasks_per_s", "workloads": ["ffi1800.small"]})
    spec["end_to_end"][0]["workloads"].append("ffi1800.small")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    small = {"rows": 256, "cols": 256, "n_times": 24,
             "field": {"n_stars": 300, "tmag_min": 7.5, "tmag_max": 13.0, "psf_sigma_px": 1.2}}
    result, values, _ = bench.run_cell("ffi1800.small", 3, 0.0, True, torch.device("cpu"),
                                       0.0, root=str(root), here=str(here),
                                       work=str(tmp_path / "work"), config_override=small)
    assert "drain.lease_ms_per_task" in result["metrics"]
    assert result["correct"], result["checks"]
    after = _digests(root / "perfbench")
    assert {k: v for k, v in after.items() if k in before} == before


GUARD = """
import sys
sys.path.insert(0, {root!r})
from perfbench import guard
guard.install()
import photometry_tpu_torch
refused = []
for name in ("jax", "jaxlib", "flax", "photometry_tpu", "photometry_tpu.core", "jax.numpy"):
    try:
        __import__(name)
    except ImportError:
        refused.append(name)
print(",".join(refused), "|", ",".join(guard.loaded()))
"""


def test_import_guard_refuses_jax_and_the_jax_package_only():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", GUARD.format(root=ROOT)], capture_output=True,
                         text=True, env=env, timeout=300, cwd=HERE)
    assert out.returncode == 0, out.stderr
    refused, loaded = out.stdout.strip().split("|")
    assert refused.strip().split(",") == ["jax", "jaxlib", "flax", "photometry_tpu",
                                          "photometry_tpu.core", "jax.numpy"]
    assert loaded.strip() == ""
    from perfbench import guard
    assert guard.top_level("photometry_tpu_torch.core") not in guard.BLOCKED


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("name", sorted(f for f in os.listdir(os.path.join(HERE, "reference"))
                                        if f.endswith(".py")))
def test_reference_imports_nothing_of_the_program_or_of_jax(name):
    tops = {m.split(".")[0] for m in _imports(os.path.join(HERE, "reference", name))}
    assert not tops & {"photometry_tpu_torch", "photometry_tpu", "jax", "jaxlib", "flax"}
    assert tops <= {"os", "sqlite3", "gzip", "re", "numpy", "torch"}
