"""The harness: a cell of BENCHMARK.json from its files, one run, its result line.

Everything that belongs to one configuration, traffic mix or metric sits
in a file of its own, found by the name that BENCHMARK.json gives:
``configs/<config>.json`` (via the entry's ``file``), ``traffic/<mix>.json``
(whose ``driver`` names ``drivers/<driver>.py``), ``limits/<cell>.json``
(the limit of each number the check compares) and ``metrics/<metric>.py``
(a ``read(run)`` that returns the metric's value, or None where the run
holds nothing to read).
"""

import gc
import importlib
import importlib.util
import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(path):
    with open(path) as fh:
        return json.load(fh)


def spec(root=ROOT):
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell(bench, name, root=ROOT, here=HERE):
    """(workload entry, configuration, traffic mix, limits) of a cell, by name."""
    wl = next(w for w in bench["workloads"] if w["name"] == name)
    conf = next(c for c in bench["configs"] if c["name"] == wl["config"])
    return (wl, load_json(os.path.join(root, conf["file"])),
            load_json(os.path.join(here, "traffic", wl["traffic"] + ".json")),
            load_json(os.path.join(here, "limits", wl["name"] + ".json")))


def metrics_of(bench, name, kind):
    """The cell's metrics of ``kind`` (end_to_end or per_layer), in file order."""
    return [m for m in bench[kind] if name in m.get("workloads", [name])]


def reader(metric, here=HERE):
    path = os.path.join(here, "metrics", metric + ".py")
    mod_spec = importlib.util.spec_from_file_location("perfbench_metric_" + metric, path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def driver(traffic):
    return importlib.import_module(f"perfbench.drivers.{traffic['driver']}")


def judge(values, limits):
    """The checks line: each number beside its limit, and whether all hold."""
    checks = {k: {"value": values[k], "limit": lim} for k, lim in limits.items()}
    ok = all(values[k] == values[k] and values[k] <= lim for k, lim in limits.items())
    return checks, ok


def run_cell(name, seed, seconds, trace, device, t_start, root=ROOT, here=HERE,
             work=None, config_override=None, traffic_override=None):
    """One run of a cell: set-up, window, metrics, check.  Returns the
    result line's dict, the check's numbers and what the metrics read."""
    import torch
    bench = spec(root)
    wl, cfg, mix, limits = cell(bench, name, root, here)
    cfg = {**cfg, **(config_override or {})}
    mix = {**mix, **(traffic_override or {})}
    drv = driver(mix)
    work = work or tempfile.mkdtemp(prefix="perfbench-")
    if device.type == "cuda":
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    state = drv.setup(cfg, mix, seed, device, work)
    setup_s = time.perf_counter() - t_start
    run = drv.window(state, seconds, trace)
    run.update(setup_s=setup_s, seconds=seconds, config=cfg, mix=mix)
    run["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                if device.type == "cuda" else 0)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in metrics_of(bench, name, kind):
        value = reader(m["name"], here)(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    values = drv.check(state, run)
    checks, ok = judge(values, limits)
    result = {"correct": ok, "attempted": run["attempted"], "failed": run["failed"],
              "metrics": metrics, "device": device_info(device, wl["chips"], run)}
    if trace and "trace" in run:
        tr = run["trace"]
        result["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    result["checks"] = checks
    return result, values, run


def device_info(device, chips, run):
    import torch
    if device.type != "cuda":
        info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    else:
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
                "memory_peak_bytes": int(run["memory_peak_bytes"])}
    if "trace" in run:
        info.update(busy_s=run["trace"]["busy_s"], window_s=run["trace"]["window_s"])
    return info


def emit(result):
    """Each compared number beside its limit as the last lines on stderr,
    then the result as the last line on stdout."""
    for k, c in result["checks"].items():
        mark = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"check {k} {c['value']!r} limit {c['limit']!r} {mark}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
