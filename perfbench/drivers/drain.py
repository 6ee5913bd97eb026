"""Drive ``core.drain.run_drain`` over a cell's todo list, and judge what it wrote.

Set-up makes the inputs from the seed (an FFI cube on the card, or a pool
of TPF files), writes the cell's todo list once as a template, and drains
a small warm list through the same path.  The window then runs whole
drains one after another, each from a fresh copy of the template, until
the seconds are spent.  The FFI context is handed to ``run_drain`` by
replacing ``core.dispatcher.open_context`` with one that builds
``SectorContext.from_arrays`` on the cube (the card's machine has no h5py
to open a cube file); TPF contexts are the program's own, read from the
files.
"""

import contextlib
import os
import shutil
import time
from unittest import mock

import numpy as np
import torch

from ..gen import ffi, field, tpf
from ..reference import drain as ref


def setup(cfg, mix, seed, device, work, dtype=torch.float32):
    from photometry_tpu_torch.core import dispatcher
    from photometry_tpu_torch.core.engine import SectorContext
    state = {"cfg": cfg, "mix": mix, "seed": seed, "device": device, "work": work,
             "drains": []}
    if cfg["datasource"] == "ffi":
        sec = ffi.sector(cfg, mix, seed, device, os.path.join(work, "catalog"), dtype)
        state.update(sec=sec, input=os.path.join(work, "input"), crpix=sec["crpix"])
        os.makedirs(state["input"])
        state["template"] = ffi.write_tasks(work, sec["todo"], sec["tmag"], cfg["cadence_s"])
        ctx_kw = sec["ctx_kw"]

        def open_context(*_a, **_kw):
            return SectorContext.from_arrays(**ctx_kw)
        state["patch"] = lambda: mock.patch.object(dispatcher, "open_context", open_context)
        nb, npair = sec["n_bright"], sec["n_pairs"]
        warm = sec["todo"][:nb + npair] + sec["todo"][nb + npair:][:max(
            mix["warm_tasks"] - nb - npair, 0)]
        warm_todo = lambda folder: ffi.write_tasks(folder, warm, sec["tmag"], cfg["cadence_s"])
    else:
        state["input"] = os.path.join(work, "pool")
        p = tpf.pool(cfg, seed, device, state["input"])
        state.update(pool=p, crpix=None)
        state["template"] = os.path.join(work, "todo.sqlite")
        shutil.move(os.path.join(state["input"], "todo.sqlite"), state["template"])
        state["patch"] = contextlib.nullcontext
        head = p["tasks"][0][0]
        warm = [t for t in p["tasks"] if t[0] == head or t[2] == f"tpf:{head}"]
        warm_todo = lambda folder: tpf.write_todo(
            folder, [t[0] for t in warm], [t[1] for t in warm],
            datasources=[t[2] for t in warm], cadences=[cfg["cadence_s"]] * len(warm))
    # The warm drain: every path of the mix once (kernels built or loaded).
    folder = os.path.join(work, "warm")
    os.makedirs(folder)
    warm_todo(folder)
    drain_once(state, folder, template=os.path.join(folder, "todo.sqlite"))
    sync(device)
    return state


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def drain_once(state, folder, template=None):
    """One run_drain from a fresh copy of the todo list; the list and the
    products end in ``folder``.  Returns the drain's timers."""
    from photometry_tpu_torch.core.drain import new_timers, run_drain
    os.makedirs(folder, exist_ok=True)
    todo = os.path.join(state["input"], "todo.sqlite")
    shutil.copyfile(template or state["template"], todo)
    timers = new_timers()
    with state["patch"]():
        run_drain(state["input"], 1, products_folder=os.path.join(folder, "products"),
                  method=state["mix"]["method"], batch_size=state["mix"]["batch_size"],
                  timers=timers, device=state["device"])
    shutil.move(todo, os.path.join(folder, "todo.sqlite"))
    return timers


def span_targets():
    """The program's layer entry points that a traced run times from outside."""
    from photometry_tpu_torch import taskmanager
    from photometry_tpu_torch.core import dispatcher, drain
    from photometry_tpu_torch.models import halo, linpsf
    return [(drain, "run_drain", "drain loop"),
            (taskmanager.TaskManager, "get_task_batch", "lease"),
            (taskmanager.TaskManager, "start_tasks", "sqlite"),
            (taskmanager.TaskManager, "save_results", "sqlite"),
            (dispatcher.ContextCache, "get", "context"),
            (dispatcher, "extract_aperture_batch", "aperture"),
            (halo, "extract_halo_batch", "halo"),
            (linpsf, "extract_linpsf_batch", "linpsf"),
            (dispatcher, "_save_results_parallel", "save")]


@contextlib.contextmanager
def band_recorder(launches):
    """Keep the arguments of every band-sum launch (for the bytes it needs)."""
    from photometry_tpu_torch.ops import bandext
    run = bandext.band_sums

    def recorded(images, images_err, backgrounds, pixelflags, masks, r0s, c0s, windows=None):
        launches.append((images.shape, images.element_size(), masks, r0s, c0s, windows))
        return run(images, images_err, backgrounds, pixelflags, masks, r0s, c0s, windows)
    with mock.patch.object(bandext, "band_sums", recorded):
        yield


def window(state, seconds, trace=False):
    """Whole drains until ``seconds`` are spent; returns what the metrics read."""
    from .. import trace as tr
    launches = []

    def step():
        k = len(state["drains"])
        folder = os.path.join(state["work"], f"drain{k}")
        tic = time.perf_counter()
        timers = drain_once(state, folder)
        wall = time.perf_counter() - tic
        state["drains"].append((folder, timers, {**tally(state, folder, k), "wall_s": wall}))
    window_s, summary = tr.window(step, seconds, state["device"], trace, span_targets(),
                                  band_recorder(launches))
    timers = {}
    for _, t, _ in state["drains"]:
        for k, v in t.items():
            timers[k] = timers.get(k, 0) + v
    counts = [c for _, _, c in state["drains"]]
    run = {"window_s": window_s, "drains": len(counts), "timers": timers,
           "drain_s": [c["wall_s"] for c in counts],
           "n_tasks": sum(c["done"] for c in counts),
           "attempted": sum(c["attempted"] for c in counts),
           "failed": sum(c["unfinished"] + c["errors"] for c in counts)}
    if trace:
        run.update(trace=summary, band_launches=len(launches),
                   band_bytes=sum(band_bytes(*a) for a in launches))
    return run


def tally(state, folder, k):
    """Count a drain's rows, and keep of its products only the sample the
    check reads (drawn from the seed; every product of a kind whose traffic
    file names no sample size), deleting the rest at once: the products of
    earlier drains do not pile up in the page cache while later ones run."""
    rows = ref.todo_rows(folder)
    done = ref.delivered(folder)
    counts = {"attempted": len(rows), "unfinished": ref.unfinished(folder),
              "errors": sum(r[3] == ref.ERROR for r in rows), "done": len(done)}
    rng = np.random.default_rng([state["seed"], 1, k])
    sizes = state["mix"].get("check", {})
    # the injected pairs are a kind of their own, whatever method they ended in
    first_pair = (state["sec"]["truth"]["n_field"] + state["sec"]["n_bright"]
                  if "sec" in state else None)
    kind = lambda r: "pair" if first_pair is not None and r[1] > first_pair else r[4]  # noqa: E731
    kept = []
    for name in sorted({kind(r) for r in done}):
        got = [r for r in done if kind(r) == name]
        n = min(sizes.get(name + "_sample", len(got)), len(got))
        kept += [got[i] for i in sorted(rng.choice(len(got), n, replace=False))]
    keep = {r[0] for r in kept}
    for r in done:
        if r[0] not in keep:
            os.remove(ref.product_path(folder, r[5]))
    counts["kept"] = kept
    return counts


def band_bytes(shape, elem, masks, r0s, c0s, windows) -> int:
    """Bytes one band-sum launch needs, each read once: the three value
    planes over the union of the masks' pixels, the flags over the union of
    the windows (the shenanigans test's stamps), masks and windows, corners,
    and the ten float32 sums per target and frame written."""
    T, H, W = shape
    N, h, w = masks.shape
    dev = masks.device
    rows = (r0s.long()[:, None] + torch.arange(h, device=dev))[:, :, None].expand(N, h, w)
    cols = (c0s.long()[:, None] + torch.arange(w, device=dev))[:, None, :].expand(N, h, w)

    def union(sel):
        occ = torch.zeros(H * W, dtype=torch.bool, device=dev)
        occ[(rows * W + cols)[sel.to(torch.bool)]] = True
        return int(occ.sum())
    win = masks if windows is None else windows
    return (T * (3 * elem * union(masks) + union(win)) + 2 * N * h * w + 8 * N
            + 10 * 4 * N * T)


def check(state, run=None, control=None, planes=None):
    """The reference's numbers for every drain of the window: unfinished
    rows, the re-sum gaps of the kept products (a sample drawn from the
    seed) and, on an FFI cube, their gaps to the field's truth.  With
    ``control`` (a dtype), the reference on inputs rounded to it takes the
    products' place in the re-sums; ``planes`` replaces the FFI cube (the
    float32 cube made again from the seed, where the drain ran on a
    bfloat16 one)."""
    cfg = state["cfg"]
    out = {"unfinished": sum(c["unfinished"] for _, _, c in state["drains"])}
    rows = [(f, r) for f, _, c in state["drains"] for r in c["kept"]]
    t_index = lambda cad: np.asarray(cad, np.int64)
    gaps = {"aperture_gap": [], "halo_gap": [], "linpsf_gap": []}
    if cfg["datasource"] == "ffi":
        if planes is None:
            kw = state["sec"]["ctx_kw"]
            planes = (kw["images"], kw["images_err"], kw["backgrounds"])
        tmag, truth, crpix = state["sec"]["tmag"], state["sec"]["truth"], state["crpix"]
        n0, nb = truth["n_field"], state["sec"]["n_bright"]
        shape = (cfg["rows"], cfg["cols"])
        hdr = cfg["header"]
        var_const = float(np.float32(hdr["NUM_FRM"] * hdr["READNOIS"] ** 2 / hdr["GAIN"] ** 2))
        gaps.update(mask_loss=[], halo_truth_gap=[], pair_truth_gap=[])
        for f, r in rows:
            product = ref.fitsread.read(ref.product_path(f, r[5]))
            sid, method = r[1], r[4]
            row, col = truth["rows"][sid - 1], truth["cols"][sid - 1]
            aperture, r0, c0, lc = ref.stamp_of(product, crpix)
            if method == "aperture":
                gaps["aperture_gap"].append(ref.aperture_gap(planes, product, crpix, t_index,
                                                             control))
            elif method == "halo":
                gaps["halo_gap"].append(ref.halo_gap(planes, product, crpix, t_index,
                                                     tmag[sid - 1], control))
                i = sid - n0 - 1
                want = field.variation(lc["CADENCENO"], truth["n_times"], truth["phases"][i])
                gaps["halo_truth_gap"].append(ref.shape_gap(lc["FLUX_RAW"], want))
            elif method == "linpsf":
                gaps["linpsf_gap"].append(ref.linpsf_gap(planes, product, crpix, t_index,
                                                         var_const, control))
                if sid > n0 + nb:
                    gaps["pair_truth_gap"].append(ref.constant_gap(lc["FLUX_RAW"],
                                                                   ref.mag2flux(tmag[sid - 1])))
            if method == "aperture" and sid <= n0:
                gaps["mask_loss"].append(ref.own_light_lost(aperture, r0, c0, row, col,
                                                            truth["psf_sigma_px"], shape))
    else:
        cache = {}
        for f, r in rows:
            owner = r[1] if r[2] == "tpf" else int(r[2][4:])
            if owner not in cache:
                cache[owner] = tuple(torch.as_tensor(a) for a in state["pool"]["planes"][owner])
            product = ref.fitsread.read(ref.product_path(f, r[5]))
            gaps["aperture_gap"].append(ref.aperture_gap(cache[owner], product, None, t_index,
                                                         control))
        del gaps["halo_gap"], gaps["linpsf_gap"]
    for name, vals in gaps.items():
        # A kind of product that never came is a failure of the mix:
        out[name] = max(vals) if vals else ref.NO_MATCH
        out["n_" + name.rsplit("_", 1)[0]] = len(vals)
    if "halo_truth_gap" in gaps:
        # The median halo product: the worst one swings from seed to seed,
        # where one star's weights fall on faint, noisy pixels (PERF.md, section 2).
        vals = gaps["halo_truth_gap"]
        out["halo_truth_worst"] = out["halo_truth_gap"]
        out["halo_truth_gap"] = float(np.median(vals)) if vals else ref.NO_MATCH
    return out


def program_control(cfg, mix, seed, device, work, seconds):
    """The program's own bfloat16 path as the control: the drain on a
    context of bfloat16 planes, judged against the seed's float32 cube made
    again once the bfloat16 one is freed.  None where the configuration
    reads pixel files (a TPF context has no bfloat16 path)."""
    if cfg["datasource"] != "ffi":
        return None
    state = setup(cfg, mix, seed, device, work, dtype=torch.bfloat16)
    window(state, seconds)
    kw = state["sec"]["ctx_kw"]
    for k in ("images", "images_err", "backgrounds", "pixelflags"):
        kw[k] = None
    if device.type == "cuda":
        torch.cuda.empty_cache()
    planes, _, _ = ffi.cube(cfg, mix, seed, device)
    return check(state, planes=planes[:3])


def faults():
    """Faults planted in the program, each where its answer is produced, for
    the truth numbers' upper readings (``readings.py --fault-seeds``) and
    the CPU tests: each context manager patches the program while it is
    open."""
    from photometry_tpu_torch.core import engine
    from photometry_tpu_torch.models import halo, linpsf
    masks, solve, halo_batch = engine.build_masks_batch, linpsf.linpsf_timeseries_batch, \
        halo.extract_halo_batch

    def shifted_masks(*a, **kw):
        out = masks(*a, **kw)
        out["mask"] = torch.roll(out["mask"], 2, dims=-2)
        return out

    def wrong_star(*a, **kw):
        out = solve(*a, **kw)
        out["fluxes"] = torch.roll(out["fluxes"], 1, dims=-1)
        return out

    def wrong_target(*a, **kw):
        out = halo_batch(*a, **kw)
        curves = [res.lightcurve.get("flux") for res in out]
        for res, flux in zip(out, curves[1:] + curves[:1]):
            if flux is not None and res.lightcurve.get("flux") is not None:
                res.lightcurve["flux"] = flux
        return out
    return {
        "K2P2 masks two rows off": lambda: mock.patch.object(engine, "build_masks_batch",
                                                             shifted_masks),
        "linPSF flux of the next star of the fit": lambda: mock.patch.object(
            linpsf, "linpsf_timeseries_batch", wrong_star),
        "halo light curves of the next target": lambda: mock.patch.object(
            halo, "extract_halo_batch", wrong_target),
    }
