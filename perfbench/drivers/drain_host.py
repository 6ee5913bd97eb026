"""Drive ``run_drain(cache="host")`` over a cube in host memory, and judge
what it wrote.

Set-up first asks the program whether ``run_drain`` takes a ``cache``, and
stops at once with a message where it does not: such a program cannot be
told to keep a cube on the host.  It then makes the seed's cube
(``gen.ffi_host``: drawn on the card 64 frames at a time, each block copied
into pageable host planes, so the card never holds it), and drains a warm
list as ``drivers.drain`` does.  ``core.dispatcher.open_context`` is
replaced by one that builds ``SectorContext.from_arrays`` on the host
planes with the ``cache`` the program passes, and raises unless that is
"host": a drain that does not carry its cache down to its contexts stops.
The window runs whole ``run_drain(cache="host")`` calls one after another
until the seconds are spent.

Each streamed extraction (``core.engine.band_sums_streamed``) is watched:
of the window's passes one is kept, drawn from the seed, with its targets
and its sums over one 128-frame chunk, also drawn from the seed.  The check
is ``drivers.drain``'s (the reference's float64 re-sums over the host
planes and the truth of the field) and ``stream_mismatch``: that chunk of
the four planes copied to the device, the resident path
(``ops.bandext.band_sums``) run on the same targets, and the sums whose
bits differ from the streamed ones counted.  The program promises none.
"""

import contextlib
import gc
import inspect
import os
import shutil
import time
from unittest import mock

import numpy as np
import torch

from ..gen import ffi, ffi_host
from ..reference import drain as ref
from . import drain

CACHE = "host"


def require_cache():
    """Raise unless the program's ``run_drain`` takes a ``cache``."""
    from photometry_tpu_torch.core.drain import run_drain
    if "cache" not in inspect.signature(run_drain).parameters:
        raise RuntimeError("the program's run_drain takes no cache: it cannot drain a cube "
                           "kept in host memory (cache=\"host\")")


def setup(cfg, mix, seed, device, work, dtype=torch.float32):
    require_cache()
    from photometry_tpu_torch.core import dispatcher
    from photometry_tpu_torch.core.engine import SectorContext
    if cfg["cache"] != CACHE:
        raise ValueError(f"the configuration's cache is {cfg['cache']!r}, not {CACHE!r}")
    sec = ffi_host.sector(cfg, mix, seed, device, os.path.join(work, "catalog"), dtype)
    state = {"cfg": cfg, "mix": mix, "seed": seed, "device": device, "work": work,
             "drains": [], "sec": sec, "input": os.path.join(work, "input"),
             "crpix": sec["crpix"]}
    os.makedirs(state["input"])
    state["template"] = ffi.write_tasks(work, sec["todo"], sec["tmag"], cfg["cadence_s"])

    def open_context(_input_folder, _task, cache="device", **_kw):
        if cache != CACHE:
            raise RuntimeError(f"the program opened an FFI context with cache={cache!r}: "
                               f"run_drain(cache={CACHE!r}) does not reach its contexts")
        return SectorContext.from_arrays(**sec["ctx_kw"], cache=cache)

    @contextlib.contextmanager
    def patch():
        with mock.patch.object(dispatcher, "open_context", open_context), \
                stream_recorder(state):
            yield
    state["patch"] = patch
    watch(state)
    nb, npair = sec["n_bright"], sec["n_pairs"]
    warm = sec["todo"][:nb + npair] + sec["todo"][nb + npair:][:max(
        mix["warm_tasks"] - nb - npair, 0)]
    folder = os.path.join(work, "warm")
    os.makedirs(folder)
    ffi.write_tasks(folder, warm, sec["tmag"], cfg["cadence_s"])
    drain_once(state, folder, template=os.path.join(folder, "todo.sqlite"))
    drain.sync(device)
    return state


def watch(state):
    """Start watching the streamed passes afresh: none seen, none kept."""
    state.update(stream_rng=np.random.default_rng([state["seed"], 2]), n_passes=0,
                 kept_pass=None)


@contextlib.contextmanager
def stream_recorder(state):
    """Keep one of the streamed passes, each kept in place of the one held
    with chance 1/(passes seen) (so the seed draws it evenly from all),
    with its targets and its sums over one chunk drawn from the seed."""
    from photometry_tpu_torch.core import engine
    run = engine.band_sums_streamed

    def recorded(images, images_err, backgrounds, pixelflags, masks, r0s, c0s, windows=None,
                 *, device, chunk=128):
        out = run(images, images_err, backgrounds, pixelflags, masks, r0s, c0s, windows,
                  device=device, chunk=chunk)
        state["n_passes"] += 1
        rng = state["stream_rng"]
        if rng.random() * state["n_passes"] < 1.0:
            T = out.shape[-1]
            t0 = int(rng.integers(-(-T // chunk))) * chunk
            t1 = min(t0 + chunk, T)
            state["kept_pass"] = {
                "masks": masks.clone(), "r0s": r0s.clone(), "c0s": c0s.clone(),
                "windows": None if windows is None else windows.clone(), "t0": t0, "t1": t1,
                "sums": out[:, :, t0:t1].clone()}
        return out
    with mock.patch.object(engine, "band_sums_streamed", recorded):
        yield


def drain_once(state, folder, template=None):
    """``drivers.drain.drain_once`` with ``cache="host"`` handed to ``run_drain``."""
    from photometry_tpu_torch.core.drain import new_timers, run_drain
    os.makedirs(folder, exist_ok=True)
    todo = os.path.join(state["input"], "todo.sqlite")
    shutil.copyfile(template or state["template"], todo)
    timers = new_timers()
    with state["patch"]():
        run_drain(state["input"], 1, products_folder=os.path.join(folder, "products"),
                  method=state["mix"]["method"], batch_size=state["mix"]["batch_size"],
                  timers=timers, device=state["device"], cache=CACHE)
    shutil.move(todo, os.path.join(folder, "todo.sqlite"))
    return timers


def span_targets():
    from photometry_tpu_torch.core import engine
    return drain.span_targets() + [(engine, "_extract_flux_streamed", "stream")]


def window(state, seconds, trace=False):
    """Whole drains until ``seconds`` are spent; returns what the metrics read."""
    from .. import trace as tr
    watch(state)

    def step():
        k = len(state["drains"])
        folder = os.path.join(state["work"], f"drain{k}")
        tic = time.perf_counter()
        timers = drain_once(state, folder)
        wall = time.perf_counter() - tic
        state["drains"].append((folder, timers,
                                {**drain.tally(state, folder, k), "wall_s": wall}))
    window_s, summary = tr.window(step, seconds, state["device"], trace, span_targets())
    timers = {}
    for _, t, _ in state["drains"]:
        for k, v in t.items():
            timers[k] = timers.get(k, 0) + v
    counts = [c for _, _, c in state["drains"]]
    run = {"window_s": window_s, "drains": len(counts), "timers": timers,
           "drain_s": [c["wall_s"] for c in counts], "stream_passes_seen": state["n_passes"],
           "n_tasks": sum(c["done"] for c in counts),
           "attempted": sum(c["attempted"] for c in counts),
           "failed": sum(c["unfinished"] + c["errors"] for c in counts)}
    if trace:
        run["trace"] = summary
    return run


def check(state, run=None, control=None, planes=None):
    """``drivers.drain.check`` on the host planes (``planes``: the four of
    the float32 cube made again, where the drain ran on a bfloat16 one),
    and ``stream_mismatch``."""
    if planes is None:
        kw = state["sec"]["ctx_kw"]
        planes = tuple(kw[k] for k in ("images", "images_err", "backgrounds", "pixelflags"))
    out = drain.check(state, run, control, planes[:3])
    out["stream_mismatch"] = stream_mismatch(state, planes, control)
    return out


def stream_mismatch(state, planes, control=None) -> float:
    """Sums of the kept pass's chunk whose bits differ from the resident
    path's on the same chunk of ``planes`` (its value planes rounded to
    ``control`` first, where given); ``NO_MATCH`` where nothing streamed."""
    from photometry_tpu_torch.ops import bandext
    kept = state.get("kept_pass")
    if kept is None:
        return ref.NO_MATCH
    dev = state["device"]
    t0, t1 = kept["t0"], kept["t1"]
    chunk = [p[t0:t1].to(dev) for p in planes]
    if control is not None:
        chunk = [p.to(control) for p in chunk[:3]] + chunk[3:]
    want = bandext.band_sums(*chunk, kept["masks"], kept["r0s"], kept["c0s"], kept["windows"])
    got = kept["sums"]
    if want.shape != got.shape:
        return ref.NO_MATCH
    differ = want.contiguous().view(torch.int32) != got.contiguous().view(torch.int32)
    return int(differ.sum())


def program_control(cfg, mix, seed, device, work, seconds):
    """The program's own bfloat16 path as the control: the same streamed
    drain on a bfloat16 host cube, judged against the seed's float32 cube
    made again, on the device (``ffi.cube``: the same bits as the host
    cube's), once the bfloat16 one is freed: the host never holds both."""
    state = setup(cfg, mix, seed, device, work, dtype=torch.bfloat16)
    window(state, seconds)
    kw = state["sec"]["ctx_kw"]
    for k in ("images", "images_err", "backgrounds", "pixelflags"):
        kw[k] = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    planes, _, _ = ffi.cube(cfg, mix, seed, device)
    return check(state, planes=planes)


def faults():
    """``drivers.drain``'s three faults, and one on the stream: every
    frame's sums written one chunk (128 frames) late, the last chunk's
    wrapping round to the first."""
    from photometry_tpu_torch.core import engine
    run = engine.band_sums_streamed

    def late(*a, chunk=128, **kw):
        return torch.roll(run(*a, chunk=chunk, **kw), chunk, dims=-1)
    return {**drain.faults(),
            "each chunk's sums one chunk late": lambda: mock.patch.object(
                engine, "band_sums_streamed", late)}
