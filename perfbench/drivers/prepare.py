"""Drive ``prepare.prepare_cube`` over a stack of raw FFIs, and judge its store.

Set-up writes the configuration's ``n_times`` raw FFIs of its CCD
(``gen.prepare``), and prepares the first ``warm_frames`` of them once
(the kernels built or loaded).  The window then runs whole prepares of
all the frames, each into a fresh in-memory store (``gen.store``; the
card's machine has no h5py for a cube file), stages 1-5 with the options
``prepare_cmd`` uses by default, until the seconds are spent.
"""

import contextlib
import os
from unittest import mock

import numpy as np
import torch

from ..gen import prepare as gen
from ..gen.store import Store
from ..reference import prepare as ref


def setup(cfg, mix, seed, device, work, dtype=torch.float32):
    from photometry_tpu_torch import prepare as prep
    from photometry_tpu_torch.io.tess import read_ffi
    folder = os.path.join(work, "ffi")
    files, cal, unc, sky = gen.frames(cfg, seed, device, folder)
    header = prep._cube_header(read_ffi(files[0]), cfg["sector"], cfg["camera"], cfg["ccd"])
    sample = np.random.default_rng([seed, 2]).choice(
        cfg["rows"] * cfg["cols"], min(mix["check"]["sample_pixels"], cfg["rows"] * cfg["cols"]),
        replace=False)
    state = {"cfg": cfg, "mix": mix, "seed": seed, "device": device, "files": files,
             "folder": folder, "cal": cal, "unc": unc, "sky": sky, "sample": np.sort(sample),
             "header": header, "stores": []}
    warm = mix["warm_frames"]
    prepare_once(state, files[:warm])
    state["stores"].clear()
    sync(device)
    return state


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prepare_once(state, files):
    from photometry_tpu_torch import prepare as prep
    cfg = state["cfg"]
    store = Store(len(files), (cfg["rows"], cfg["cols"]), header=state["header"],
                  sample=state["sample"])
    walls = prep.prepare_cube(store, files, state["folder"], cfg["sector"], cfg["camera"],
                              cfg["ccd"], device=state["device"], chunk=state["mix"]["chunk"])
    state["stores"].append((store, walls))
    return walls


def span_targets():
    """The prepare stage's entry points that a traced run times from outside;
    what the inner ones leave of ``prepare_cube`` is mostly stage 1's FITS
    reading between its background fits."""
    from photometry_tpu_torch import prepare as prep
    return [(prep, "prepare_cube", "prepare (FITS reading of stage 1, stages 4-5)"),
            (prep, "background_flags", "background fit"),
            (prep, "smooth_backgrounds", "smoothing"),
            (prep, "_images_stage", "images"),
            (prep, "_shenanigans_stage", "shenanigans"),
            (prep, "shenanigans_residual", "median")]


@contextlib.contextmanager
def median_recorder(launches):
    """Keep the shape of every launch of the median kernel (for its bytes)."""
    from photometry_tpu_torch.ops import median15
    run = median15.median15_cuda

    def recorded(x):
        launches.append(tuple(x.shape))
        return run(x)
    with mock.patch.object(median15, "median15_cuda", recorded):
        yield


def window(state, seconds, trace=False):
    """Whole prepares until ``seconds`` are spent; returns what the metrics read."""
    from photometry_tpu_torch import prepare as prep
    from .. import trace as tr
    launches = []
    window_s, summary = tr.window(lambda: prepare_once(state, state["files"]), seconds,
                                  state["device"], trace, span_targets(),
                                  median_recorder(launches))
    walls = {}
    for _, w in state["stores"]:
        for k, v in w.items():
            walls[k] = walls.get(k, 0) + v
    n = len(state["stores"])
    frames = n * len(state["files"])
    done = sum(set(prep.STAGES) <= store.stages for store, _ in state["stores"])
    run = {"window_s": window_s, "prepares": n, "n_frames": frames, "prepare_walls": walls,
           "prepare_s": [sum(w.values()) for _, w in state["stores"]],
           "attempted": frames, "failed": (n - done) * len(state["files"])}
    if trace:
        # each launch reads its (F, H, W) float32 frames once and writes as many medians
        run.update(trace=summary, median_launches=len(launches),
                   median_bytes=sum(8 * int(np.prod(s)) for s in launches))
    return run


def check(state, run=None, control=None):
    """The reference's numbers for every store of the window: unfinished
    stores; the backgrounds of each against the sky the benchmark drew, and
    against the time smoothing of its raw ones at the sampled pixels; its
    images and errors; and the residual gap and shenanigans mismatch of one
    store drawn from the seed."""
    from photometry_tpu_torch import prepare as prep
    dev, chk = state["device"], state["mix"]["check"]
    out = {"unfinished": sum(not set(prep.STAGES) <= s.stages for s, _ in state["stores"]),
           "smooth_gap": 0.0, "images_gap": 0.0}
    on = lambda a: torch.as_tensor(a, device=dev)        # noqa: E731
    sky = state["sky"]
    for store, _ in state["stores"]:
        a = store.arrays
        for k, v in ref.sky_gaps(on(a["backgrounds"]), sky["glow"], sky["drift"],
                                 chk["time_smooth"], control).items():
            out[k] = max(out.get(k, v), v)
        got = a["backgrounds"].reshape(len(a["backgrounds"]), -1)[:, store.sample]
        out["smooth_gap"] = max(out["smooth_gap"], ref.smooth_gap(
            on(store.raw_sample), on(got), chk["time_smooth"], control))
        out["images_gap"] = max(out["images_gap"], ref.images_gap(
            state["cal"], state["unc"], on(a["backgrounds"]), on(a["pixelflags"]),
            on(a["images"]), on(a["images_err"]), chk["exclude_bits"], control))
    pick = int(np.random.default_rng([state["seed"], 1]).integers(len(state["stores"])))
    store = state["stores"][pick][0]
    # the quality the images stage read: each frame's header (the store's
    # vector also holds the TPF's flags, which stage 4 adds afterwards)
    quality = [int(state["cfg"]["flagged_frames"].get(str(k), 0))
               for k in range(len(state["files"]))]
    noise = float(state["unc"].median())                 # the noise of one pixel
    out["resid_gap"], out["shenanigans_mismatch"] = ref.shenanigans_check(
        on(store.arrays["images"]), quality, on(store.residuals), on(store.arrays["pixelflags"]),
        chk["bad_quality"], chk["shenanigans_threshold"], noise, control)
    return out


def faults():
    """Faults planted in the program where its answer is produced, for the
    sky number's upper reading (``readings.py --fault-seeds``) and the CPU
    tests."""
    import functools
    from photometry_tpu_torch import prepare as prep
    fit = prep.estimate_background
    return {"background fit with one clipping pass": lambda: mock.patch.object(
                prep, "estimate_background", functools.partial(fit, bkgiters=1)),
            "background fit without the catalog's source mask": lambda: mock.patch.object(
                prep, "_catalog_source_mask", lambda *a, **kw: None)}
