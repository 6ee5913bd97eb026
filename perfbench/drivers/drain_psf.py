"""Drive ``run_drain(method="psf")`` over an FFI cube drawn with a table PRF,
and judge what it wrote.

Set-up writes the configuration's PRF table in the reference's
``data/psf`` layout and a copy of the program's settings whose ``[psf]
prf_dir`` names it; every drain runs with ``PHOTOMETRY_TPU_SETTINGS``
pointing there, the program's cache of its settings cleared.  Before it
makes the cube, and again on the drain's own context, set-up asks the
program for the context's PRF and raises unless it is the written table
with the configuration's SVD terms: a program that cannot be told its
PRF stops here instead of fitting a Gaussian through a window.  The cube
(``gen.prf.sector``) is handed to ``run_drain`` as in ``drivers.drain``,
whose ``drain_once`` runs each drain; the window runs whole drains until
the seconds are spent.

The check holds the timed path's own products to ``reference.psf`` (a
float64 fit from the configuration's PRF density) and to the field's
truth: ``psf_gap`` on a seeded sample of products whose fit holds one
real star, at the cadences where the fit's pixels are settled (``EDGE``),
``psf_bkg_gap``, ``psf_truth_gap``, ``pair_truth_gap``, and
``prf_not_table``, the instances fitted with any PRF but the table.
"""

import contextlib
import os
import time
import types
from unittest import mock

import numpy as np
import torch

from ..gen import ffi
from ..gen import prf as gprf
from ..reference import drain as ref
from ..reference import psf as rpsf
from . import drain

BLOCK = 16               #: products a block of the reference's fit
#: px: a cadence is held to the reference only where no pixel centre of the
#: stamp lies this close to the 5-px cutoff circle around the target's
#: fitted position (the product's MOM_CENTR).  Closer, a shift of the
#: position far below the two fits' difference moves that pixel's light in
#: or out of the model, and FLUX_RAW by up to ~7e-4.
EDGE = 2e-3


def setup(cfg, mix, seed, device, work, dtype=torch.float32):
    from photometry_tpu_torch.core import dispatcher
    from photometry_tpu_torch.core.engine import SectorContext
    prf_dir = gprf.write_prf_dir(os.path.join(work, "psf"), cfg)
    settings = gprf.settings_file(work, prf_dir)

    @contextlib.contextmanager
    def env():
        # load_settings() is cached: read the file anew inside and after.
        from photometry_tpu_torch.io.settings import load_settings
        with mock.patch.dict(os.environ, {"PHOTOMETRY_TPU_SETTINGS": settings}):
            load_settings.cache_clear()
            try:
                yield
            finally:
                load_settings.cache_clear()
    with env():
        require_table(types.SimpleNamespace(
            shape=(cfg["rows"], cfg["cols"]), sector=cfg["sector"], camera=cfg["camera"],
            ccd=cfg["ccd"], header=dict(cfg["header"]), device=device), cfg, prf_dir)
    sec = gprf.sector(cfg, mix, seed, device, os.path.join(work, "catalog"), dtype)
    state = {"cfg": cfg, "mix": mix, "seed": seed, "device": device, "work": work,
             "drains": [], "sec": sec, "input": os.path.join(work, "input"),
             "crpix": sec["crpix"], "fits": [], "prf_dir": prf_dir}
    os.makedirs(state["input"])
    state["template"] = ffi.write_tasks(work, sec["todo"], sec["tmag"], cfg["cadence_s"])
    truth = sec["truth"]
    state["single"] = {int(s) for s in sec["todo"] if s <= truth["n_field"] and len(
        rpsf.select_stars(int(s) - 1, truth["rows"], truth["cols"], truth["tmag"])) == 1}

    def open_context(*_a, **_kw):
        return SectorContext.from_arrays(**sec["ctx_kw"])

    @contextlib.contextmanager
    def patch():
        with env(), mock.patch.object(dispatcher, "open_context", open_context), \
                prf_recorder(state["fits"]):
            yield
    state["patch"] = patch
    with env():
        state["prf_file"] = require_table(open_context(), cfg, prf_dir)
    # The warm drain: the pairs and the brightest field stars, every stamp size.
    folder = os.path.join(work, "warm")
    os.makedirs(folder)
    ffi.write_tasks(folder, sec["todo"][:mix["warm_tasks"]], sec["tmag"], cfg["cadence_s"])
    drain.drain_once(state, folder, template=os.path.join(folder, "todo.sqlite"))
    drain.sync(device)
    state["fits"].clear()
    return state


def require_table(ctx, cfg, prf_dir):
    """The file of the context's PRF; raises unless the program loaded the
    table under ``prf_dir`` with the configuration's SVD terms."""
    from photometry_tpu_torch.models import psf_common
    prf = psf_common.context_prf(ctx)
    path = prf.info.get("file")
    if not path or not os.path.abspath(path).startswith(os.path.abspath(prf_dir) + os.sep):
        raise RuntimeError(f"the program's PRF is {prf.info}, not the table in {prf_dir}: "
                           "it does not read [psf] prf_dir")
    K = prf._svd_factors()[0].shape[1]
    if K != cfg["prf"]["svd_terms"]:
        raise RuntimeError(f"the table PRF has {K} SVD terms, the configuration "
                           f"{cfg['prf']['svd_terms']}")
    return path


@contextlib.contextmanager
def prf_recorder(fits):
    """Keep (the PRF's file, or None; instances) of every PSF fit."""
    from photometry_tpu_torch.models import psf_fit
    fit = psf_fit.fit_psf_timeseries_batch

    def recorded(images, backgrounds, var_const, p0, valid, mini_ap, target_idx, prf, *a,
                 **kw):
        fits.append((prf.info.get("file"), images.shape[0] * (images.shape[1] + 1)))
        return fit(images, backgrounds, var_const, p0, valid, mini_ap, target_idx, prf, *a,
                   **kw)
    with mock.patch.object(psf_fit, "fit_psf_timeseries_batch", recorded):
        yield


@contextlib.contextmanager
def launch_recorder(launches):
    """Keep (B, S, K, h, w, n_iters) of every launch of the PSF fit kernel."""
    from photometry_tpu_torch.models import psf_fused
    run = psf_fused.fused_warm_fit_cuda

    def recorded(images, backgrounds, var_const, p0, valid, miniw, onehot, prf, shape, S,
                 n_iters):
        launches.append((images.shape[0], S, prf._svd_factors()[0].shape[1], *shape, n_iters))
        return run(images, backgrounds, var_const, p0, valid, miniw, onehot, prf, shape, S,
                   n_iters)
    with mock.patch.object(psf_fused, "fused_warm_fit_cuda", recorded):
        yield


def span_targets():
    from photometry_tpu_torch.models import psf_fit
    return drain.span_targets() + [(psf_fit, "extract_psf_batch", "psf")]


def window(state, seconds, trace=False):
    """Whole drains until ``seconds`` are spent; returns what the metrics read."""
    from .. import trace as tr
    launches = []

    def step():
        k = len(state["drains"])
        folder = os.path.join(state["work"], f"drain{k}")
        tic = time.perf_counter()
        timers = drain.drain_once(state, folder)
        wall = time.perf_counter() - tic
        state["drains"].append((folder, timers, {**tally(state, folder, k), "wall_s": wall}))
    window_s, summary = tr.window(step, seconds, state["device"], trace, span_targets(),
                                  launch_recorder(launches))
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
        shapes = {}
        for a in launches:
            key = ",".join(str(int(x)) for x in a)
            shapes[key] = shapes.get(key, 0) + 1
        run.update(trace=summary, psf_launches=shapes)
    return run


def tally(state, folder, k):
    """Count a drain's rows and keep of its products what the check reads:
    every injected pair's, and a sample drawn from the seed of those whose
    fit holds one real star (``check.psf_sample``); the rest are deleted at
    once."""
    rows = ref.todo_rows(folder)
    done = ref.delivered(folder)
    counts = {"attempted": len(rows), "unfinished": ref.unfinished(folder),
              "errors": sum(r[3] == ref.ERROR for r in rows), "done": len(done)}
    n0 = state["sec"]["truth"]["n_field"]
    pairs = [r for r in done if r[1] > n0]
    single = [r for r in done if r[1] in state["single"]]
    rng = np.random.default_rng([state["seed"], 1, k])
    n = min(state["mix"]["check"]["psf_sample"], len(single))
    kept = pairs + [single[i] for i in sorted(rng.choice(len(single), n, replace=False))]
    keep = {r[0] for r in kept}
    for r in done:
        if r[0] not in keep:
            os.remove(ref.product_path(folder, r[5]))
    counts["kept"] = kept
    return counts


def check(state, run=None, control=None, planes=None):
    """The reference's numbers for every drain of the window.  With
    ``control`` (a dtype), the reference's fit and sums on planes rounded to
    it take the products' place in ``psf_gap`` and ``psf_bkg_gap``."""
    cfg, truth = state["cfg"], state["sec"]["truth"]
    if planes is None:
        kw = state["sec"]["ctx_kw"]
        planes = (kw["images"], kw["backgrounds"])
    n0 = truth["n_field"]
    hdr = cfg["header"]
    var_const = float(np.float32(hdr["NUM_FRM"] * hdr["READNOIS"] ** 2 / hdr["GAIN"] ** 2))
    out = {"unfinished": sum(c["unfinished"] for _, _, c in state["drains"]),
           "prf_not_table": sum(n for f, n in state["fits"] if f != state["prf_file"])}
    gaps = {"psf_gap": [], "psf_bkg_gap": [], "psf_truth_gap": [], "pair_truth_gap": []}
    single = []
    for f, _, c in state["drains"]:
        for r in c["kept"]:
            product = ref.fitsread.read(ref.product_path(f, r[5]))
            aperture, r0, c0, lc = ref.stamp_of(product, state["crpix"])
            want = ref.mag2flux(truth["tmag"][r[1] - 1])
            gaps["psf_bkg_gap"].append(bkg_gap(planes[1], aperture, r0, c0, lc, control))
            if r[1] > n0:
                gaps["pair_truth_gap"].append(ref.constant_gap(lc["FLUX_RAW"], want))
            else:
                flux = np.asarray(lc["FLUX_RAW"], np.float64)
                gaps["psf_truth_gap"].append(abs(float(np.nanmedian(flux)) / want - 1.0)
                                             if np.isfinite(flux).any() else ref.NO_MATCH)
                single.append((r[1], aperture.shape, r0, c0, lc))
    gaps["psf_gap"], out["n_psf_cadences"] = fit_gaps(state, planes, single, var_const,
                                                      control)
    for name, vals in gaps.items():
        out[name] = max(vals) if vals else ref.NO_MATCH
        out["n_" + name.rsplit("_", 1)[0]] = len(vals)
    # The median product: a field star's fit takes in the light of
    # neighbours that are not fitted (beyond 5 px, or faint).
    vals = gaps["psf_truth_gap"]
    out["psf_truth_worst"] = out["psf_truth_gap"]
    out["psf_truth_gap"] = float(np.median(vals)) if vals else ref.NO_MATCH
    return out


def bkg_gap(backgrounds, aperture, r0, c0, lc, control=None) -> float:
    """FLUX_BKG against float64 sums of the backgrounds over the minimum
    aperture (APERTURE bits 2|8), NaN pixels left out."""
    def sums(dtype):
        h, w = aperture.shape
        idx = torch.as_tensor(np.asarray(lc["CADENCENO"], np.int64), device=backgrounds.device)
        bkg = ref._round(backgrounds[idx, r0:r0 + h, c0:c0 + w], dtype)
        m = torch.as_tensor((aperture & 2) != 0, device=bkg.device)[None]
        return torch.nansum(torch.where(m, bkg, 0.0), dim=(1, 2)).cpu().numpy()
    want = sums(None)
    return ref.gap(lc["FLUX_BKG"] if control is None else sums(control), want)


def settled(lc, r0, c0, shape):
    """The cadences at which no pixel centre of the stamp lies within
    ``EDGE`` of the cutoff circle around the target's fitted position."""
    row = np.asarray(lc["MOM_CENTR2"], np.float64) - 1 - r0
    col = np.asarray(lc["MOM_CENTR1"], np.float64) - 1 - c0
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    d = np.hypot(yy[None] - row[:, None, None], xx[None] - col[:, None, None])
    return np.abs(d - rpsf.CUTOFF_RADIUS).min(axis=(1, 2)) > EDGE


def fit_gaps(state, planes, single, var_const, control=None) -> tuple:
    """``psf_gap`` of each sampled one-star product with a settled cadence:
    its FLUX_RAW against the reference's fit of the same stamps, in blocks
    of products of one shape, over its settled cadences; and the number of
    cadences compared."""
    truth = state["sec"]["truth"]
    spline = rpsf.SplinePRF(state["cfg"]["prf"], planes[0].device)
    n = 0
    by_shape = {}
    for item in single:
        by_shape.setdefault(item[1], []).append(item)
    out = []
    for (h, w), items in by_shape.items():
        for i in range(0, len(items), BLOCK):
            block = items[i:i + BLOCK]
            idx = torch.as_tensor(np.asarray(block[0][4]["CADENCENO"], np.int64),
                                  device=planes[0].device)
            stamps = [[planes[k][idx, r0:r0 + h, c0:c0 + w] for _, _, r0, c0, _ in block]
                      for k in (0, 1)]
            rows = np.array([[truth["rows"][s - 1] - r0] for s, _, r0, _, _ in block])
            cols = np.array([[truth["cols"][s - 1] - c0] for s, _, _, c0, _ in block])
            flux0 = rpsf.mag2flux(np.array([[truth["tmag"][s - 1]] for s, *_ in block]))
            mini = np.stack([rpsf.minimum_aperture((h, w), r[0], c[0])
                             for r, c in zip(rows, cols)])

            def fitted(dtype):
                img, bkg = (ref._round(torch.stack(x), dtype) for x in stamps)
                with rpsf.float64_only():
                    return rpsf.fit(spline, img, bkg, var_const, rows, cols, flux0, 0, mini)[0]
            want = fitted(None)
            got = fitted(control) if control is not None else [lc["FLUX_RAW"]
                                                                for *_, lc in block]
            for g, wnt, (_, _, r0, c0, lc) in zip(got, want, block):
                ok = settled(lc, r0, c0, (h, w))
                if ok.any():
                    out.append(ref.gap(np.asarray(g)[ok], wnt[ok]))
                    n += int(ok.sum())
    return out, n


def program_control(cfg, mix, seed, device, work, seconds):
    """None: the control of this cell is the reference's fit on planes
    rounded to bfloat16 (``readings.py``'s ``reference_bf16``, through
    ``check(control=)``), not a bfloat16 drain of the program."""
    return None


def faults():
    """Faults planted in the program where the fit's answer is made, for the
    truth numbers' upper readings: the Gaussian PRF of the cube's PSFSIGMA
    (as a table, so that the card still takes the fused route) in place
    of the configured table, which is what a context without ``[psf]
    prf_dir`` fits; and every fitted star started from the next fitted
    star's position, so that a blend's fit swaps its stars."""
    from photometry_tpu_torch.models import psf_fit
    from photometry_tpu_torch.models.prf import PRF
    fit = psf_fit.fit_psf_timeseries_batch

    def gaussian(ctx, prf=None):
        g = PRF.gaussian(sigma=float(ctx.header.get("PSFSIGMA", 1.25)), device=ctx.device)
        return PRF(g.iprf, g.oversample, g.center_x, g.center_y, device=ctx.device)

    def next_star(images, backgrounds, var_const, p0, valid, *a, **kw):
        S = valid.shape[-1]
        k = valid.sum(dim=-1, keepdim=True).clamp(min=1)
        j = torch.arange(S, device=p0.device)[None]
        nxt = torch.where(j < k, (j + 1) % k, j)
        p0 = torch.cat([p0[:, :S].gather(1, nxt), p0[:, S:2 * S].gather(1, nxt),
                        p0[:, 2 * S:]], dim=1)
        return fit(images, backgrounds, var_const, p0, valid, *a, **kw)
    return {
        "the Gaussian PRF in place of the table": lambda: mock.patch.object(
            psf_fit, "context_prf", gaussian),
        "the fit started from the next star": lambda: mock.patch.object(
            psf_fit, "fit_psf_timeseries_batch", next_star),
    }
