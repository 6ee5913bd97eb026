"""
Method dispatcher for task batches, on the port's engine.

Port of ``photometry_tpu/core/dispatcher.py`` (reference tessphot.py:52-135):
``open_context``, ``ContextCache``, ``photometry_batch`` over the methods
aperture, psf, linpsf and halo, the automatic halo switch (inline, or
deferred across leases by ``HaloSwitchQueue``), the automatic linPSF deblend
switch, ``photometry_single`` and the threaded product writer.

Failures of the photometry itself become STATUS.ERROR results carrying the
traceback, as in the reference (tessphot.py:20-49), and a switch whose rerun
fails keeps the aperture results — except what says the port or the card
cannot do the work: ``NotImplementedError``, a CUDA kernel's ``KernelError``
and ``torch.OutOfMemoryError`` propagate, from a method group, from either
switch's rerun and from a queue's flush alike.  With ``plot_folder``, each
OK/WARNING result's diagnostic figures are rendered (``diagnostics``, which
needs matplotlib only then); the deblend switch's linPSF rerun then keeps
its fit image too, so that a switched blend gets its ``psf_fit`` figure.
"""

from __future__ import annotations

import functools
import logging
import os
import traceback
from timeit import default_timer as _timer
from typing import Optional

import torch

from ..device import resolve_device
from ..io.settings import load_settings
from ..ops._kernels import KernelError
from ..utils.logutils import capture_warnings
from ..utils.mathutils import mag2flux
from .engine import SectorContext, TargetResult, TpfContext, extract_aperture_batch
from .status import STATUS

logger = logging.getLogger(__name__)

__all__ = ["photometry_batch", "photometry_single", "open_context", "default_time_corrector",
           "ContextCache", "HaloSwitchQueue"]

_HALO_SWITCH_ERRORS = ("Too many stamp resizes.",
                       "Stamp resize hit limit. Haloswitch quick break.")

#: What says the port or the card cannot do the work: never a target's
#: failure, so neither a method group nor a switch's rerun turns it into
#: results.
_PROPAGATE = (NotImplementedError, KernelError, torch.OutOfMemoryError)


@functools.lru_cache(maxsize=1)
def default_time_corrector():
    """Shared TimeCorrector from the cached spacecraft ephemeris (synthesized
    and cached when absent; never downloaded).  None when disabled in
    settings ([timecorr] pertarget), as in the reference (dispatcher.py:43-63)."""
    settings = load_settings()
    if not settings.getboolean("timecorr", "pertarget", fallback=True):
        return None
    from .timecorr import TimeCorrector, load_cached_ephemeris
    return TimeCorrector(load_cached_ephemeris())


class ContextCache:
    """Reuse device-resident FFI contexts across task batches of one CCD.

    TPF contexts are per target: never cached, and a TPF batch does not
    evict the FFI context held (``get`` returns ``cached=False`` for them,
    so the caller's ``release`` closes them).  ``mesh`` (a
    ``parallel.mesh.Mesh``) shards every FFI context's cubes over it.
    """

    def __init__(self, capacity: int = 1, device="cuda", mesh=None):
        self.capacity = max(capacity, 1)
        self.device = device
        self.mesh = mesh
        self._items: "dict[tuple, SectorContext]" = {}

    def get(self, input_folder: str, task: dict):
        if task["datasource"] != "ffi":
            return open_context(input_folder, task, device=self.device), False
        key = (input_folder, int(task["sector"]), int(task["camera"]), int(task["ccd"]))
        ctx = self._items.pop(key, None)
        if ctx is None:
            ctx = open_context(input_folder, task, device=self.device, mesh=self.mesh)
            while len(self._items) >= self.capacity:
                # evict the least recently used context (hits re-insert):
                self._items.pop(next(iter(self._items))).close()
        self._items[key] = ctx
        return ctx, True

    def close(self):
        for ctx in self._items.values():
            ctx.close()
        self._items.clear()

    def release(self, ctx, cached: bool):
        """Close a context that did not come from the cache."""
        if not cached:
            ctx.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def open_context(input_folder: str, task: dict, cache: str = "device", device="cuda",
                 mesh=None):
    """The context of a task, on ``device``: a SectorContext for ``ffi``
    (its cubes on the device, time-sharded over ``mesh`` when one is given
    (a ``parallel.mesh.Mesh``), or on the host with ``cache="host"``), a
    TpfContext for ``tpf`` (the task's own star) and for ``tpf:NNN`` (a
    secondary target in star NNN's TPF), which ignores ``cache`` and
    ``mesh`` (photometry_tpu/core/dispatcher.py:115-135)."""
    ds = task["datasource"]
    if ds == "ffi":
        return SectorContext(input_folder, int(task["sector"]), int(task["camera"]),
                             int(task["ccd"]), cache=cache,
                             time_corrector=default_time_corrector(), mesh=mesh,
                             device=device)
    starid = int(ds[4:]) if ds.startswith("tpf:") else int(task["starid"])
    return TpfContext(input_folder, starid, sector=int(task["sector"]),
                      cadence=int(task["cadence"]), device=device)


def _error_result(task, ctx, tb: str) -> TargetResult:
    return TargetResult(
        starid=int(task["starid"]), method="error", status=STATUS.ERROR,
        sector=int(task.get("sector") or 0), camera=int(task.get("camera") or 0),
        ccd=int(task.get("ccd") or 0), cadence=int(task.get("cadence") or 0),
        data_rel=getattr(ctx, "data_rel", 0) or 0, target={},
        lightcurve={}, details={"errors": [tb]})


def _needs_halo_switch(res: TargetResult, tmag_limit: float, flux_limit: float) -> bool:
    """Reference tessphot.py:86-111 auto-switch condition."""
    if res.target.get("tmag", 99) > tmag_limit:
        return False
    errors = res.details.get("errors", []) or []
    if res.status == STATUS.ERROR and any(e in errors for e in _HALO_SWITCH_ERRORS):
        return True
    edge_flux = res.details.get("edge_flux")
    if edge_flux is not None and res.status in (STATUS.OK, STATUS.WARNING, STATUS.ERROR):
        if edge_flux / float(mag2flux(res.target["tmag"])) > flux_limit:
            return True
    return False


def _needs_deblend_switch(res: TargetResult, settings) -> bool:
    """Reference dispatcher.py:421-441 linPSF deblend-switch condition."""
    completeness_limit = settings.getfloat("deblend", "completeness_limit", fallback=0.9)
    radius = settings.getfloat("deblend", "neighbour_radius", fallback=6.0)
    if (completeness_limit <= 0 or res.method != "aperture"
            or res.status not in (STATUS.OK, STATUS.WARNING)):
        return False
    comp = res.details.get("completeness")
    near_any = res.details.get("nearest_neighbour_px")
    near_sig = res.details.get("nearest_significant_neighbour_px")
    is_blend = near_sig is not None and near_sig <= radius
    truncated = (comp is not None and comp < completeness_limit
                 and near_any is not None and near_any <= radius)
    return is_blend or truncated


def _run_method(ctx, starids, method: str, keep_diag: bool = False, **kw) -> list:
    if method == "aperture":
        return extract_aperture_batch(ctx, starids, **kw)
    if method == "halo":
        from ..models.halo import extract_halo_batch
        return extract_halo_batch(ctx, starids, **kw)
    if method == "psf":
        from ..models.psf_fit import extract_psf_batch
        return extract_psf_batch(ctx, starids, keep_diag=keep_diag, **kw)
    if method == "linpsf":
        from ..models.linpsf import extract_linpsf_batch
        return extract_linpsf_batch(ctx, starids, keep_diag=keep_diag, **kw)
    raise ValueError(f"Invalid method: '{method}'")


def _decorate(res, task):
    res.details.setdefault("task", {}).update({k: task.get(k) for k in ("priority", "datasource")})


def _run_halo_switch(ctx, switch: list, prev_results: dict):
    """Rerun halo photometry for switch candidates, decorated like the
    reference's automatic switch (tessphot.py:86-111): the aperture pass's
    edge_flux is carried over, the switch is recorded in the errors column,
    and captured warnings persist.  Returns the decorated results in task
    order, or None if the halo rerun failed on a target's data (callers
    keep the aperture results); what says the port or the card cannot do
    the work propagates.
    """
    sids = [int(t["starid"]) for t in switch]
    logger.warning("Auto-switching %d target(s) to halo photometry", len(sids))
    try:
        with capture_warnings() as halo_messages:
            out = _run_method(ctx, sids, "halo")
    except _PROPAGATE:
        raise
    except Exception:
        logger.exception("Halo switch failed; keeping aperture results")
        return None
    for t, res in zip(switch, out):
        res.details["edge_flux"] = prev_results[int(t["starid"])].details.get("edge_flux")
        res.details.setdefault("errors", []).append("Automatically switched to Halo photometry")
        if halo_messages:
            res.details["errors"].extend(halo_messages)
        _decorate(res, t)
    return out


class HaloSwitchQueue:
    """Accumulate halo-switch candidates across lease batches.

    A lease of 256 targets yields a handful of switch candidates; they
    queue here so that the halo descent runs over many of them at once, as
    one batch, once ``min_flush`` accumulate ([haloswitch] min_batch,
    default 32, as in the JAX package), when the drain moves
    to another CCD (the queue pins its SectorContext: flush BEFORE the
    ContextCache evicts it), or at the drain's end (``flush(force=True)``).
    """

    def __init__(self, min_flush: Optional[int] = None, timers: Optional[dict] = None):
        if min_flush is None:
            min_flush = load_settings().getint("haloswitch", "min_batch", fallback=32)
        self.min_flush = max(int(min_flush), 1)
        self._ctx = None
        self._items = []      # (task, aperture TargetResult)
        self._save_args = {}
        self._timers = timers

    @property
    def pending(self) -> int:
        return len(self._items)

    def matches(self, task: dict) -> bool:
        """Is the pinned context safe across ``task``'s batch?  An FFI batch
        of another CCD evicts (and closes) it, so the caller flushes first."""
        if self._ctx is None or task["datasource"] != "ffi":
            return True
        return (int(task["sector"]) == self._ctx.sector
                and int(task["camera"]) == self._ctx.camera
                and int(task["ccd"]) == self._ctx.ccd)

    def add(self, ctx, task: dict, aperture_result, **save_args):
        assert ctx.datasource == "ffi", "defer only FFI targets"
        assert self._ctx is None or self._ctx is ctx, "flush the queue before switching contexts"
        self._ctx = ctx
        self._save_args = save_args
        self._items.append((task, aperture_result))

    def should_flush(self) -> bool:
        return len(self._items) >= self.min_flush

    def flush(self, force: bool = False) -> list:
        """Run the queued halo batch; returns resolved ``(task, result)``.

        Below ``min_flush`` and not ``force``, returns [] (keeps queueing).
        If the halo rerun fails on the targets' data, the aperture results
        are resolved instead.  Light-curve products are written here with
        the save arguments captured at add-time.
        """
        if not self._items or (not force and not self.should_flush()):
            return []
        items, ctx = self._items, self._ctx
        self._items, self._ctx = [], None
        tasks = [t for t, _ in items]
        tic = _timer()
        out = _run_halo_switch(ctx, tasks, {int(t["starid"]): r for t, r in items})
        if self._timers is not None:
            self._timers["photometry"] += _timer() - tic
        if out is None:
            out = [r for _, r in items]
            for r in out:
                r.details.pop("halo_switch_deferred", None)
        sa = self._save_args
        if sa.get("save", True):
            _save_results_parallel(ctx, out, sa.get("output_folder"), sa.get("version"),
                                   timers=self._timers)
        if sa.get("plot_folder"):
            _plot_results(ctx, out, sa["plot_folder"])
        return list(zip(tasks, out))


def photometry_batch(ctx, tasks: list, output_folder: Optional[str] = None,
                     version: Optional[int] = None, save: bool = True,
                     plot_folder: Optional[str] = None,
                     halo_queue: Optional[HaloSwitchQueue] = None,
                     timers: Optional[dict] = None) -> list:
    """Run photometry for a batch of compatible tasks on one context.

    Tasks without an explicit method run aperture photometry; of those,
    bright targets matching the halo-switch condition are rerun with halo,
    and blends matching the deblend condition with linPSF.  When ``save``,
    light curves of OK/WARNING results are written.  With ``plot_folder``,
    their diagnostic figures go to ``<plot_folder>/plots/<starid>/``
    (reference BasePhotometry.py:394-397), and the PSF-family extractors
    keep the fit images the figures need.

    With ``halo_queue``, FFI halo-switch candidates are queued for a later
    batched rerun instead of rerunning inline; their interim results come
    back flagged ``details["halo_switch_deferred"]`` and must be withheld
    from save_result until :meth:`HaloSwitchQueue.flush` resolves them.
    ``timers`` (a core.drain.new_timers dict) accumulates the wall of the
    photometry and product-save phases.
    """
    settings = load_settings()
    tmag_limit = settings.getfloat("haloswitch", "tmag_limit", fallback=6.0)
    flux_limit = settings.getfloat("haloswitch", "flux_limit", fallback=0.01)
    by_method = {}
    for task in tasks:
        by_method.setdefault(task.get("method") or "aperture", []).append(task)

    keep_diag = plot_folder is not None
    results = {}
    for method, group in by_method.items():
        tic = _timer()
        # Warnings logged during the photometry are persisted into the
        # diagnostics errors column (BasePhotometry.py:171-179, 1409-1414):
        with capture_warnings() as log_messages:
            try:
                got = _run_method(ctx, [int(t["starid"]) for t in group], method,
                                  keep_diag=keep_diag)
            except _PROPAGATE:
                raise
            except Exception:
                tb = traceback.format_exc().strip()
                logger.exception("Method %s failed for batch", method)
                got = [_error_result(t, ctx, tb) for t in group]
        if timers is not None:
            timers["photometry"] += _timer() - tic
        for task, res in zip(group, got):
            if log_messages:
                res.details.setdefault("errors", []).extend(log_messages)
            _decorate(res, task)
            results[int(task["starid"])] = res

    # Automatic halo switch (default-method targets only):
    default_tasks = [t for t in tasks if not t.get("method")]
    switch = [t for t in default_tasks
              if not str(t["datasource"]).startswith("tpf:")
              and _needs_halo_switch(results[int(t["starid"])], tmag_limit, flux_limit)]
    if switch and halo_queue is not None and ctx.datasource == "ffi":
        # Deferred: the candidates of many leases rerun as one halo batch.
        for t in switch:
            res = results[int(t["starid"])]
            halo_queue.add(ctx, t, res, save=save, output_folder=output_folder,
                           version=version, plot_folder=plot_folder)
            res.details["halo_switch_deferred"] = True
    elif switch:
        tic = _timer()
        out = _run_halo_switch(ctx, switch, results)
        if timers is not None:
            timers["photometry"] += _timer() - tic
        if out is not None:
            for t, res in zip(switch, out):
                results[int(t["starid"])] = res

    # Automatic deblend switch: aperture targets that are blends are rerun
    # with linear-PSF photometry, which fits the blend jointly instead of
    # splitting its pixels at a watershed boundary.
    switched_halo = {int(t["starid"]) for t in switch}
    deblend = [t for t in default_tasks
               if int(t["starid"]) not in switched_halo
               and not str(t["datasource"]).startswith("tpf")
               and _needs_deblend_switch(results[int(t["starid"])], settings)]
    if deblend:
        logger.warning("Auto-switching %d blended target(s) to linPSF photometry", len(deblend))
        tic = _timer()
        try:
            with capture_warnings() as lin_messages:
                out = _run_method(ctx, [int(t["starid"]) for t in deblend], "linpsf",
                                  keep_diag=keep_diag)
        except _PROPAGATE:
            raise
        except Exception:
            logger.exception("Deblend switch failed; keeping aperture results")
            out = []
        for t, res in zip(deblend, out):
            if res.status not in (STATUS.OK, STATUS.WARNING):
                continue  # keep the aperture result on linPSF failure
            prev = results[int(t["starid"])]
            res.details["completeness"] = prev.details.get("completeness")
            for key in ("nearest_neighbour_px", "nearest_significant_neighbour_px"):
                if prev.details.get(key) is not None:
                    res.details[key] = prev.details[key]
            res.details.setdefault("errors", []).append(
                "Automatically switched to linPSF photometry (aperture mask completeness "
                f"{100 * prev.details.get('completeness', float('nan')):.0f}%)")
            if lin_messages:
                res.details["errors"].extend(lin_messages)
            _decorate(res, t)
            results[int(t["starid"])] = res
        if timers is not None:
            timers["photometry"] += _timer() - tic

    out = [results[int(t["starid"])] for t in tasks]
    if save:
        _save_results_parallel(ctx, out, output_folder, version, timers=timers)
    if plot_folder is not None:
        _plot_results(ctx, out, plot_folder)
    return out


def _plot_results(ctx, results: list, plot_folder: str):
    """Diagnostic figures of the OK/WARNING results (deferred halo-switch
    candidates are plotted by their queue's flush)."""
    from ..diagnostics import plot_target_diagnostics
    for res in results:
        if (res.status in (STATUS.OK, STATUS.WARNING)
                and not res.details.get("halo_switch_deferred")):
            plot_target_diagnostics(res, ctx, plot_folder)


def _save_results_parallel(ctx, results: list, output_folder, version,
                           timers: Optional[dict] = None):
    """Write light-curve products for OK/WARNING results on a small thread
    pool (zlib releases the GIL).  A failed write demotes that target to
    STATUS.ERROR with the traceback (BasePhotometry.py:1417-1728).  Deferred
    halo-switch candidates are written by their queue's flush."""
    tic = _timer()
    jobs = []
    for res in results:
        if res.status not in (STATUS.OK, STATUS.WARNING) or res.details.get("halo_switch_deferred"):
            continue
        outdir = output_folder
        if outdir is None:
            outdir = os.path.join(ctx.input_folder, f"c{ctx.cadence:04d}",
                                  f"{res.starid:011d}"[:5])
        jobs.append((res, outdir))
    if not jobs:
        return

    def _write(res, outdir):
        try:
            res.save(outdir, version if version is not None else 1)
        except Exception:
            res.status = STATUS.ERROR
            res.details.setdefault("errors", []).append(traceback.format_exc().strip())

    workers = load_settings().getint("products", "writer_threads", fallback=4)
    if workers <= 0 or len(jobs) == 1:
        for res, outdir in jobs:
            _write(res, outdir)
    else:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=min(workers, len(jobs))) as pool:
            list(pool.map(lambda j: _write(*j), jobs))
    if timers is not None:
        timers["save"] += _timer() - tic
        timers["n_products"] = timers.get("n_products", 0) + len(jobs)


def photometry_single(starid: int, input_folder: str, method: Optional[str] = None,
                      datasource: str = "ffi", sector: Optional[int] = None,
                      camera: Optional[int] = None, ccd: Optional[int] = None,
                      cadence: Optional[int] = None, output_folder: Optional[str] = None,
                      version: Optional[int] = None, save: bool = True,
                      plot_folder: Optional[str] = None, device="cuda") -> TargetResult:
    """One-star entry point (reference tessphot.py call signature), on ``device``."""
    device = resolve_device(device)
    task = {"starid": starid, "datasource": datasource, "sector": sector,
            "camera": camera, "ccd": ccd, "cadence": cadence, "method": method}
    try:
        # Context construction is inside the ERROR contract too (the
        # reference wraps photometry-object construction, tessphot.py:20-49):
        ctx = open_context(input_folder, task, device=device)
    except _PROPAGATE:
        raise
    except Exception:
        return _error_result(task, None, traceback.format_exc().strip())
    try:
        task.update({"sector": ctx.sector, "camera": ctx.camera, "ccd": ctx.ccd,
                     "cadence": ctx.cadence})
        return photometry_batch(ctx, [task], output_folder=output_folder,
                                version=version, save=save, plot_folder=plot_folder)[0]
    finally:
        ctx.close()
