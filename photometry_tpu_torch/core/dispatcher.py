"""
Method dispatcher for task batches, on the port's engine.

Port of the aperture and PSF paths of ``photometry_tpu/core/dispatcher.py``
(reference tessphot.py:52-135): ``open_context``, ``ContextCache``,
``photometry_batch`` and the threaded product writer.  Failures of the
photometry itself become STATUS.ERROR results carrying the traceback, as in
the reference (tessphot.py:20-49) — except what says the port or the card
cannot do the work: ``NotImplementedError``, a CUDA kernel's ``KernelError``
and ``torch.OutOfMemoryError`` propagate.

Not ported yet: the linpsf and halo methods and the automatic halo and
linPSF-deblend switches.  A task asking for one of those methods raises
``NotImplementedError`` naming it, and so does a default-method batch in
which a switch would fire.
"""

from __future__ import annotations

import functools
import logging
import os
import traceback
from timeit import default_timer as _timer
from typing import Optional

import torch

from ..io.settings import load_settings
from ..ops._kernels import KernelError
from ..utils.logutils import capture_warnings
from ..utils.mathutils import mag2flux
from .engine import SectorContext, TargetResult, extract_aperture_batch
from .status import STATUS

logger = logging.getLogger(__name__)

__all__ = ["photometry_batch", "open_context", "default_time_corrector", "ContextCache"]

_HALO_SWITCH_ERRORS = ("Too many stamp resizes.",
                       "Stamp resize hit limit. Haloswitch quick break.")


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
    """Reuse device-resident FFI contexts across task batches of one CCD."""

    def __init__(self, capacity: int = 1, device="cuda"):
        self.capacity = max(capacity, 1)
        self.device = device
        self._items: "dict[tuple, SectorContext]" = {}

    def get(self, input_folder: str, task: dict):
        key = (input_folder, int(task["sector"]), int(task["camera"]), int(task["ccd"]))
        ctx = self._items.pop(key, None)
        if ctx is None:
            ctx = open_context(input_folder, task, device=self.device)
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


def open_context(input_folder: str, task: dict, device="cuda") -> SectorContext:
    """The SectorContext of an FFI task, on ``device``."""
    if task["datasource"] != "ffi":
        raise NotImplementedError(
            f"datasource {task['datasource']!r}: TPF contexts are not ported to "
            "photometry_tpu_torch yet")
    return SectorContext(input_folder, int(task["sector"]), int(task["camera"]),
                         int(task["ccd"]), time_corrector=default_time_corrector(),
                         device=device)


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


def _run_method(ctx, starids, method: str) -> list:
    if method == "aperture":
        return extract_aperture_batch(ctx, starids)
    if method == "psf":
        from ..models.psf_fit import extract_psf_batch
        return extract_psf_batch(ctx, starids)
    raise ValueError(f"Invalid method: '{method}'")


def photometry_batch(ctx, tasks: list, output_folder: Optional[str] = None,
                     version: Optional[int] = None, save: bool = True,
                     timers: Optional[dict] = None) -> list:
    """Run photometry for a batch of compatible tasks on one context.

    Tasks without an explicit method run aperture photometry; each method's
    group runs as one batch.  When ``save``, light curves of OK/WARNING
    results are written.  ``timers`` (a core.drain.new_timers dict)
    accumulates the wall of the photometry and product-save phases.
    """
    settings = load_settings()
    by_method = {}
    for task in tasks:
        by_method.setdefault(task.get("method") or "aperture", []).append(task)
    unported = sorted(set(by_method) & {"linpsf", "halo"})
    if unported:
        raise NotImplementedError(f"method {unported[0]!r} is not ported to "
                                  "photometry_tpu_torch yet (only 'aperture' and 'psf')")

    results = {}
    for method, group in by_method.items():
        tic = _timer()
        # Warnings logged during the photometry are persisted into the
        # diagnostics errors column (BasePhotometry.py:171-179, 1409-1414):
        with capture_warnings() as log_messages:
            try:
                got = _run_method(ctx, [int(t["starid"]) for t in group], method)
            except (NotImplementedError, KernelError, torch.OutOfMemoryError):
                raise   # the port or the card cannot do this work: not a target's failure
            except Exception:
                tb = traceback.format_exc().strip()
                logger.exception("Method %s failed for batch", method)
                got = [_error_result(t, ctx, tb) for t in group]
        if timers is not None:
            timers["photometry"] += _timer() - tic
        for task, res in zip(group, got):
            if log_messages:
                res.details.setdefault("errors", []).extend(log_messages)
            res.details.setdefault("task", {}).update(
                {k: task.get(k) for k in ("priority", "datasource")})
            results[int(task["starid"])] = res
    out = [results[int(t["starid"])] for t in tasks]

    # The automatic halo and deblend switches (default-method tasks only)
    # need methods the port does not have yet:
    tmag_limit = settings.getfloat("haloswitch", "tmag_limit", fallback=6.0)
    flux_limit = settings.getfloat("haloswitch", "flux_limit", fallback=0.01)
    for task, res in zip(tasks, out):
        if task.get("method"):
            continue
        if _needs_halo_switch(res, tmag_limit, flux_limit):
            raise NotImplementedError(
                f"TIC {res.starid}: the automatic halo switch would fire, and method "
                "'halo' is not ported to photometry_tpu_torch yet")
        if _needs_deblend_switch(res, settings):
            raise NotImplementedError(
                f"TIC {res.starid}: the automatic deblend switch would fire, and method "
                "'linpsf' is not ported to photometry_tpu_torch yet")

    if save:
        _save_results_parallel(ctx, out, output_folder, version, timers=timers)
    return out


def _save_results_parallel(ctx, results: list, output_folder, version,
                           timers: Optional[dict] = None):
    """Write light-curve products for OK/WARNING results on a small thread
    pool (zlib releases the GIL).  A failed write demotes that target to
    STATUS.ERROR with the traceback (BasePhotometry.py:1417-1728)."""
    tic = _timer()
    jobs = []
    for res in results:
        if res.status not in (STATUS.OK, STATUS.WARNING):
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
