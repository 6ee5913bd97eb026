"""
The production drain loop: lease task batches, run photometry, write
products, persist diagnostics.

Port of ``photometry_tpu/core/drain.py`` (reference run_tessphot.py:124-166
and the per-task unit of run_tessphot_mpi.py:148-196): batches are leased
per (sector, camera, ccd, datasource, cadence) so one device context serves
hundreds of targets, and halo-switch candidates accumulate across leases in
a ``HaloSwitchQueue``.  :func:`drain_lease` is one lease's work, the
same for ``run_drain`` and the scheduler's workers (``parallel.scheduler``),
and :func:`task_to_result` builds every diagnostics row they store.  The
optional ``timers`` dict decomposes the wall into the pipeline's phases:
``run_drain`` opens the process's recorder (``utils.profiling``) on it, and
the spans and counters of every layer below add into it.  A worker opens
no recorder, so there they add nowhere.
"""

from __future__ import annotations

import logging
from timeit import default_timer
from typing import Optional

from ..taskmanager import TaskManager
from ..utils.profiling import StageTimer, count, span
from .dispatcher import ContextCache, HaloSwitchQueue, photometry_batch

__all__ = ["run_drain", "drain_lease", "flush_halo", "task_to_result", "new_timers"]

logger = logging.getLogger(__name__)


def task_to_result(task, res, elaptime, worker_wait_time=None) -> dict:
    """Diagnostics row for TaskManager.save_result (taskmanager.py:435-603)."""
    details = dict(res.details)
    details["skip_targets"] = res.skip_targets
    details.pop("halo_weightmap", None)  # bulk data, not a diagnostic
    return {
        "priority": task["priority"], "starid": task["starid"],
        "sector": task["sector"], "camera": task["camera"], "ccd": task["ccd"],
        "cadence": task["cadence"], "datasource": task["datasource"],
        "tmag": task["tmag"], "status": res.status, "method_used": res.method,
        "time": elaptime, "worker_wait_time": worker_wait_time,
        "details": details,
    }


def new_timers() -> dict:
    """Fresh accumulator for run_drain's wall decomposition (seconds) and
    its counters.  Every key is present, at 0 where its path never ran.

    Phases of the drain loop: ``lease``, ``context``, ``photometry``,
    ``save``, ``sqlite``, ``wall``.  Inside them: ``aperture``, ``halo``,
    ``linpsf``, ``psf`` (each method's extraction, forced or chosen by a
    switch; their sum is at most ``photometry``), ``psf.setup``,
    ``psf.gather``, ``psf.fit`` and ``psf.results`` (the steps of a PSF
    extraction, inside ``psf``), ``context.read`` (a TPF
    read from its file) and ``context.upload`` (a context's planes copied
    to the device), ``save.compress`` (gzip in the product writer's
    threads, summed over them); on a host context (``cache="host"``)
    ``aperture.stream`` (each streamed extraction, inside ``aperture``,
    up to its last chunk's copies and launch) and ``stamps.host`` (the PSF
    and linPSF stamps gathered on the host and moved to the device).
    Counters: ``n_done``, ``n_batches``, ``n_products``,
    ``fits_bytes`` (HDU data bytes decoded by ``io.fits.read_fits``),
    ``fits_table_bytes`` (those of them in numeric table columns),
    ``psf_instances`` (PSF fit instances, one target at one cadence, as
    handed to the fitter) and ``psf_fused_instances`` (those of them that
    the fused kernel fitted); on a host context ``stream_passes`` (streamed
    extractions), ``stream_bytes`` (the host planes' bytes they copied to
    the device), ``stream_staged_bytes`` (those of them that went through
    the pinned staging buffers) and ``host_stamp_bytes`` (the stamps'
    bytes moved to the device).
    """
    return {"lease": 0.0, "context": 0.0, "photometry": 0.0, "save": 0.0,
            "sqlite": 0.0, "wall": 0.0, "n_done": 0, "n_batches": 0, "n_products": 0,
            "aperture": 0.0, "halo": 0.0, "linpsf": 0.0, "psf": 0.0, "context.read": 0.0,
            "context.upload": 0.0, "save.compress": 0.0, "fits_bytes": 0,
            "fits_table_bytes": 0, "psf.setup": 0.0, "psf.gather": 0.0, "psf.fit": 0.0,
            "psf.results": 0.0, "psf_instances": 0, "psf_fused_instances": 0,
            "aperture.stream": 0.0, "stamps.host": 0.0, "stream_passes": 0, "stream_bytes": 0,
            "stream_staged_bytes": 0, "host_stamp_bytes": 0}


def flush_halo(halo_queue: Optional[HaloSwitchQueue], force: bool = False) -> list:
    """Resolve the queued halo-switch candidates (all of them with
    ``force``, else once ``min_flush`` are queued) into rows ready to store."""
    if halo_queue is None or not halo_queue.pending:
        return []
    tic = default_timer()
    flushed = halo_queue.flush(force=force)
    elap = (default_timer() - tic) / max(len(flushed), 1)
    return [task_to_result(tk, res, elap) for tk, res in flushed]


def drain_lease(ctx_cache: ContextCache, halo_queue: Optional[HaloSwitchQueue],
                input_folder: str, batch: list, rows: list, *, worker_wait_time=None,
                output_folder: Optional[str] = None, version: Optional[int] = None,
                plot_folder: Optional[str] = None) -> list:
    """One leased batch's work, for ``run_drain`` and the scheduler's workers:
    flush ``halo_queue`` if the batch is of another CCD (before ``ctx_cache``
    evicts the context it pins), ``photometry_batch`` with the products'
    arguments, hold back the rows of deferred halo-switch candidates (leased
    until their flush), and flush the queue once full.  Appends the rows
    ready to store to ``rows`` as they come, so that a caller whose lease
    fails keeps those of a flush before the failure; returns ``rows``."""
    if halo_queue is not None and not halo_queue.matches(batch[0]):
        rows += flush_halo(halo_queue, force=True)
    tic = default_timer()
    with span("context"):
        ctx, cached = ctx_cache.get(input_folder, batch[0])
    try:
        results = photometry_batch(ctx, batch, output_folder=output_folder, version=version,
                                   plot_folder=plot_folder, halo_queue=halo_queue)
    finally:
        ctx_cache.release(ctx, cached)
    elap = (default_timer() - tic) / len(batch)
    rows += [task_to_result(tk, res, elap, worker_wait_time) for tk, res in zip(batch, results)
             if not res.details.get("halo_switch_deferred")]
    if halo_queue is not None and halo_queue.should_flush():
        rows += flush_halo(halo_queue)
    return rows


def run_drain(input_folder: str, version: int,
              output_folder: Optional[str] = None,
              products_folder: Optional[str] = None,
              *, all_tasks: bool = True, random_task: bool = False,
              batch_size: int = 256, method: Optional[str] = None,
              constraints: Optional[dict] = None, plot: bool = False,
              summary: Optional[str] = None, timers: Optional[dict] = None,
              device="cuda", mesh=None, cache: str = "device") -> int:
    """Drain the TODO queue (or one task) through the batch dispatcher on ``device``.

    Arguments as the reference's ``run_drain``; ``method`` forces one of
    aperture, psf, linpsf or halo for every task, None keeps the tasks' own
    (aperture with both automatic switches by default); ``plot`` renders
    each OK/WARNING task's diagnostic figures into
    ``<output_folder>/plots/<starid>/``; ``mesh`` (a ``parallel.mesh.Mesh``
    of ``device``'s type) shards every FFI context's cubes over it and
    extracts once per mesh block; ``cache="host"`` keeps every FFI
    context's cubes in host memory, for a card that does not hold them:
    each extraction streams them through ``device`` (``SectorContext``;
    a mesh is then kept and not applied).  Returns the number of tasks
    processed.
    """
    constraints = dict(constraints or {})
    output_folder = output_folder or input_folder
    recorder = StageTimer(timers if timers is not None else new_timers())
    with recorder.recording(), span("wall"), \
            TaskManager(input_folder, cleanup=all_tasks, summary=summary) as tm, \
            ContextCache(device=device, mesh=mesh, cache=cache) as ctx_cache:
        n_done = 0
        # Halo-switch candidates accumulate across lease batches and rerun
        # as one halo batch; single-task modes keep the inline switch:
        halo_queue = HaloSwitchQueue() if all_tasks and not method else None

        def store(rows):
            nonlocal n_done
            with span("sqlite"):
                tm.save_results(rows)
            n_done += len(rows)
            for row in rows:
                logger.info("Priority %d: TIC %d -> %s", row["priority"], row["starid"],
                            row["status"].name)

        while True:
            with span("lease"):
                if random_task and not all_tasks:
                    batch = [tm.get_random_task()]
                    if batch[0] is None:
                        batch = []
                elif all_tasks:
                    batch = tm.get_task_batch(batch_size=batch_size, **constraints)
                else:
                    task = tm.get_task(**constraints)
                    batch = [task] if task else []
            if not batch:
                break
            if method:
                for tk in batch:
                    tk["method"] = method
            with span("sqlite"):
                tm.start_tasks([tk["priority"] for tk in batch])
            store(drain_lease(ctx_cache, halo_queue, input_folder, batch, [],
                              output_folder=products_folder, version=version,
                              plot_folder=output_folder if plot else None))
            count("n_batches")
            if not all_tasks:
                break
        store(flush_halo(halo_queue, force=True))
        logger.info("%d task(s) processed.", n_done)
        count("n_done", n_done)
    return n_done
