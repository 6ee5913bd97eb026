"""
The production drain loop: lease task batches, run photometry, write
products, persist diagnostics.

Port of ``photometry_tpu/core/drain.py`` (reference run_tessphot.py:124-166
and the per-task unit of run_tessphot_mpi.py:148-196): batches are leased
per (sector, camera, ccd, datasource, cadence) so one device context serves
hundreds of targets, and halo-switch candidates accumulate across leases in
a ``HaloSwitchQueue``.  The optional ``timers`` dict decomposes the wall
into the pipeline's phases.
"""

from __future__ import annotations

import logging
from timeit import default_timer
from typing import Optional

from ..taskmanager import TaskManager
from .dispatcher import ContextCache, HaloSwitchQueue, photometry_batch

__all__ = ["run_drain", "task_to_result", "new_timers"]

logger = logging.getLogger(__name__)


def task_to_result(task, res, elaptime, worker_wait_time=None) -> dict:
    """Diagnostics row for TaskManager.save_result (taskmanager.py:435-603)."""
    details = dict(res.details)
    details["skip_targets"] = res.skip_targets
    return {
        "priority": task["priority"], "starid": task["starid"],
        "sector": task["sector"], "camera": task["camera"], "ccd": task["ccd"],
        "cadence": task["cadence"], "datasource": task["datasource"],
        "tmag": task["tmag"], "status": res.status, "method_used": res.method,
        "time": elaptime, "worker_wait_time": worker_wait_time,
        "details": details,
    }


def new_timers() -> dict:
    """Fresh accumulator for run_drain's wall decomposition (seconds)."""
    return {"lease": 0.0, "context": 0.0, "photometry": 0.0, "save": 0.0,
            "sqlite": 0.0, "wall": 0.0, "n_done": 0, "n_batches": 0}


def run_drain(input_folder: str, version: int,
              output_folder: Optional[str] = None,
              products_folder: Optional[str] = None,
              *, all_tasks: bool = True, random_task: bool = False,
              batch_size: int = 256, method: Optional[str] = None,
              constraints: Optional[dict] = None, plot: bool = False,
              summary: Optional[str] = None, timers: Optional[dict] = None,
              device="cuda", mesh=None) -> int:
    """Drain the TODO queue (or one task) through the batch dispatcher on ``device``.

    Arguments as the reference's ``run_drain``; ``method`` forces one of
    aperture, psf, linpsf or halo for every task, None keeps the tasks' own
    (aperture with both automatic switches by default); ``plot`` renders
    each OK/WARNING task's diagnostic figures into
    ``<output_folder>/plots/<starid>/``; ``mesh`` (a ``parallel.mesh.Mesh``
    of ``device``'s type) shards every FFI context's cubes over it and
    extracts once per mesh block.  Returns the number of tasks processed.
    """
    constraints = dict(constraints or {})
    output_folder = output_folder or input_folder
    t = timers if timers is not None else new_timers()
    tic_wall = default_timer()

    with TaskManager(input_folder, cleanup=all_tasks, summary=summary) as tm, \
            ContextCache(device=device, mesh=mesh) as ctx_cache:
        n_done = 0
        # Halo-switch candidates accumulate across lease batches and rerun
        # as one halo batch; single-task modes keep the inline switch:
        halo_queue = HaloSwitchQueue(timers=t) if all_tasks and not method else None

        def flush_halo(force=False):
            nonlocal n_done
            if halo_queue is None or not halo_queue.pending:
                return
            tic = default_timer()
            flushed = halo_queue.flush(force=force)
            if not flushed:
                return
            elap = (default_timer() - tic) / len(flushed)
            tic = default_timer()
            tm.save_results([task_to_result(tk, res, elap) for tk, res in flushed])
            t["sqlite"] += default_timer() - tic
            for tk, res in flushed:
                n_done += 1
                logger.info("Priority %d: TIC %d -> %s (halo flush)", tk["priority"],
                            tk["starid"], res.status.name)

        while True:
            tic = default_timer()
            if random_task and not all_tasks:
                batch = [tm.get_random_task()]
                if batch[0] is None:
                    batch = []
            elif all_tasks:
                batch = tm.get_task_batch(batch_size=batch_size, **constraints)
            else:
                task = tm.get_task(**constraints)
                batch = [task] if task else []
            t["lease"] += default_timer() - tic
            if not batch:
                break
            # The queue pins its SectorContext: resolve it before the
            # ContextCache evicts that context for a different CCD.
            if halo_queue is not None and not halo_queue.matches(batch[0]):
                flush_halo(force=True)
            tic = default_timer()
            tm.start_tasks([tk["priority"] for tk in batch])
            t["sqlite"] += default_timer() - tic

            tic_batch = default_timer()
            tic = default_timer()
            ctx, cached = ctx_cache.get(input_folder, batch[0])
            t["context"] += default_timer() - tic
            try:
                if method:
                    for tk in batch:
                        tk["method"] = method
                results = photometry_batch(ctx, batch, output_folder=products_folder,
                                           version=version,
                                           plot_folder=output_folder if plot else None,
                                           halo_queue=halo_queue, timers=t)
            finally:
                ctx_cache.release(ctx, cached)
            elaptime = (default_timer() - tic_batch) / max(len(batch), 1)
            # Deferred halo-switch candidates stay leased until their flush:
            ready = [(tk, res) for tk, res in zip(batch, results)
                     if not res.details.get("halo_switch_deferred")]
            tic = default_timer()
            tm.save_results([task_to_result(tk, res, elaptime) for tk, res in ready])
            t["sqlite"] += default_timer() - tic
            t["n_batches"] += 1
            for tk, res in ready:
                n_done += 1
                logger.info("Priority %d: TIC %d -> %s", tk["priority"], tk["starid"],
                            res.status.name)
            if halo_queue is not None and halo_queue.should_flush():
                flush_halo()
            if not all_tasks:
                break
        flush_halo(force=True)
        logger.info("%d task(s) processed.", n_done)
        t["wall"] += default_timer() - tic_wall
        t["n_done"] += n_done
    return n_done
