"""
The production drain loop: lease task batches, run photometry, write
products, persist diagnostics.

Port of ``photometry_tpu/core/drain.py`` (reference run_tessphot.py:124-166
and the per-task unit of run_tessphot_mpi.py:148-196) for the aperture
and PSF paths: batches are leased per (sector, camera, ccd, datasource,
cadence) so one device context serves hundreds of targets.  The optional ``timers``
dict decomposes the wall into the pipeline's phases.
"""

from __future__ import annotations

import logging
from timeit import default_timer
from typing import Optional

from ..taskmanager import TaskManager
from .dispatcher import ContextCache, photometry_batch

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
              constraints: Optional[dict] = None, summary: Optional[str] = None,
              timers: Optional[dict] = None, device="cuda") -> int:
    """Drain the TODO queue (or one task) through the batch dispatcher on ``device``.

    Arguments as the reference's ``run_drain``; ``method`` may be None
    (tasks' own method, aperture by default), ``"aperture"`` or ``"psf"``.
    Returns the number of tasks processed.
    """
    if method not in (None, "aperture", "psf"):
        raise NotImplementedError(f"method {method!r} is not ported to "
                                  "photometry_tpu_torch yet (only 'aperture' and 'psf')")
    constraints = dict(constraints or {})
    output_folder = output_folder or input_folder
    t = timers if timers is not None else new_timers()
    tic_wall = default_timer()

    with TaskManager(input_folder, cleanup=all_tasks, summary=summary) as tm, \
            ContextCache(device=device) as ctx_cache:
        n_done = 0
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
                                           version=version, timers=t)
            finally:
                ctx_cache.release(ctx, cached)
            elaptime = (default_timer() - tic_batch) / max(len(batch), 1)
            tic = default_timer()
            tm.save_results([task_to_result(tk, res, elaptime)
                             for tk, res in zip(batch, results)])
            t["sqlite"] += default_timer() - tic
            t["n_batches"] += 1
            for tk, res in zip(batch, results):
                n_done += 1
                logger.info("Priority %d: TIC %d -> %s", tk["priority"], tk["starid"],
                            res.status.name)
            if not all_tasks:
                break
        logger.info("%d task(s) processed.", n_done)
        t["wall"] += default_timer() - tic_wall
        t["n_done"] += n_done
    return n_done
