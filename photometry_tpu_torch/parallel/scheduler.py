"""
Master/worker task-pull scheduler on the port.

Port of ``photometry_tpu/parallel/scheduler.py`` (reference
run_tessphot_mpi.py): workers announce READY, the master leases a batch of
compatible tasks (START), a worker runs ``run_drain``'s lease step
(``core.drain.drain_lease``) on it, writes the light curves itself and
returns the diagnostics rows, without the halo weight maps (DONE); when the
queue is empty the master asks it to EXIT, and the worker, after flushing
its deferred halo-switch candidates as one more DONE, answers BYE.  Only
the master touches the todo list.  Two transports carry the messages:
spawned processes over ``multiprocessing`` pipes (``run_distributed``), or
TCP (``run_distributed(listen=(host, port))`` with workers joining through
:func:`worker_remote` or ``scheduler_cmd --connect``).

On a CUDA card:

- The master never initialises CUDA: it imports the todo list and the
  statuses, nothing that touches ``torch.cuda``.  Workers are spawned, never
  forked, so each has its own CUDA context.
- Each worker holds its own copy of a CCD's context.  At 13 bytes a pixel
  (float32 images, errors and backgrounds, uint8 flags) a 2048x2048 CCD
  takes 27.9 GB a worker at T = 512 and 71.5 GB at T = 1,312 (a full
  1,800-s sector): two workers fit on an 80 GB card at T = 512, and not one
  holds a full float32 sector with ``cache="device"``, as for ``run_drain``.
  With ``cache="host"`` each worker keeps its copy in host memory instead
  and streams it through the card on every lease (``run_drain``'s
  ``cache``): two 128-frame buffers of the four planes, ~14 GB at
  2048x2048, on the card a worker.
- What says the port or the card cannot do the work (the dispatcher's
  ``_PROPAGATE``: ``NotImplementedError``, a kernel's ``KernelError``,
  ``torch.OutOfMemoryError``) is never a task's ERROR: the worker lets it
  through and dies.  The master returns every task leased to that worker
  to the queue (its deferred halo-switch candidates too) and spawns a
  replacement while respawns are left; once they are spent the queue is
  not drained, ``summary["drained"]`` is False and ``scheduler_cmd`` exits
  1.  Any other failure of a lease becomes STATUS.ERROR rows, as in the
  reference.
- ``mesh_spec`` (e.g. ``time=4,targets=2``) makes each worker shard its
  FFI contexts over a device mesh (``parallel.mesh.parse_mesh_spec`` on
  the worker's ``device`` type), built inside the worker process once it
  has started, as the JAX package builds it (its scheduler.py:72-90); the
  master only checks the spec's form (``mesh_axes``), which touches no
  device, so a malformed spec raises ValueError before any worker starts.

The test hooks ``PHOTOMETRY_TPU_TEST_CRASH_ONCE`` (a marker file: the first
worker to take a lease exits with code 17) and
``PHOTOMETRY_TPU_TEST_CRASH_ALWAYS`` (every worker exits on every lease)
are the JAX package's.
"""

from __future__ import annotations

import logging
import multiprocessing
import os
import traceback
from timeit import default_timer
from typing import Optional

logger = logging.getLogger(__name__)

__all__ = ["run_distributed", "worker_loop", "worker_remote"]

#: Shared secret for the TCP transport handshake (override per deployment).
_AUTHKEY_ENV = "PHOTOMETRY_TPU_SECRET"

# Message tags (run_tessphot_mpi.py:74).  BYE answers EXIT once the worker
# has flushed its deferred halo-switch work.
READY, START, DONE, EXIT, BYE = "READY", "START", "DONE", "EXIT", "BYE"


def _authkey() -> bytes:
    return os.environ.get(_AUTHKEY_ENV, "photometry-tpu").encode()


def _check_mesh_spec(mesh_spec):
    """ValueError for a malformed mesh spec (touches no device)."""
    if mesh_spec:
        from .mesh import mesh_axes
        mesh_axes(mesh_spec)


def worker_loop(conn, input_folder: str, output_folder: Optional[str], version: int,
                device="cuda", mesh_spec: Optional[str] = None, cache: str = "device"):
    """Worker process: READY -> START batch -> ``core.drain.drain_lease`` on
    ``device`` (FFI cubes sharded over the mesh of ``mesh_spec``, built
    here, or kept on the host with ``cache="host"``) -> DONE ... EXIT -> BYE."""
    from ..core.dispatcher import _PROPAGATE, ContextCache, HaloSwitchQueue, _error_result
    from ..core.drain import drain_lease, flush_halo, task_to_result

    mesh = None
    if mesh_spec:
        from .mesh import parse_mesh_spec
        mesh = parse_mesh_spec(mesh_spec, device=device)
    ctx_cache = ContextCache(device=device, mesh=mesh, cache=cache)
    halo_queue = HaloSwitchQueue()

    tic_wait = default_timer()
    conn.send((READY, None))
    while True:
        tag, payload = conn.recv()
        if tag == EXIT:
            # Deferred halo-switch work still pending: deliver it as one
            # more DONE; the master answers with EXIT again.
            leftovers = flush_halo(halo_queue, force=True)
            if leftovers:
                conn.send((DONE, leftovers))
                continue
            ctx_cache.close()
            conn.send((BYE, None))
            conn.close()
            return
        assert tag == START
        batch = payload
        marker = os.environ.get("PHOTOMETRY_TPU_TEST_CRASH_ONCE")
        if marker and not os.path.exists(marker):
            with open(marker, "w"):
                pass
            os._exit(17)
        if os.environ.get("PHOTOMETRY_TPU_TEST_CRASH_ALWAYS"):
            os._exit(17)
        worker_wait_time = default_timer() - tic_wait
        tic = default_timer()
        rows = []
        try:
            drain_lease(ctx_cache, halo_queue, input_folder, batch, rows,
                        worker_wait_time=worker_wait_time, output_folder=output_folder,
                        version=version)
        except _PROPAGATE:
            # Not the tasks' failure: this worker cannot do the work.  It
            # dies; the master returns its leases to the queue.
            raise
        except Exception:
            tb = traceback.format_exc().strip()
            elap = (default_timer() - tic) / len(batch)
            # += keeps the rows of a halo flush before the failure: their
            # queue entries are consumed.
            rows += [task_to_result(t, _error_result(t, None, tb), elap, worker_wait_time)
                     for t in batch]
        tic_wait = default_timer()
        conn.send((DONE, rows))


def worker_remote(address, input_folder: str, output_folder: Optional[str] = None,
                  version: int = 1, device="cuda", connect_timeout: float = 60.0,
                  mesh_spec: Optional[str] = None, cache: str = "device"):
    """Join a master listening at ``address`` = (host, port) over TCP, retrying
    until its listener is up, then run :func:`worker_loop`.  Paths are this
    host's own view of the shared file system."""
    import time
    from multiprocessing.connection import Client
    _check_mesh_spec(mesh_spec)
    deadline = default_timer() + connect_timeout
    while True:
        try:
            conn = Client(tuple(address), authkey=_authkey())
            break
        except OSError:
            if default_timer() > deadline:
                raise
            time.sleep(0.25)
    worker_loop(conn, input_folder, output_folder, version, device, mesh_spec, cache)


def run_distributed(input_folder: str, n_workers: int = 2, version: int = 1,
                    output_folder: Optional[str] = None, batch_size: int = 256,
                    device="cuda", summary: Optional[str] = None, listen=None,
                    max_respawns: int = 3, mesh_spec: Optional[str] = None,
                    cache: str = "device", **constraints) -> dict:
    """Master loop: lease batches to workers until the queue drains.

    ``n_workers`` processes are spawned, each running photometry on
    ``device``; with ``listen=(host, port)`` the master instead accepts
    ``n_workers`` TCP connections from :func:`worker_remote`.  A worker that
    dies has every task leased to it returned to the queue; a local one is
    replaced, up to ``max_respawns`` times.  Returns the summary dict, with
    ``respawns`` and ``drained`` (False when tasks are left: every worker
    lost and the respawns spent).  ``mesh_spec`` goes to each spawned
    worker, which builds its mesh itself, and ``cache`` ("device" or
    "host", as ``run_drain``'s) to each spawned worker's contexts.
    """
    _check_mesh_spec(mesh_spec)
    if cache not in ("device", "host"):
        raise ValueError(f"cache={cache!r}: need 'device' or 'host'")
    from ..core.status import STATUS
    from ..taskmanager import TaskManager

    mp = multiprocessing.get_context("spawn")
    if summary is None:
        summary = os.path.join(output_folder or input_folder, "summary.json")

    def _spawn_local():
        parent_conn, child_conn = mp.Pipe()
        proc = mp.Process(target=worker_loop, args=(child_conn, input_folder, output_folder,
                                                    version, device, mesh_spec, cache))
        proc.start()
        child_conn.close()
        return {"proc": proc, "conn": parent_conn, "alive": True, "leased": set()}

    with TaskManager(input_folder, cleanup=True, load_into_memory=True,
                     summary=summary) as tm:
        workers = []
        if listen is not None:
            from multiprocessing.connection import Listener
            with Listener(tuple(listen), authkey=_authkey()) as listener:
                logger.info("Waiting for %d remote workers on %s...", n_workers, listen)
                for _ in range(n_workers):
                    conn = listener.accept()
                    logger.info("Worker joined from %s", listener.last_accepted)
                    workers.append({"proc": None, "conn": conn, "alive": True,
                                    "leased": set()})
        else:
            workers = [_spawn_local() for _ in range(n_workers)]

        n_active = len(workers)
        respawns_left = max_respawns

        def _reap(w):
            """Worker lost: return its leases to the queue, respawn a local one."""
            nonlocal n_active, respawns_left
            w["alive"] = False
            n_active -= 1
            if w["leased"]:
                n = tm.release_tasks(sorted(w["leased"]))
                w["leased"].clear()
                logger.error("Worker died; released %d leased task(s) back to the queue.", n)
            if (w["proc"] is not None and respawns_left > 0
                    and tm.get_task(**constraints) is not None):
                respawns_left -= 1
                workers.append(_spawn_local())
                n_active += 1
                logger.warning("Respawned a replacement worker (%d respawns left).",
                               respawns_left)

        import multiprocessing.connection as mpc
        while n_active > 0:
            conns = [w["conn"] for w in workers if w["alive"]]
            ready = mpc.wait(conns, timeout=60.0)
            if not ready:
                # Heartbeat: the safety net for a dead local worker whose pipe
                # did not report EOF.
                for w in list(workers):
                    if w["alive"] and w["proc"] is not None and not w["proc"].is_alive():
                        _reap(w)
                continue
            for conn in ready:
                w = next(x for x in workers if x["conn"] is conn)
                try:
                    tag, payload = conn.recv()
                except (EOFError, OSError):
                    _reap(w)
                    continue
                if tag == BYE:
                    w["alive"] = False
                    n_active -= 1
                    continue
                if tag == DONE:
                    for r in payload:
                        r["status"] = STATUS(r["status"])
                        w["leased"].discard(r["priority"])
                    tm.save_results(payload)  # one commit per worker batch
                if tag in (READY, DONE):
                    batch = tm.get_task_batch(batch_size=batch_size, **constraints)
                    if batch:
                        tm.start_tasks([t["priority"] for t in batch])
                        w["leased"].update(t["priority"] for t in batch)
                        try:
                            conn.send((START, batch))
                        except OSError:
                            _reap(w)
                    else:
                        # EXIT is a request: the worker may still flush
                        # deferred halo-switch results (as DONE) before BYE.
                        try:
                            conn.send((EXIT, None))
                        except OSError:
                            _reap(w)

        for w in workers:
            if w["proc"] is None:
                w["conn"].close()
                continue
            w["proc"].join(timeout=30)
            if w["proc"].is_alive():  # pragma: no cover
                w["proc"].terminate()
        tm.backup()
        tm.summary["respawns"] = max_respawns - respawns_left
        tm.write_summary()
        summary = dict(tm.summary)
        summary["drained"] = not tm.get_task_batch(batch_size=1, **constraints)
        if not summary["drained"]:
            logger.error("Scheduler exiting with unprocessed tasks remaining "
                         "(all workers lost, respawns exhausted).")
        return summary
