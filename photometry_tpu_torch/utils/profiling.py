"""
Lightweight tracing / profiling hooks.

The port's copy of ``photometry_tpu/utils/profiling.py`` (reference: per-task
wall-clock timers persisted into the diagnostics table, taskmanager.py:543-592):

- :class:`StageTimer` — named wall-clock stages accumulated into a dict
  that callers merge into the diagnostics store.  Opened with
  :meth:`StageTimer.recording`, it is also the process's recorder: the
  module's :func:`span` and :func:`count`, which the program calls where
  its work happens (in any thread), add into it.  With an event list it
  also keeps each span as ``(name, start_ns, end_ns, thread)`` on
  ``time.time_ns()``, the clock ``torch.profiler``'s events carry.
- :func:`device_trace` — a context manager around ``torch.profiler`` that
  writes a Chrome/Perfetto trace of the enclosed block (host ops, and the
  CUDA kernels and copies when a card is present), the program's spans
  among them, into a directory (pass one, or set
  ``PHOTOMETRY_TPU_TRACE_DIR``).
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import threading
import time
from typing import Optional

logger = logging.getLogger(__name__)

__all__ = ["StageTimer", "device_trace", "span", "count"]

#: The open recorder (innermost), or None: what span() and count() add into.
_active: "Optional[StageTimer]" = None
_NULL = contextlib.nullcontext()


class StageTimer:
    """Accumulate named wall-clock stages and counters; ``timings`` is
    {name: seconds or count}, the caller's dict when one is given.

    ``events``, a list, also receives each stage as ``(name, start_ns,
    end_ns, thread)`` (``time.time_ns()``, the thread's native id).  While
    :meth:`recording` is open, :func:`span` and :func:`count` add into this
    timer, and into the recorders it was opened inside; additions take a
    lock, so threads may add at once.
    """

    def __init__(self, timings: Optional[dict] = None, events: Optional[list] = None):
        self.timings = {} if timings is None else timings
        self.events = events
        self._lock = threading.Lock()
        self._outer = None

    def _chain(self):
        rec = self
        while rec is not None:
            yield rec
            rec = rec._outer

    def add(self, name: str, value) -> None:
        """Add ``value`` (seconds or a count) to ``name``."""
        for rec in self._chain():
            with rec._lock:
                rec.timings[name] = rec.timings.get(name, 0) + value

    @contextlib.contextmanager
    def stage(self, name: str):
        start_ns, tic = time.time_ns(), time.perf_counter()
        try:
            yield
        finally:
            secs, end_ns = time.perf_counter() - tic, time.time_ns()
            event = (name, start_ns, end_ns, threading.get_native_id())
            for rec in self._chain():
                with rec._lock:
                    rec.timings[name] = rec.timings.get(name, 0.0) + secs
                    if rec.events is not None:
                        rec.events.append(event)

    @contextlib.contextmanager
    def recording(self):
        """Make this timer the process's recorder while open, inside the
        one open before it (which still receives every addition)."""
        global _active
        if _active is not None and any(rec is self for rec in _active._chain()):
            raise RuntimeError("this recorder is open already")
        self._outer, _active = _active, self
        try:
            yield self
        finally:
            _active, self._outer = self._outer, None

    def log(self, prefix: str = ""):
        for name, secs in sorted(self.timings.items(), key=lambda kv: -kv[1]):
            logger.info("%s%s: %.3f s", prefix, name, secs)

    def as_details(self) -> dict:
        """Flatten for the diagnostics store (seconds, 'time_' prefixed)."""
        return {f"time_{k}": round(v, 6) for k, v in self.timings.items()}


def span(name: str):
    """A context manager that adds its wall seconds to ``name`` in the open
    recorder; nothing where none is open."""
    rec = _active
    if rec is None:
        return _NULL
    return rec.stage(name)


def count(name: str, n=1) -> None:
    """Add ``n`` to the counter ``name`` of the open recorder, if any."""
    rec = _active
    if rec is not None:
        rec.add(name, n)


@contextlib.contextmanager
def device_trace(trace_dir: Optional[str] = None, enabled: Optional[bool] = None):
    """Capture a ``torch.profiler`` trace of the enclosed block into
    ``trace_dir/trace_<pid>_<ns>.json``, with the program's spans in it
    (category ``program_span``, on the trace's own time base) and their
    totals and the counters under ``programTimings``.

    No-op unless a directory is given or PHOTOMETRY_TPU_TRACE_DIR is set.
    """
    if trace_dir is None:
        trace_dir = os.environ.get("PHOTOMETRY_TPU_TRACE_DIR")
    if enabled is None:
        enabled = bool(trace_dir)
    if not enabled or not trace_dir:
        yield
        return
    import torch
    os.makedirs(trace_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    path = os.path.join(trace_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    rec = StageTimer(events=[])
    with torch.profiler.profile(activities=acts) as prof, rec.recording():
        yield
    prof.export_chrome_trace(path)
    _add_spans(path, rec)
    logger.info("Device trace written to %s", path)


def _add_spans(path: str, rec: StageTimer) -> None:
    """Write ``rec``'s spans into the Chrome trace at ``path`` as complete
    events: the trace's ``ts`` are microseconds from its
    ``baseTimeNanoseconds`` on the clock of ``time.time_ns()``."""
    with open(path) as fh:
        trace = json.load(fh)
    base, pid = int(trace.get("baseTimeNanoseconds", 0)), os.getpid()
    trace.setdefault("traceEvents", []).extend(
        {"ph": "X", "cat": "program_span", "name": name, "pid": pid, "tid": tid,
         "ts": (start - base) / 1e3, "dur": (end - start) / 1e3}
        for name, start, end, tid in rec.events)
    trace["programTimings"] = rec.timings
    with open(path, "w") as fh:
        json.dump(trace, fh)
