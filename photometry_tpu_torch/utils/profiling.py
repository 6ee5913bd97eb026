"""
Lightweight tracing / profiling hooks.

The port's copy of ``photometry_tpu/utils/profiling.py`` (reference: per-task
wall-clock timers persisted into the diagnostics table, taskmanager.py:543-592):

- :class:`StageTimer` — named wall-clock stages accumulated into a dict
  that callers merge into the diagnostics store.
- :func:`device_trace` — a context manager around ``torch.profiler`` that
  writes a Chrome/Perfetto trace of the enclosed block (host ops, and the
  CUDA kernels and copies when a card is present) into a directory (pass one,
  or set ``PHOTOMETRY_TPU_TRACE_DIR``).
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Optional

logger = logging.getLogger(__name__)

__all__ = ["StageTimer", "device_trace"]


class StageTimer:
    """Accumulate named wall-clock stages; ``timings`` is {name: seconds}."""

    def __init__(self):
        self.timings = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        tic = time.perf_counter()
        try:
            yield
        finally:
            self.timings[name] = self.timings.get(name, 0.0) + (time.perf_counter() - tic)

    def log(self, prefix: str = ""):
        for name, secs in sorted(self.timings.items(), key=lambda kv: -kv[1]):
            logger.info("%s%s: %.3f s", prefix, name, secs)

    def as_details(self) -> dict:
        """Flatten for the diagnostics store (seconds, 'time_' prefixed)."""
        return {f"time_{k}": round(v, 6) for k, v in self.timings.items()}


@contextlib.contextmanager
def device_trace(trace_dir: Optional[str] = None, enabled: Optional[bool] = None):
    """Capture a ``torch.profiler`` trace of the enclosed block into
    ``trace_dir/trace_<pid>_<ns>.json``.

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
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(path)
    logger.info("Device trace written to %s", path)
