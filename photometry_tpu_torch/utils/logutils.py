"""
Log capture for the diagnostics ``errors`` column.

Port of ``photometry_tpu/utils/logutils.py`` (reference utilities.py:439-458
ListHandler, used by BasePhotometry.py:171-179): WARNING+ messages logged
while a batch's photometry runs are collected and persisted per target.
"""

from __future__ import annotations

import logging
from contextlib import contextmanager

__all__ = ["ListHandler", "capture_warnings"]


class ListHandler(logging.Handler):
    """A logging handler that appends formatted records to a list (not
    thread-safe, like the reference's: each worker process owns its queue)."""

    def __init__(self, message_queue: list, level=logging.WARNING):
        super().__init__(level)
        self.message_queue = message_queue
        self.setFormatter(logging.Formatter("%(levelname)s: %(message)s"))

    def emit(self, record):
        self.message_queue.append(self.format(record).rstrip("\n"))


@contextmanager
def capture_warnings(logger_name: str = "photometry_tpu_torch", level=logging.WARNING):
    """Collect WARNING+ messages logged under ``logger_name`` into a list."""
    queue: list = []
    handler = ListHandler(queue, level=level)
    lg = logging.getLogger(logger_name)
    lg.addHandler(handler)
    try:
        yield queue
    finally:
        lg.removeHandler(handler)
