"""Photometry status codes (same values as reference BasePhotometry.py:48-59).

The port's own copy of ``photometry_tpu/core/status.py``.
"""

from __future__ import annotations

import enum

__all__ = ["STATUS"]


@enum.unique
class STATUS(enum.Enum):
    """Status indicator of a photometry calculation."""
    UNKNOWN = 0   #: Not started yet.
    STARTED = 6   #: Started but not finished.
    OK = 1        #: Everything went well.
    ERROR = 2     #: Unrecoverable error.
    WARNING = 3   #: Fishy — maybe try a different algorithm.
    ABORT = 4     #: Calculation aborted.
    SKIPPED = 5   #: Skipped in favour of another target's mask.
