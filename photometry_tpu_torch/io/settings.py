"""
Configuration loading: packaged INI settings and per-sector metadata.

Behavioral counterpart of reference photometry/io.py:96-119
(``load_settings`` / ``load_sector_settings``), re-designed around a small
typed ``SectorInfo`` record and an explicit override path so tests can inject
configuration without monkeypatching module state.

The port's own copy of ``photometry_tpu/io/settings.py``: ``data_dir()`` is
the port's ``data/`` folder, which holds copies of the JAX package's
``settings.ini``, ``sector_info.json`` and the todo list's
``todolist-exclude.dat`` and ``todolist-methods.dat``.
"""

from __future__ import annotations

import configparser
import functools
import json
import os
from dataclasses import dataclass
from typing import Optional

_DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")


def data_dir() -> str:
    """Absolute path of the packaged data directory."""
    return _DATA_DIR


@functools.lru_cache(maxsize=8)
def load_settings(path: Optional[str] = None) -> configparser.ConfigParser:
    """Load pipeline settings.

    Parameters:
        path: Optional explicit path to an INI file. Defaults to the
            packaged ``data/settings.ini``; the environment variable
            ``PHOTOMETRY_TPU_SETTINGS`` overrides the default.
    """
    if path is None:
        path = os.environ.get("PHOTOMETRY_TPU_SETTINGS") or os.path.join(_DATA_DIR, "settings.ini")
    cfg = configparser.ConfigParser()
    with open(path) as fh:
        cfg.read_file(fh)
    return cfg


@dataclass(frozen=True)
class SectorInfo:
    """Static metadata for one TESS observing sector."""
    sector: int
    reference_time: float  #: JD around mid-sector, used as catalog epoch.
    ffi_cadence: int       #: FFI cadence in seconds (1800/600/200).


@functools.lru_cache(maxsize=1)
def _sector_table() -> dict:
    with open(os.path.join(_DATA_DIR, "sector_info.json")) as fh:
        raw = json.load(fh)
    fields = raw["fields"]
    out = {}
    for rec in raw["records"]:
        d = dict(zip(fields, rec))
        out[int(d["sector"])] = SectorInfo(int(d["sector"]), float(d["reference_time"]), int(d["ffi_cadence"]))
    return out


def sector_info(sector: Optional[int] = None):
    """Metadata for one sector, or the full ``{sector: SectorInfo}`` table."""
    table = _sector_table()
    if sector is None:
        return table
    return table[int(sector)]
