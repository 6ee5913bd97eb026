"""
Corrections ("fixes") to early TESS data releases.

The port's own copy of ``photometry_tpu/fixes.py``, the counterpart of
reference photometry/fixes/time_offset.py:67-180:
early data releases (DR <= 26, and specific first-processings of DR 27/29)
carry timestamp errors from staggered camera/CCD readout and a constant
start/mid/end shift.  The decision logic runs on the host (it is header
driven); the arithmetic itself is a pure offset usable on device arrays.
"""

from __future__ import annotations

import logging
from typing import Mapping, Optional

from .io.settings import load_settings

logger = logging.getLogger(__name__)

#: Per-camera staggered readout delay in seconds (DR <= 26 FFIs).
_CAMERA_STAGGER_S = {1: 0.000, 2: 1.500, 3: 0.500, 4: 1.000}
#: Per-CCD staggered readout delay in seconds (DR <= 26 FFIs).
_CCD_STAGGER_S = {1: 0.000, 2: 0.020, 3: 0.040, 4: 0.060}

#: PROCVER values of the *first* (uncorrected) processing of Data Release 27.
_DR27_FIRST_PROCVER = ("spoc-4.0.14-20200108", "spoc-4.0.15-20200114", "spoc-4.0.17-20200130")
#: PROCVER values of the uncorrected processings of Data Release 29.
_DR29_BAD_PROCVER = ("spoc-4.0.17-20200130", "spoc-4.0.20-20200220", "spoc-4.0.21-20200227")

#: Constant offsets (seconds) by time position within the exposure.
_TIMEPOS_SHIFT_S = {"mid": -2.000 + 0.021, "start": -2.000 + 0.031, "end": -2.000 + 0.011}


def time_offset_should_apply(header: Mapping, allow_settings_disable: bool = True) -> tuple:
    """Decide whether the time-offset fix applies to data with this header.

    Returns:
        (apply_correction, dr27_first_release): two booleans.

    Raises:
        ValueError: for DR 27/29 data without a PROCVER header (cannot be
            disambiguated; the cube must be re-prepared).
    """
    datarel = int(header["DATA_REL"])
    procver = header.get("PROCVER", None)
    already = bool(header.get("TIME_OFFSET_CORRECTED", False))

    dr27_first = False
    if already or datarel > 29:
        apply_correction = False
    elif datarel <= 26:
        apply_correction = True
    elif datarel in (27, 29) and procver is None:
        raise ValueError(
            "The timestamps of these data may need correction, but the PROCVER "
            "header is missing; the image cube must be re-prepared.")
    elif datarel == 27 and procver in _DR27_FIRST_PROCVER:
        dr27_first = True
        apply_correction = True
    elif datarel == 29 and procver in _DR29_BAD_PROCVER:
        apply_correction = True
    else:
        apply_correction = False

    if apply_correction and allow_settings_disable:
        settings = load_settings()
        if not settings.getboolean("fixes", "time_offset", fallback=True):
            logger.warning("SettingsWarning: time_offset fix disabled in settings.")
            apply_correction = False
    return apply_correction, dr27_first


def time_offset_seconds(header: Mapping, datatype: str = "ffi", timepos: str = "mid") -> float:
    """The additive timestamp correction in *seconds* (0.0 when not applicable)."""
    if timepos not in _TIMEPOS_SHIFT_S:
        raise ValueError("Invalid TIMEPOS")
    apply_correction, dr27_first = time_offset_should_apply(header)
    if not apply_correction:
        return 0.0
    stagger = 0.0
    datarel = int(header["DATA_REL"])
    if datatype == "ffi" and (datarel <= 26 or dr27_first):
        stagger = _CAMERA_STAGGER_S[int(header["CAMERA"])] + _CCD_STAGGER_S[int(header["CCD"])]
    return stagger + _TIMEPOS_SHIFT_S[timepos]


def time_offset(time, header: Mapping, datatype: str = "ffi", timepos: str = "mid",
                return_flag: bool = False):
    """Apply the time-offset correction to an array of timestamps (days).

    ``time`` may be a numpy array or a tensor; the correction is a scalar
    addition.
    """
    offset_s = time_offset_seconds(header, datatype=datatype, timepos=timepos)
    corrected = time + offset_s / 86400.0 if offset_s != 0.0 else time
    if return_flag:
        return corrected, offset_s != 0.0
    return corrected
