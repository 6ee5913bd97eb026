"""
TESS data-quality bitmask flags: the port's own copy of
``photometry_tpu/quality.py``.

The flag *values* are the public TESS/SPOC bit assignments (data spec), so
they necessarily match the reference (photometry/quality.py:73-173).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["TESSQualityFlags", "PixelQualityFlags", "CorrectorQualityFlags"]


class _BitFlags:
    """Base for integer bitmask flag namespaces."""

    #: Bitmask which keeps only QUALITY == 0 cadences.
    HARDEST_BITMASK = 2**32 - 1

    #: Mapping flag-value -> human-readable description. Set by subclasses.
    STRINGS: dict = {}

    @classmethod
    def decode(cls, quality: int) -> list:
        """Human-readable descriptions of all raised flags in ``quality``."""
        return [s for flag, s in cls.STRINGS.items() if int(quality) & flag]

    @classmethod
    def filter(cls, quality, flags=None):  # noqa: A003
        """True where ``quality`` contains none of ``flags``.

        Works elementwise on numpy arrays and tensors.
        """
        if flags is None:
            flags = cls.DEFAULT_BITMASK
        return (quality & flags) == 0

    @staticmethod
    def binary_repr(quality):
        """32-character binary string of ``quality``; an array of them for
        an array, list or tensor (host-side)."""
        if isinstance(quality, (np.ndarray, list, tuple, torch.Tensor)):
            return np.array([np.binary_repr(int(q), width=32) for q in quality])
        return np.binary_repr(int(quality), width=32)


class TESSQualityFlags(_BitFlags):
    """Cadence-level TESS QUALITY bitmask flags."""

    AttitudeTweak = 1
    SafeMode = 2
    CoarsePoint = 4
    EarthPoint = 8
    ZeroCrossing = 16
    Desat = 32
    ApertureCosmic = 64
    ManualExclude = 128
    SensitivityDropout = 256
    ImpulsiveOutlier = 512
    CollateralCosmic = 1024
    EarthMoonPlanetInFOV = 2048
    ScatteredLight = 4096

    DEFAULT_BITMASK = (AttitudeTweak | SafeMode | CoarsePoint | EarthPoint
                       | Desat | ApertureCosmic | ManualExclude | ScatteredLight)

    #: Includes flags known to mark both good and bad cadences.
    HARD_BITMASK = DEFAULT_BITMASK | SensitivityDropout | CollateralCosmic

    #: Flags relevant when transferring TPF quality onto FFI timestamps.
    #: ManualExclude is deliberately excluded (it would reject ~20% of FFIs).
    FFI_RELEVANT_BITMASK = (AttitudeTweak | SafeMode | CoarsePoint | EarthPoint
                            | Desat | EarthMoonPlanetInFOV | ScatteredLight)

    STRINGS = {
        AttitudeTweak: "Attitude tweak",
        SafeMode: "Safe mode",
        CoarsePoint: "Spacecraft in Coarse point",
        EarthPoint: "Spacecraft in Earth point",
        ZeroCrossing: "Reaction wheel zero crossing",
        Desat: "Reaction wheel desaturation event",
        ApertureCosmic: "Cosmic ray in optimal aperture pixel",
        ManualExclude: "Manual exclude",
        SensitivityDropout: "Sudden sensitivity dropout",
        ImpulsiveOutlier: "Impulsive outlier",
        CollateralCosmic: "Cosmic ray in collateral data",
        EarthMoonPlanetInFOV: "Earth, Moon or other planet in camera FOV",
        ScatteredLight: "Scattered light from Earth or Moon in CCD",
    }


class PixelQualityFlags(_BitFlags):
    """Per-pixel quality bitmask flags produced by the prepare stage."""

    NotUsedForBackground = 1
    ManualExclude = 2
    BackgroundShenanigans = 4

    DEFAULT_BITMASK = ManualExclude

    STRINGS = {
        NotUsedForBackground: "Pixel was not used in background calculation",
        ManualExclude: "Manual exclude",
        BackgroundShenanigans: "Background Shenanigans detected in pixel",
    }


class CorrectorQualityFlags(_BitFlags):
    """Light-curve level quality flags consumed by downstream correction."""

    FlaggedBadData = 1
    ManualExclude = 2
    SigmaClip = 4
    JumpAdditiveConstant = 8
    JumpAdditiveLinear = 16
    JumpMultiplicativeConstant = 32
    JumpMultiplicativeLinear = 64
    Interpolated = 128
    BackgroundShenanigans = 256

    DEFAULT_BITMASK = FlaggedBadData | ManualExclude

    STRINGS = {
        FlaggedBadData: "Bad data based on pixel flags",
        ManualExclude: "Manual exclude",
        SigmaClip: "Point removed due to sigma clipping",
        JumpAdditiveConstant: "Jump corrected using additive constant",
        JumpAdditiveLinear: "Jump corrected using additive linear trend",
        JumpMultiplicativeConstant: "Jump corrected using multiplicative constant",
        JumpMultiplicativeLinear: "Jump corrected using multiplicative linear trend",
        Interpolated: "Point is interpolated",
        BackgroundShenanigans: "Background Shenanigans detected in stamp",
    }
