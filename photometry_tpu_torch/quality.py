"""
TESS data-quality bitmask flags: the port's own copy of the parts of
``photometry_tpu/quality.py`` it uses.

The flag *values* are the public TESS/SPOC bit assignments (data spec), so
they necessarily match the reference (photometry/quality.py:73-173).
"""

from __future__ import annotations

__all__ = ["TESSQualityFlags", "PixelQualityFlags", "CorrectorQualityFlags"]


class _BitFlags:
    """Base for integer bitmask flag namespaces."""

    @classmethod
    def filter(cls, quality, flags=None):  # noqa: A003
        """True where ``quality`` contains none of ``flags``.

        Works elementwise on numpy arrays and tensors.
        """
        if flags is None:
            flags = cls.DEFAULT_BITMASK
        return (quality & flags) == 0


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

    #: Flags relevant when transferring TPF quality onto FFI timestamps.
    #: ManualExclude is deliberately excluded (it would reject ~20% of FFIs).
    FFI_RELEVANT_BITMASK = (AttitudeTweak | SafeMode | CoarsePoint | EarthPoint
                            | Desat | EarthMoonPlanetInFOV | ScatteredLight)


class PixelQualityFlags(_BitFlags):
    """Per-pixel quality bitmask flags produced by the prepare stage."""

    NotUsedForBackground = 1
    ManualExclude = 2
    BackgroundShenanigans = 4

    DEFAULT_BITMASK = ManualExclude


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
