"""Reference-compatible support constructors.

The config-facing API keeps the argument names of ART/ModuleSupport.py so the
example CONFIG scripts port line-for-line; the returned objects are the
framework's NamedTuple supports (vectorized inclusion tests, see
:mod:`attosecondraytracing_tpu_torch.ops.supports`).
"""

from __future__ import annotations

from ..ops import supports as _sup

Support = object  # supports are duck-typed NamedTuples; kept for isinstance-y docs


def SupportRound(Radius: float) -> _sup.SupportRound:
    """Round support (ART/ModuleSupport.py:46-105)."""
    return _sup.SupportRound(radius=float(Radius))


def SupportRoundHole(Radius: float, RadiusHole: float, CenterHoleX: float, CenterHoleY: float) -> _sup.SupportRoundHole:
    """Round support with round hole (ART/ModuleSupport.py:109-194)."""
    return _sup.SupportRoundHole(
        radius=float(Radius),
        radius_hole=float(RadiusHole),
        center_hole_x=float(CenterHoleX),
        center_hole_y=float(CenterHoleY),
    )


def SupportRectangle(DimensionX: float, DimensionY: float) -> _sup.SupportRectangle:
    """Rectangular support (ART/ModuleSupport.py:200-269)."""
    return _sup.SupportRectangle(dim_x=float(DimensionX), dim_y=float(DimensionY))


def SupportRectangleHole(
    DimensionX: float, DimensionY: float, RadiusHole: float, CenterHoleX: float, CenterHoleY: float
) -> _sup.SupportRectangleHole:
    """Rectangular support with round hole (ART/ModuleSupport.py:273-369)."""
    return _sup.SupportRectangleHole(
        dim_x=float(DimensionX),
        dim_y=float(DimensionY),
        radius_hole=float(RadiusHole),
        center_hole_x=float(CenterHoleX),
        center_hole_y=float(CenterHoleY),
    )


def SupportRectangleRectHole(
    DimensionX: float, DimensionY: float, HoleX: float, HoleY: float, CenterHoleX: float, CenterHoleY: float
) -> _sup.SupportRectangleRectHole:
    """Rectangular support with rectangular hole (ART/ModuleSupport.py:373-491)."""
    return _sup.SupportRectangleRectHole(
        dim_x=float(DimensionX),
        dim_y=float(DimensionY),
        hole_x=float(HoleX),
        hole_y=float(HoleY),
        center_hole_x=float(CenterHoleX),
        center_hole_y=float(CenterHoleY),
    )
