"""Optic supports (apertures/footprints) with *vectorized* inclusion tests.

Replaces ART/ModuleSupport.py. A support is the footprint of an optic in its
local x-y plane. The device-side operation that matters for tracing is
``include(support, x, y) -> bool[N]``, evaluated for every candidate
intersection point of every ray at once (the reference tests one Python point
at a time, ART/ModuleSupport.py:68-70 etc.).

Support objects are NamedTuples of python floats, and the same object
doubles as the host-side description used for sampling render grids
(:func:`grid_points`, :func:`contour_points`). Counterpart of the JAX
package's ``ops/supports.py``; ``include`` is written with operators only,
so it takes NumPy arrays and tensors alike.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np

from .host_geometry import vogel_spiral


class SupportRound(NamedTuple):
    """Disk of given radius (ART/ModuleSupport.py:46-105)."""

    radius: float


class SupportRoundHole(NamedTuple):
    """Disk with a round hole (ART/ModuleSupport.py:109-194)."""

    radius: float
    radius_hole: float
    center_hole_x: float
    center_hole_y: float

    # reference attribute spellings (ART/ModuleSupport.py:146-149)
    @property
    def radiushole(self):
        return self.radius_hole

    @property
    def centerholeX(self):
        return self.center_hole_x

    @property
    def centerholeY(self):
        return self.center_hole_y


class SupportRectangle(NamedTuple):
    """Rectangle dimX x dimY (ART/ModuleSupport.py:200-269)."""

    dim_x: float
    dim_y: float

    @property
    def dimX(self):
        return self.dim_x

    @property
    def dimY(self):
        return self.dim_y


class SupportRectangleHole(NamedTuple):
    """Rectangle with a round hole (ART/ModuleSupport.py:273-369)."""

    dim_x: float
    dim_y: float
    radius_hole: float
    center_hole_x: float
    center_hole_y: float

    @property
    def dimX(self):
        return self.dim_x

    @property
    def dimY(self):
        return self.dim_y

    @property
    def radiushole(self):
        return self.radius_hole


class SupportRectangleRectHole(NamedTuple):
    """Rectangle with a rectangular hole (ART/ModuleSupport.py:373-491)."""

    dim_x: float
    dim_y: float
    hole_x: float
    hole_y: float
    center_hole_x: float
    center_hole_y: float

    @property
    def dimX(self):
        return self.dim_x

    @property
    def dimY(self):
        return self.dim_y

    @property
    def holeX(self):
        return self.hole_x

    @property
    def holeY(self):
        return self.hole_y


def _in_disk(r, x, y):
    return x * x + y * y <= r * r


def _in_rect(dx, dy, x, y):
    return (abs(x) <= abs(dx) * 0.5) & (abs(y) <= abs(dy) * 0.5)


def include(support, x, y):
    """Vectorized point-in-support test. ``x``/``y`` are arrays of local
    coordinates; returns a bool array of the same shape.

    Written with operators only, so it works identically on NumPy inputs
    (host-side alignment tracing) and on tensors (the batched trace). The
    support's python-float dimensions follow the tensor's dtype."""
    if isinstance(support, SupportRound):
        return _in_disk(support.radius, x, y)
    if isinstance(support, SupportRoundHole):
        hx = x - support.center_hole_x
        hy = y - support.center_hole_y
        return _in_disk(support.radius, x, y) & ~_in_disk(support.radius_hole, hx, hy)
    if isinstance(support, SupportRectangle):
        return _in_rect(support.dim_x, support.dim_y, x, y)
    if isinstance(support, SupportRectangleHole):
        hx = x - support.center_hole_x
        hy = y - support.center_hole_y
        return _in_rect(support.dim_x, support.dim_y, x, y) & ~_in_disk(support.radius_hole, hx, hy)
    if isinstance(support, SupportRectangleRectHole):
        hx = x - support.center_hole_x
        hy = y - support.center_hole_y
        return _in_rect(support.dim_x, support.dim_y, x, y) & ~_in_rect(support.hole_x, support.hole_y, hx, hy)
    raise TypeError(f"unknown support type {type(support)}")


# ---------------------------------------------------------------------------
# Host-side helpers (render sampling, defect-map extents)
# ---------------------------------------------------------------------------


def circum_rect(support) -> np.ndarray:
    """Dimensions [dimX, dimY] of the circumscribed rectangle
    (ART/ModuleSupport.py _CircumRect methods)."""
    if isinstance(support, (SupportRound, SupportRoundHole)):
        return np.array([2.0 * support.radius, 2.0 * support.radius])
    return np.array([support.dim_x, support.dim_y])


def circum_circle(support) -> float:
    """Radius of the circumscribed circle (_CircumCirc)."""
    if isinstance(support, (SupportRound, SupportRoundHole)):
        return float(support.radius)
    return float(math.hypot(support.dim_x, support.dim_y) / 2.0)


def grid_points(support, n_points: int) -> np.ndarray:
    """(M, 2) sample points covering the support, used for 3D rendering.

    Round supports use a Vogel spiral, rectangular ones a regular grid, with
    hole points filtered out — same layout logic as the reference's _get_grid
    methods (ART/ModuleSupport.py:72-84, :157-169, :232-248, :328-341,
    :437-455).
    """
    if isinstance(support, (SupportRound, SupportRoundHole)):
        pts = vogel_spiral(n_points, support.radius)
    else:
        dx, dy = support.dim_x, support.dim_y
        nbx = int(np.sqrt(dx / dy * n_points + 0.25 * (dx - dy) ** 2 / dy**2) - 0.5 * (dx - dy) / dy)
        nbx = max(nbx, 1)
        nby = max(int(n_points / nbx), 1)
        xs = np.linspace(-dx / 2, dx / 2, nbx)
        ys = np.linspace(-dy / 2, dy / 2, nby)
        X, Y = np.meshgrid(xs, ys, indexing="ij")
        pts = np.stack([X.ravel(), Y.ravel()], axis=-1)
    keep = np.asarray(include(support, pts[:, 0], pts[:, 1]))
    return pts[keep]


def _circle_contour(radius: float, n: int) -> np.ndarray:
    if n <= 0:
        return np.zeros((0, 2))
    th = 2.0 * np.pi * np.arange(n) / n
    return np.stack([radius * np.cos(th), radius * np.sin(th)], axis=-1)


def _rect_contour(dx: float, dy: float, n: int) -> np.ndarray:
    n = max(n, 4)
    per = 2.0 * (dx + dy)
    s = np.linspace(0.0, per, n, endpoint=False)
    pts = np.zeros((n, 2))
    for i, si in enumerate(s):
        if si < dx:
            pts[i] = (si - dx / 2, dy / 2)
        elif si < dx + dy:
            pts[i] = (dx / 2, dy / 2 - (si - dx))
        elif si < 2 * dx + dy:
            pts[i] = (dx / 2 - (si - dx - dy), -dy / 2)
        else:
            pts[i] = (-dx / 2, -dy / 2 + (si - 2 * dx - dy))
    return pts


def contour_points(support, n_points: int = 100) -> list[np.ndarray]:
    """List of closed contour polylines (outer boundary first, then holes),
    used to draw support outlines in plots and render meshes
    (reference: _Contour_points methods)."""
    if isinstance(support, SupportRound):
        return [_circle_contour(support.radius, n_points)]
    if isinstance(support, SupportRoundHole):
        n_outer = int(round(n_points - n_points * support.radius_hole / support.radius))
        hole = _circle_contour(support.radius_hole, n_points - n_outer)
        hole = hole + np.array([support.center_hole_x, support.center_hole_y])
        return [_circle_contour(support.radius, n_outer), hole]
    if isinstance(support, SupportRectangle):
        return [_rect_contour(support.dim_x, support.dim_y, n_points)]
    if isinstance(support, SupportRectangleHole):
        outer_len = 2 * (support.dim_x + support.dim_y)
        hole_len = 2 * np.pi * support.radius_hole
        n_hole = int(round(hole_len / (outer_len + hole_len) * n_points))
        hole = _circle_contour(support.radius_hole, n_hole)
        hole = hole + np.array([support.center_hole_x, support.center_hole_y])
        return [_rect_contour(support.dim_x, support.dim_y, n_points - n_hole), hole]
    if isinstance(support, SupportRectangleRectHole):
        outer_len = 2 * (support.dim_x + support.dim_y)
        hole_len = 2 * (support.hole_x + support.hole_y)
        n_hole = int(round(hole_len / (outer_len + hole_len) * n_points))
        hole = _rect_contour(support.hole_x, support.hole_y, n_hole)
        hole = hole + np.array([support.center_hole_x, support.center_hole_y])
        return [_rect_contour(support.dim_x, support.dim_y, n_points - n_hole), hole[::-1]]
    raise TypeError(f"unknown support type {type(support)}")
