"""Masks: plane elements that block rays hitting their support
(ART/ModuleMask.py). Hole-type supports therefore act as aperture stops."""

from __future__ import annotations

import numpy as np

from ..ops import supports as sup


class Mask:
    """A mask blocks rays that hit its support and transmits the rest
    unchanged (path and incidence get updated; ART/ModuleMask.py:21-136)."""

    def __init__(self, Support):
        self.type = "Mask"
        self.support = Support

    def get_normal(self, Point):
        return np.array([0.0, 0.0, 1.0])

    def get_centre(self):
        return np.zeros(3)

    def get_grid3D(self, NbPoint: int, **kwargs):
        contour_n = int(round(0.1 * NbPoint))
        contours = np.concatenate(sup.contour_points(self.support, max(contour_n, 4)), axis=0)
        grid = sup.grid_points(self.support, NbPoint - contour_n)
        xy = np.concatenate([contours, grid], axis=0)
        return [np.array([x, y, 0.0]) for x, y in xy]

    def _transmit_host(self, p, d):
        """Host-side single-ray transmission (None = blocked or behind);
        semantics of ART/ModuleMask.py:51-61."""
        if abs(d[2]) < 1e-30:
            return None
        t = -p[2] / d[2]
        q = p + t * d
        if t > 1e-12 and not bool(np.asarray(sup.include(self.support, q[0], q[1]))):
            return q
        return None

    def _params_tuple(self):
        return ()

    def __hash__(self):
        return hash((self.type, self.support))
