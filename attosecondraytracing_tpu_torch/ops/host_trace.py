"""Host-side single-ray tracer (NumPy, float64).

Used for (a) the auto-alignment ray during scene construction — the reference
traces one central ray through the partial chain to aim each next element
(ART/ModuleProcessing.py:114-118) — and (b) as an independent oracle the unit
tests compare the batched device tracer against.

Implements the same semantics as the reference trace
(ART/ModuleProcessing.py:250-313): transform into the optic frame, intersect
(np.roots closed forms with branch/support filters, nearest valid hit),
reflect or transmit, transform back. One ray only — speed is irrelevant here.
"""

from __future__ import annotations

import numpy as np

from . import host_geometry as hg


class HostRay:
    """Plain single-ray record (point, unit vector, accumulated path)."""

    def __init__(self, point, vector, path=0.0, incidence=None):
        self.point = np.asarray(point, dtype=float)
        v = np.asarray(vector, dtype=float)
        self.vector = v / np.linalg.norm(v)
        self.path = float(path)
        self.incidence = incidence


def trace_ray(ray: HostRay, elements, ignore_defects: bool = True) -> list:
    """Trace one ray through a list of OpticalElements; returns the list of
    rays after each element (None once the ray is lost).

    ``ignore_defects=True`` (the reference trace default,
    ART/ModuleProcessing.py:250) keeps the deformed *intersection offset* but
    reflects off the undeformed mirror normal
    (ART/ModuleMirror.py:927-937)."""
    from ..models.masks import Mask
    from ..models.mirrors import DeformedMirror

    out = []
    cur = ray
    for element in elements:
        if cur is None:
            out.append(None)
            continue
        R = element.frame_rotation()
        optic = element.type
        centre = optic.get_centre()
        p = R @ (cur.point - element.position) + centre
        d = R @ cur.vector

        if isinstance(optic, Mask):
            q = optic._transmit_host(p, d)
            if q is None:
                cur = None
            else:
                n = optic.get_normal(q)
                incidence = hg.angle_between(d, n)
                path = cur.path + np.linalg.norm(q - p)
                cur = HostRay(R.T @ (q - centre) + element.position, R.T @ d, path, incidence)
        else:
            q = optic._intersect_host(p, d)
            if q is None:
                cur = None
            else:
                if isinstance(optic, DeformedMirror) and ignore_defects:
                    n = optic.Mirror.get_normal(q)
                else:
                    n = optic.get_normal(q)
                d_out = hg.reflect(d, n)
                incidence = hg.angle_between(-d, n)
                path = cur.path + np.linalg.norm(q - p)
                cur = HostRay(R.T @ (q - centre) + element.position, R.T @ d_out, path, incidence)
        out.append(cur)
    return out
