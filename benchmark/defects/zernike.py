"""Zernike height errors (upstream ART's ModuleDefects Zernike): ``terms``
``[[n, m, coefficient mm], ...]`` over the circle circumscribing the
mirror's rectangular support."""

from __future__ import annotations

import math

import torch

from ..reference import optics as op

#: the height shift along the ray, and each (n, m) row of the recurrence
SHIFT_OPS = 55
TERM_OPS = 9
#: what K6's dual numbers add: once per ray, per gradient term, per tangent
DUAL_ONCE_OPS = 14
DUAL_GRADIENT_TERM_OPS = 10
DUAL_SHIFT_TANGENT_OPS = 112


def _terms(spec):
    return tuple((int(n), int(m), float(c)) for n, m, c in spec["terms"])


def port(spec, support):
    from attosecondraytracing_tpu_torch.models import defects

    return defects.Zernike(support, {(n, m): c for n, m, c in _terms(spec)})


def reference(spec, support) -> op.Defect:
    # the support's circumscribed circle
    radius = math.hypot(support[1] / 2.0, support[2] / 2.0)
    return op.Defect("zernike", {"terms": _terms(spec), "radius": radius})


def zernike_height(terms, x, y):
    """Sum of c Z_n^m(x, y) over ``terms`` on the unit disk: Z_n^m =
    R_n^|l|(rho) times cos(l theta) (l > 0), sin(|l| theta) (l < 0) or 1,
    with l = 2m - n and the unnormalized radial polynomial R."""
    rho = torch.sqrt(x * x + y * y)
    theta = torch.atan2(y, x)
    h = torch.zeros_like(x)
    for n, m, c in terms:
        l = 2 * m - n
        k = abs(l)
        radial = torch.zeros_like(x)
        for s in range((n - k) // 2 + 1):
            coef = ((-1) ** s * math.factorial(n - s)
                    / (math.factorial(s) * math.factorial((n + k) // 2 - s)
                       * math.factorial((n - k) // 2 - s)))
            radial = radial + coef * rho ** (n - 2 * s)
        if l > 0:
            radial = radial * torch.cos(l * theta)
        elif l < 0:
            radial = radial * torch.sin(k * theta)
        h = h + c * radial
    return h


def height(defect, x, y):
    radius = defect.params["radius"]
    return zernike_height(defect.params["terms"], x / radius, y / radius)


def rows(defect) -> int:
    """(n, m) rows of the recurrence up to the highest order."""
    order = max([2] + [n for n, _m, _c in defect.params["terms"]])
    return sum(n + 1 for n in range(2, order + 1))


def ops(defect) -> int:
    return SHIFT_OPS + rows(defect) * TERM_OPS


def dual_ops(defect, n_tangents: int) -> int:
    return (DUAL_ONCE_OPS + rows(defect) * DUAL_GRADIENT_TERM_OPS
            + n_tangents * DUAL_SHIFT_TANGENT_OPS)
