"""A toroidal mirror (upstream ART's MirrorToroidal), the astigmatism-free
one for the entry's ``focal`` [mm] and ``incidence`` [deg]: in its vertex
frame (sqrt(x^2 + (z - major - minor)^2) - major)^2 + y^2 = minor^2, the
patch on z < minor."""

from __future__ import annotations

import math

import torch

from ..reference import optics as op
from ..work import model

#: a Newton root is a hit when its distance-like residual is below this [mm]
HIT_TOL = 1e-3
NEWTON_STEPS = 8
#: seed, one Newton step, validity, normal, reflection, Kahan path
STEP_OPS = 121


def radii(focal, incidence_deg):
    """(major, minor) of the astigmatism-free toroid."""
    i = math.radians(incidence_deg)
    return 2.0 * focal * (1.0 / math.cos(i) - math.cos(i)), 2.0 * focal * math.cos(i)


def port(spec, support):
    from attosecondraytracing_tpu_torch.models import mirrors

    return mirrors.MirrorToroidal(*mirrors.ReturnOptimalToroidalRadii(spec["focal"],
                                                                      spec["incidence"]), support)


def reference(spec, support) -> op.Optic:
    major, minor = radii(spec["focal"], spec["incidence"])
    return op.Optic("toroidal", support, {"major": major, "minor": minor})


def hit_tolerance(dtype, optic) -> float:
    """The residual [mm] under which a Newton root is a hit: ``HIT_TOL``, or
    four rounding units of the tube radius where the dtype is coarser."""
    return max(HIT_TOL, 4.0 * torch.finfo(dtype).eps * optic.shape["minor"])


def _residual(optic, x, y, z, ux, uy, uz):
    """Distance-like residual g of a point to the toroid and its derivative
    along the ray, in the vertex frame (the vertex at the origin, z along
    the normal there): every term is a small difference written without
    cancellation, so a low precision keeps its digits. With a = major +
    minor - z and rho = sqrt(x^2 + a^2), w = rho - major = minor - z +
    x^2 / (rho + a) and g = sqrt(w^2 + y^2) - minor."""
    major, minor = optic.shape["major"], optic.shape["minor"]
    a = (major + minor) - z
    rho = a * torch.sqrt(1.0 + (x / a) ** 2)
    w_m = x * x / (rho + a) - z
    w = w_m + minor
    s = torch.sqrt(w * w + y * y)
    g = (w_m * (w + minor) + y * y) / (s + minor)
    gp = (w * (x * ux - a * uz) / rho + y * uy) / s
    return g, gp


def normal(optic, point):
    x, y, z = point
    major, minor = optic.shape["major"], optic.shape["minor"]
    a = (major + minor) - z
    rho = a * torch.sqrt(1.0 + (x / a) ** 2)
    w = (x * x / (rho + a) - z + minor) / rho
    nx, ny, nz = -w * x, -y, w * a
    inv = 1.0 / torch.sqrt(nx * nx + ny * ny + nz * nz)
    return nx * inv, ny * inv, nz * inv


def hit(optic, q, u):
    """Newton from the vertex plane z = 0."""
    qx, qy, qz = q
    ux, uy, uz = u
    # the root's derivatives by the implicit function theorem: Newton runs
    # untaped to the root, and one last step on the tape, whose derivative
    # there is -(dg/dparameters) / (dg/dt)
    with torch.no_grad():
        t = -qz / uz
        for _ in range(NEWTON_STEPS - 1):
            g, gp = _residual(optic, qx + t * ux, qy + t * uy, qz + t * uz, ux, uy, uz)
            t = t - g / gp
    g, gp = _residual(optic, qx + t * ux, qy + t * uy, qz + t * uz, ux, uy, uz)
    t = t - g / gp
    x, y, z = qx + t * ux, qy + t * uy, qz + t * uz
    g, _ = _residual(optic, x, y, z, ux, uy, uz)
    valid = ((t > op.T_MIN) & (torch.abs(g) < hit_tolerance(qx.dtype, optic))
             & (z < optic.shape["minor"]) & op.on_support(optic.support, x, y))
    return t, valid, (x, y, z), normal(optic, (x, y, z))


def step_ops(optic) -> int:
    return model.OPS["affine"] + STEP_OPS
