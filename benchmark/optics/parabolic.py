"""A parabolic mirror (upstream ART's MirrorParabolic): the paraboloid
z = (x^2 + y^2) / (2 p) with p = focal (1 + cos a), ``focal`` the entry's
effective focal length [mm] and a its ``off_axis`` angle [deg]. The optic's
frame has its origin at the support centre, which sits on the surface at
(focal sin a, 0, p / 2 - focal cos a) of the paraboloid's own frame; the
support is centred there."""

from __future__ import annotations

import math

import torch

from ..reference import optics as op
from ..work import model

#: the closed-form hit of csrc/trace_common.cuh quadric_hit on the
#: paraboloid: the quadratic's coefficients (14) and citardauq roots (9),
#: per root its point and support offset (7), the hit point (6) and its
#: unit normal (9); then mirror_step's reflection, Kahan path and
#: patch-relative point (19). The kernel's three Newton steps per root on
#: the distance-like residual (23 each) are not charged: the roots of a
#: quadric need none, as :func:`hit` shows
STEP_OPS = 71
#: what a mirror with defects adds besides its defects' lookups:
#: deformed_hit takes the bare surface's unit normal twice (9 each)
DEFORMED_OPS = 18


def shape(spec) -> dict:
    """p and the support centre's position in the paraboloid's frame."""
    a = math.radians(float(spec["off_axis"]))
    focal = float(spec["focal"])
    p = focal * (1.0 + math.cos(a))
    return {"p": p, "centre_x": focal * math.sin(a), "centre_z": 0.5 * p - focal * math.cos(a)}


def port(spec, support):
    from attosecondraytracing_tpu_torch.models import mirrors

    return mirrors.MirrorParabolic(float(spec["focal"]), float(spec["off_axis"]), support)


def reference(spec, support) -> op.Optic:
    return op.Optic("parabolic", support, shape(spec))


def normal(optic, point):
    """The unit normal (-X, -Y, p) / |.| at the point, X and Y in the
    paraboloid's frame."""
    s = optic.shape
    x = point[0] + s["centre_x"]
    y = point[1]
    inv = 1.0 / torch.sqrt(x * x + y * y + s["p"] * s["p"])
    return -x * inv, -y * inv, s["p"] * inv


def hit(optic, q, u):
    """The nearer of the ray's two crossings of the paraboloid ahead of it
    whose point lies on the support: a t^2 + b t + c = 0 in the stable
    form, the far root q / a absent for rays along the axis (a = 0)."""
    s = optic.shape
    p2 = 2.0 * s["p"]
    qx, qy, qz = q[0] + s["centre_x"], q[1], q[2] + s["centre_z"]
    ux, uy, uz = u
    a = ux * ux + uy * uy
    b = 2.0 * (ux * qx + uy * qy) - p2 * uz
    c = qx * qx + qy * qy - p2 * qz
    disc = b * b - 4.0 * a * c
    real = disc >= 0
    root = torch.sqrt(torch.clamp(disc, min=0.0))
    qq = -0.5 * (b + torch.where(b < 0, -root, root))
    inf = torch.full_like(qq, math.inf)
    candidates = (torch.where(qq != 0, c / torch.where(qq != 0, qq, 1.0), inf),
                  torch.where(a != 0, qq / torch.where(a != 0, a, 1.0), inf))
    t = inf
    for cand in candidates:
        x, y = q[0] + cand * ux, q[1] + cand * uy
        ok = real & (cand > op.T_MIN) & torch.isfinite(cand) & op.on_support(optic.support, x, y)
        t = torch.where(ok & (cand < t), cand, t)
    valid = torch.isfinite(t)
    t = torch.where(valid, t, torch.zeros_like(t))
    point = tuple(q[i] + t * u[i] for i in range(3))
    return t, valid, point, normal(optic, point)


def step_ops(optic) -> int:
    return model.OPS["affine"] + STEP_OPS + (DEFORMED_OPS if optic.defects else 0)
