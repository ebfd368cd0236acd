"""A mask (upstream ART's ModuleMask): its support stops the rays that
meet it in the plane z = 0 of its frame; the others pass on unchanged."""

from __future__ import annotations

import torch

from ..reference import optics as op
from ..work import model

#: an unfolded mask step: the plane crossing and the support test
STEP_OPS = 19
#: a mask folded into the next step: the crossing and the round-hole test
FOLDED_OPS = 15


def port(spec, support):
    from attosecondraytracing_tpu_torch.models import masks

    return masks.Mask(support)


def reference(spec, support) -> op.Optic:
    return op.Optic("mask", support)


def hit(optic, q, u):
    t = -q[2] / u[2]
    x, y = q[0] + t * u[0], q[1] + t * u[1]
    ok = (t > op.T_MIN) & ~op.on_support(optic.support, x, y)
    return t, ok, (x, y, torch.zeros_like(x)), None


def step_ops(optic) -> int:
    return model.OPS["affine"] + STEP_OPS


def folded_ops(optic) -> int:
    return model.OPS["affine"] + FOLDED_OPS
