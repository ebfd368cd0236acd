"""The plane wave's Vogel disk (upstream ART's PlaneWaveDisk with its
Gaussian profile, ModuleSource): ``Divergence`` 0, ``SourceSize`` the beam's
diameter [mm], the disk centred on the origin in the plane x = 0 and every
ray along +x; ray k at radius (SourceSize / 2) sqrt(k / n) and azimuth
2 pi frac(k g), g the golden turn fraction, as the point source's cone
spreads its directions (:mod:`.point_cone`)."""

from __future__ import annotations

import math

import torch

from ..reference import optics as op
from . import point_cone

EDGE = point_cone.EDGE
#: the cone's synthesis (csrc/trace_common.cuh synth_source) less its
#: direction, a reciprocal square root and two products: the disk's rays all
#: point along the axis
OPS_PER_RAY = point_cone.OPS_PER_RAY - 4


def radius(spec) -> float:
    if float(spec["Divergence"]) != 0.0 or not float(spec["SourceSize"]) > 0.0:
        raise ValueError("a plane wave has Divergence 0 and a SourceSize above 0 "
                         f"(got {spec['Divergence']}, {spec['SourceSize']})")
    return 0.5 * float(spec["SourceSize"])


def rays_at(spec, k, n_total: int, *, dtype) -> op.Rays:
    """Rays of indices ``k`` (int64) of the ``n_total``-ray disk."""
    device, n = k.device, k.shape[0]
    f64 = torch.float64
    hi, lo = torch.div(k, 65536, rounding_mode="floor"), torch.remainder(k, 65536)
    turns = torch.frac(hi.to(f64) * point_cone.GOLDEN_HI + lo.to(f64) * point_cone.GOLDEN)
    theta = 2.0 * math.pi * turns.to(dtype)
    r = torch.sqrt((k.to(f64) / n_total).to(dtype)) * radius(spec)
    zero = torch.zeros(n, dtype=dtype, device=device)
    R = point_cone.axis_rotation(dtype, device)
    p = op.apply(R, (r * torch.cos(theta), r * torch.sin(theta), zero))
    d = op.apply(R, (zero, zero.clone(), zero + 1.0))
    return op.Rays(p, d, zero.clone(), torch.ones(n, dtype=torch.bool, device=device))


def index_weights(spec, k, n_total: int, *, dtype):
    """The kernels' Gaussian law edge^(r^2 / r_max^2) = edge^(k / n), the
    cone's."""
    return point_cone.index_weights(spec, k, n_total, dtype=dtype)


def index_weight_total(spec, n_total: int) -> float:
    return point_cone.index_weight_total(spec, n_total)


def bundle_weights(spec, rays):
    """ART's ApplyGaussianIntensityToRayList on a bundle that does not
    diverge: edge^((|p| / max |p|)^2), |p| each ray's distance from the
    origin."""
    dist = torch.sqrt(rays.p[0] ** 2 + rays.p[1] ** 2 + rays.p[2] ** 2)
    return torch.exp((dist / dist.max()) ** 2 * math.log(EDGE))


def sampled(spec, rays, weights, idx) -> dict:
    """The sampled rays' points, directions and intensities."""
    return {"p": torch.stack([c[idx] for c in rays.p], -1).double().cpu().numpy(),
            "d": torch.stack([c[idx] for c in rays.d], -1).double().cpu().numpy(),
            "intensity": weights[idx].double().cpu().numpy()}


def program_sample(spec, bundle, idx) -> dict:
    """The same fields of the port's source bundle (CPU tensors)."""
    idx = torch.as_tensor(idx)
    return {"p": bundle.p[idx].double().numpy(), "d": bundle.d[idx].double().numpy(),
            "intensity": bundle.intensity[idx].double().numpy()}
