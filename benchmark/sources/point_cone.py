"""The point source's Vogel cone (upstream ART's PointSource with its
Gaussian profile, ModuleSource): ``Divergence`` the half-angle [rad], the
source at the origin, the beam along +x, ray k at radius tan(divergence)
sqrt(k / n) and azimuth 2 pi frac(k g), g the golden turn fraction."""

from __future__ import annotations

import math
from decimal import Decimal, getcontext

import torch

from ..reference import optics as op

#: ART's default 1/e^2 edge of the Gaussian intensity
EDGE = math.exp(-2.0)
#: golden angle, sin/cos polynomials, radius law, direction
OPS_PER_RAY = 55


def _golden_parts():
    """frac(g) and frac(2^16 g) of the golden turn fraction g = (3 - sqrt 5)/2,
    to 40 digits, so frac(k g) splits into two float64 products that stay
    exact to ~1e-11 turns for k < 2^32."""
    getcontext().prec = 40
    g = (Decimal(3) - Decimal(5).sqrt()) / 2
    return float(g), float((g * 65536) % 1)


GOLDEN, GOLDEN_HI = _golden_parts()


def axis_rotation(dtype, device):
    """The rotation taking the canonical +z beam onto the lab's +x."""
    return op.rotation_from_to(op.vec((0, 0, 1), dtype, device), op.vec((1, 0, 0), dtype, device))


def rays_at(spec, k, n_total: int, *, dtype) -> op.Rays:
    """Rays of indices ``k`` (int64) of the ``n_total``-ray cone."""
    device, n = k.device, k.shape[0]
    divergence = float(spec["Divergence"])
    # a ray's index is its identity: its turn and radius fraction are worked
    # out in float64 at every dtype, the geometry from there in ``dtype``
    f64 = torch.float64
    hi, lo = torch.div(k, 65536, rounding_mode="floor"), torch.remainder(k, 65536)
    turns = torch.frac(hi.to(f64) * GOLDEN_HI + lo.to(f64) * GOLDEN).to(dtype)
    theta = 2.0 * math.pi * turns
    r = torch.sqrt((k.to(f64) / n_total).to(dtype)) * math.tan(divergence)
    cx, cy = r * torch.cos(theta), r * torch.sin(theta)
    inv = 1.0 / torch.sqrt(cx * cx + cy * cy + 1.0)
    d = op.apply(axis_rotation(dtype, device), (cx * inv, cy * inv, inv))
    zero = torch.zeros(n, dtype=dtype, device=device)
    return op.Rays((zero, zero.clone(), zero.clone()), d, zero.clone(),
                   torch.ones(n, dtype=torch.bool, device=device))


def index_weights(spec, k, n_total: int, *, dtype):
    """Gaussian weights of the radial law edge^(r^2 / r_max^2) = edge^(k / n)."""
    return torch.exp((math.log(EDGE) * k.to(torch.float64) / n_total).to(dtype))


def index_weight_total(spec, n_total: int) -> float:
    """Sum of :func:`index_weights` over the whole cone (a geometric sum)."""
    q = math.exp(math.log(EDGE) / n_total)
    return (1.0 - q ** n_total) / (1.0 - q)


def bundle_weights(spec, rays):
    """ART's ApplyGaussianIntensityToRayList on a diverging bundle: edge^(
    (tan a / a_max)^2), a the angle (Kahan's formula) of each ray to the
    bundle's mean direction and a_max the largest."""
    d = rays.d
    mean = torch.stack([c.mean() for c in d])
    mean = mean / torch.linalg.vector_norm(mean)
    a = (tuple(mean[i] - d[i] for i in range(3)), tuple(mean[i] + d[i] for i in range(3)))
    norm = [torch.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]) for v in a]
    angle = 2.0 * torch.atan2(norm[0], norm[1])
    return torch.exp((torch.tan(angle) / angle.max()) ** 2 * math.log(EDGE))


def sampled(spec, rays, weights, idx) -> dict:
    """The sampled rays' directions and intensities (all the cone's rays
    start at the origin)."""
    return {"d": torch.stack([c[idx] for c in rays.d], -1).double().cpu().numpy(),
            "intensity": weights[idx].double().cpu().numpy()}


def program_sample(spec, bundle, idx) -> dict:
    """The same fields of the port's source bundle (CPU tensors)."""
    idx = torch.as_tensor(idx)
    return {"d": bundle.d[idx].double().numpy(),
            "intensity": bundle.intensity[idx].double().numpy()}
