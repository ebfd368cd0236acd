"""Bundle statistics on tensors, alive-mask aware (counterpart of the JAX
package's ``analysis/stats.py``).

Every reduction weights by the alive mask (and optionally the intensities),
which reproduces the reference's surviving-rays-only statistics with static
shapes. Detector geometry (centre, normal, rotation) arrives as host float64
arrays and is cast to the bundle's device and dtype.
"""

from __future__ import annotations

import torch

from ..ops.bundle import RayBundle
from ..ops.geometry import angle_between, kahan_add
from ..ops.precision import LIGHT_SPEED_MM_S


def _like(x, ref):
    return torch.as_tensor(x, dtype=ref.dtype, device=ref.device)


def _alive_w(bundle: RayBundle, intensity_weighted: bool = False):
    w = bundle.alive.to(bundle.p.dtype)
    if intensity_weighted:
        w = w * bundle.intensity.to(bundle.p.dtype)
    return w


def masked_mean(x, w, dim=None):
    if dim is None:
        return torch.sum(x * w) / torch.clamp(torch.sum(w), min=1e-30)
    return torch.sum(x * w, dim=dim) / torch.clamp(torch.sum(w, dim=dim), min=1e-30)


def std_scalar(x, w):
    """Weighted standard deviation of scalars."""
    m = masked_mean(x, w)
    return torch.sqrt(masked_mean((x - m) ** 2, w))


def std_points(xy, w):
    """sqrt(sum of per-axis variances) of a point cloud — the reference's
    spot-size SD."""
    m = masked_mean(xy, w[:, None], dim=0)
    var = masked_mean((xy - m) ** 2, w[:, None], dim=0)
    return torch.sqrt(torch.sum(var))


def central_direction(bundle: RayBundle):
    """Mean direction of surviving rays."""
    return masked_mean(bundle.d, _alive_w(bundle)[:, None], dim=0)


def central_point(bundle: RayBundle):
    return masked_mean(bundle.p, _alive_w(bundle)[:, None], dim=0)


def energy_transmission(source: RayBundle | float, out: RayBundle) -> float:
    """Energy transmission in percent: surviving intensity over the
    source's, given as its bundle or its total weight (the two bundles may
    live on different devices)."""
    num = float(out.weights().double().sum())
    den = float(source) if isinstance(source, (int, float)) else float(source.weights().double().sum())
    return 100.0 * num / max(den, 1e-30)


def numerical_aperture(bundle: RayBundle, refractive_index: float = 1.0):
    """n*sin(max angle to the central ray) over surviving rays."""
    c = central_direction(bundle)
    ang = angle_between(c.expand_as(bundle.d), bundle.d)
    ang = torch.where(bundle.alive, ang, 0.0)
    return torch.sin(torch.max(ang)) * refractive_index


def airy_radius(wavelength, na):
    """1.22/2 * lambda / NA, 0 for NA < 1e-3."""
    return 1.22 * 0.5 * wavelength / max(na, 1e-3) if na > 1e-3 else 0.0


# ---------------------------------------------------------------------------
# detector response (plane hit points, delays)
# ---------------------------------------------------------------------------


def detector_points_3d(bundle: RayBundle, centre, normal):
    """Lab-frame impact points on the detector plane and the leg lengths."""
    centre, normal = _like(centre, bundle.p), _like(normal, bundle.p)
    num = torch.sum(normal * (centre - bundle.p), dim=-1)
    den = torch.sum(bundle.d * normal, dim=-1)
    t = num / torch.where(torch.abs(den) > 1e-30, den, float("inf"))
    return bundle.p + t[:, None] * bundle.d, t


def detector_points_2d(bundle: RayBundle, centre, normal, rot):
    """In-plane coordinates with origin at the detector centre; ``rot`` is
    the host rotation taking ``normal`` onto ez. The product is written out
    component-wise in the bundle's dtype (full float32 on the card)."""
    pts3, _ = detector_points_3d(bundle, centre, normal)
    return plane_coords(pts3, centre, rot)


def plane_coords(pts3, centre, rot):
    """In-plane coordinates of lab points ``pts3`` on the detector plane
    (:func:`detector_points_2d` from impact points already computed)."""
    rel = pts3 - _like(centre, pts3)
    R = _like(rot, pts3)
    x = rel[:, 0] * R[0, 0] + rel[:, 1] * R[0, 1] + rel[:, 2] * R[0, 2]
    y = rel[:, 0] * R[1, 0] + rel[:, 1] * R[1, 1] + rel[:, 2] * R[1, 2]
    return torch.stack([x, y], dim=-1)


def centre_point_cloud(xy, alive):
    """Recentre on the (min+max)/2 midpoint of surviving points."""
    big = torch.finfo(xy.dtype).max
    lo = torch.min(torch.where(alive[:, None], xy, big), dim=0).values
    hi = torch.max(torch.where(alive[:, None], xy, -big), dim=0).values
    return xy - 0.5 * (lo + hi)


def detector_delays(bundle: RayBundle, centre, normal):
    """Ray delays [fs] relative to the mean travel time of surviving rays.
    The Kahan pair is cancelled against its mean before the compensation is
    applied, so fs-scale delays survive float32 metre-scale paths."""
    _, t = detector_points_3d(bundle, centre, normal)
    s, c = kahan_add(bundle.opl, bundle.opl_c, t)
    w = _alive_w(bundle)
    mean_s = masked_mean(s, w)
    mean_c = masked_mean(c, w)
    delta = (s - mean_s) - (c - mean_c)
    return delta / LIGHT_SPEED_MM_S * 1e15


def spot_and_duration(bundle: RayBundle, centre, normal, rot, intensity_weighted=False):
    """(spot SD [mm], duration SD [fs]) on a detector plane."""
    w = _alive_w(bundle, intensity_weighted)
    xy = detector_points_2d(bundle, centre, normal, rot)
    spot = std_points(xy, w)
    delays = detector_delays(bundle, centre, normal)
    duration = std_scalar(delays, w)
    return spot, duration
