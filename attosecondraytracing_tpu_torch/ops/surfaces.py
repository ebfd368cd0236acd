"""Mirror surfaces as implicit functions with batched, Newton-polished
intersections (counterpart of the JAX package's ``ops/surfaces.py``).

Every surface provides a closed-form seed for the ray parameter ``t``
(quadratic, or Ferrari quartic for the toroid), a few Newton iterations on a
distance-like residual, and branch/support filters; the nearest valid hit
wins. All functions work on tensors in component form ``(x, y, z)`` so each
element of a (N,) tensor carries one ray.

Dtype branches follow the JAX package exactly: the toroid takes the
osculating-paraboloid seed + Newton fast path in float32 and the four exact
Ferrari roots + sphere seeds + 6 Newton steps in float64; the float32 hit
tolerance is scale-aware (:func:`_hit_tol_for`). Surface parameters are
python floats, so their derived constants are formed in float64 and rounded
to the tensor dtype once, as in JAX.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from . import supports as sup
from .precision import HIT_TOL, T_EPS, rsqrt

_NEWTON_ITERS = 3
_NEWTON_ITERS_TOROID = 6
#: float32 toroid fast path: residual evaluations (one Newton correction
#: plus one shared evaluation at the corrected root), as in the JAX package
_NEWTON_ITERS_TOROID_FAST = 2

_TOROID_EXACT = os.environ.get("ART_TPU_TOROID_EXACT", "0") == "1"


class Plane(NamedTuple):
    """z = 0 plane (mirrors and masks)."""


class Sphere(NamedTuple):
    """Full sphere x^2+y^2+z^2 = R^2, mirror patch on the z<0 branch."""

    radius: float


class Parabola(NamedTuple):
    """Paraboloid z = (x^2+y^2)/(2p); ``center_x`` is the off-axis distance
    of the support centre."""

    p: float
    center_x: float


class Toroid(NamedTuple):
    """Torus (sqrt(x^2+z^2)-R)^2 + y^2 = r^2, patch on the z < -R branch."""

    major_radius: float
    minor_radius: float


class Ellipsoid(NamedTuple):
    """Ellipsoid (x/a)^2 + (y^2+z^2)/b^2 = 1, patch on z<0."""

    a: float
    b: float
    center_x: float
    center_z: float


class Cylinder(NamedTuple):
    """Cylinder y^2 + z^2 = R^2 (axis along x), patch on z<0."""

    radius: float


def _hit_tol_for(surface, dtype, tol):
    """Scale-aware hit tolerance: in float32 the residual's rounding noise
    is a few ulps of the surface-frame coordinate scale, so the tolerance
    rises to 6 ulps of that scale (float64 keeps the nominal tolerance)."""
    if dtype != torch.float32:
        return tol
    if isinstance(surface, Toroid):
        scale = surface.major_radius + surface.minor_radius
    elif isinstance(surface, (Sphere, Cylinder)):
        scale = surface.radius
    elif isinstance(surface, Ellipsoid):
        scale = max(surface.a, surface.b)
    else:
        return tol
    return max(tol, 6.0 * float(np.finfo(np.float32).eps) * scale)


def _where(cond, a, b):
    return torch.where(cond, a, b)


# ---------------------------------------------------------------------------
# residuals g(t): distance-like implicit functions, conditioned for float32
# ---------------------------------------------------------------------------


def _residual_c(surface, x, y, z, ux, uy, uz):
    if isinstance(surface, Sphere):
        rr = x * x + y * y + z * z
        inv_r = rsqrt(torch.clamp(rr, min=1e-30))
        return rr * inv_r - surface.radius, (x * ux + y * uy + z * uz) * inv_r
    if isinstance(surface, Cylinder):
        rr = y * y + z * z
        inv_r = rsqrt(torch.clamp(rr, min=1e-30))
        return rr * inv_r - surface.radius, (y * uy + z * uz) * inv_r
    if isinstance(surface, Parabola):
        p = surface.p
        h = z - (x * x + y * y) / (2.0 * p)
        hp = uz - (x * ux + y * uy) / p
        scale = p * rsqrt(x * x + y * y + p * p)
        return h * scale, hp * scale
    if isinstance(surface, Ellipsoid):
        inv_a2 = 1.0 / (surface.a * surface.a)
        inv_b2 = 1.0 / (surface.b * surface.b)
        f = x * x * inv_a2 + (y * y + z * z) * inv_b2 - 1.0
        fp = 2.0 * (x * ux * inv_a2 + (y * uy + z * uz) * inv_b2)
        gg = (x * inv_a2) ** 2 + (y * inv_b2) ** 2 + (z * inv_b2) ** 2
        scale = 0.5 * rsqrt(torch.clamp(gg, min=1e-30))
        return f * scale, fp * scale
    if isinstance(surface, Toroid):
        R, r = surface.major_radius, surface.minor_radius
        rho2 = x * x + z * z
        inv_rho = rsqrt(torch.clamp(rho2, min=1e-30))
        w = rho2 * inv_rho - R
        s2 = w * w + y * y
        inv_s = rsqrt(torch.clamp(s2, min=1e-30))
        g = s2 * inv_s - r
        drho_dt = (x * ux + z * uz) * inv_rho
        gp = (w * drho_dt + y * uy) * inv_s
        return g, gp
    raise TypeError(f"unknown surface {type(surface)}")


def _polish_candidates(surface, q, u, cands, iters):
    """Newton-polish candidate roots; returns a list of (t, |g|, (x, y, z)).
    The validity residual |g| is the one of the final iteration, while t and
    the hit point carry all ``iters`` corrections (as in the JAX package)."""
    px, py, pz = q
    ux, uy, uz = u
    out = []
    for t in cands:
        g_abs = None
        for _ in range(iters):
            x = px + t * ux
            y = py + t * uy
            z = pz + t * uz
            g, gp = _residual_c(surface, x, y, z, ux, uy, uz)
            g_abs = torch.abs(g)
            t = t - g / _where(torch.abs(gp) > 1e-12, gp, float("inf"))
        x = px + t * ux
        y = py + t * uy
        z = pz + t * uz
        out.append((t, g_abs, (x, y, z)))
    return out


# ---------------------------------------------------------------------------
# closed-form seeds
# ---------------------------------------------------------------------------


def _solve_quadratic(a, b, c):
    """Stable quadratic roots (citardauq form); invalid roots -> nan."""
    disc = b * b - 4.0 * a * c
    ok = disc >= 0.0
    sq = torch.sqrt(_where(ok, disc, 1.0))
    sq = _where(ok, sq, 0.0)
    qq = -0.5 * (b + torch.sign(b) * sq)
    qq = _where(b == 0.0, -0.5 * sq, qq)
    tiny = 1e-30
    linear = torch.abs(a) < tiny
    num1 = _where(linear, -c, qq)
    den1 = _where(
        linear,
        _where(torch.abs(b) > tiny, b, float("inf")),
        _where(torch.abs(a) > tiny, a, float("inf")),
    )
    t1 = num1 / den1
    t2 = _where(linear, float("inf"), c / _where(torch.abs(qq) > tiny, qq, float("inf")))
    return _where(ok, t1, float("nan")), _where(ok, t2, float("nan"))


def _quadratic_coeffs(surface, q, u):
    x, y, z = q
    ux, uy, uz = u
    if isinstance(surface, Sphere):
        a = torch.ones_like(x)
        b = 2.0 * (ux * x + uy * y + uz * z)
        c = x * x + y * y + z * z - surface.radius**2
    elif isinstance(surface, Cylinder):
        a = uy * uy + uz * uz
        b = 2.0 * (uy * y + uz * z)
        c = y * y + z * z - surface.radius**2
    elif isinstance(surface, Parabola):
        pp = surface.p
        a = ux * ux + uy * uy
        b = 2.0 * (ux * x + uy * y) - 2.0 * pp * uz
        c = x * x + y * y - 2.0 * pp * z
    elif isinstance(surface, Ellipsoid):
        a2, b2 = surface.a**2, surface.b**2
        a = (uy * uy + uz * uz) / b2 + ux * ux / a2
        b = 2.0 * ((uy * y + uz * z) / b2 + ux * x / a2)
        c = (y * y + z * z) / b2 + x * x / a2 - 1.0
    else:
        raise TypeError(f"not a quadratic surface: {type(surface)}")
    return a, b, c


def _cbrt(x):
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def _largest_real_cubic_root(a2, a1, a0):
    """Largest real root of y^3 + a2 y^2 + a1 y + a0 = 0 (trigonometric /
    Cardano forms selected elementwise)."""
    p = a1 - a2 * a2 / 3.0
    q = 2.0 * a2**3 / 27.0 - a2 * a1 / 3.0 + a0
    disc = (q / 2.0) ** 2 + (p / 3.0) ** 3
    tri = disc <= 0.0
    p_safe = _where(p < 0.0, p, -1.0)
    mp3 = torch.sqrt(-p_safe / 3.0)
    denom = 2.0 * p_safe * mp3
    cos_arg = torch.clamp(3.0 * q / denom, -1.0 + 1e-12, 1.0 - 1e-12)
    cos_arg = _where(torch.abs(p) > 1e-30, cos_arg, 0.0)
    theta = torch.arccos(cos_arg) / 3.0
    y_tri = 2.0 * mp3 * torch.cos(theta)
    sq = torch.sqrt(_where(disc > 0.0, disc, 1.0))
    u_c = _cbrt(_where(disc > 0.0, -q / 2.0 + sq, 1.0))
    v_c = _cbrt(_where(disc > 0.0, -q / 2.0 - sq, 1.0))
    y_car = u_c + v_c
    w = _where(tri, y_tri, y_car)
    return w - a2 / 3.0


def _quartic_roots(b, c, d, e):
    """Real roots of t^4 + b t^3 + c t^2 + d t + e (Ferrari); complex-pair
    slots are nan. Returns a list of 4 tensors."""
    b2 = b * b
    P = c - 3.0 * b2 / 8.0
    Q = d - b * c / 2.0 + b * b2 / 8.0
    R0 = e - b * d / 4.0 + b2 * c / 16.0 - 3.0 * b2 * b2 / 256.0
    y0 = _largest_real_cubic_root(2.0 * P, P * P - 4.0 * R0, -Q * Q)
    y0 = torch.clamp(y0, min=0.0)
    safe_u = y0 > 1e-24
    u = torch.sqrt(_where(safe_u, y0, 1.0))
    u = _where(safe_u, u, 0.0)
    qu = _where(safe_u, Q / _where(safe_u, 2.0 * u, 1.0), 0.0)
    A = (P + y0) / 2.0 - qu
    B = (P + y0) / 2.0 + qu
    db = P * P - 4.0 * R0
    sq_db = torch.sqrt(_where(db > 0.0, db, 1.0))
    sq_db = _where(db > 0.0, sq_db, 0.0)
    A_bq = (P + sq_db) / 2.0
    B_bq = (P - sq_db) / 2.0
    A = _where(safe_u, A, A_bq)
    B = _where(safe_u, B, B_bq)
    ones = torch.ones_like(u)
    s1a, s1b = _solve_quadratic(ones, u, A)
    s2a, s2b = _solve_quadratic(ones, -u, B)
    shift = b / 4.0
    return [s1a - shift, s1b - shift, s2a - shift, s2b - shift]


def _paraboloid_seed_pick(surface, q, u, t_eps):
    """Osculating-paraboloid seed for the float32 toroid fast path, with the
    candidate selection in numerator/denominator form (the nearer forward
    crossing on the mirror side wins; with none valid the first root is the
    Newton start and the post-polish test rejects genuine misses)."""
    R, r = surface.major_radius, surface.minor_radius
    x, y, z = q
    ux, uy, uz = u
    inv_2A = 0.5 / (R + r)
    inv_2B = 0.5 / r
    a = -(ux * ux * inv_2A + uy * uy * inv_2B)
    b = uz - 2.0 * (x * ux * inv_2A + y * uy * inv_2B)
    c = z + (R + r) - (x * x * inv_2A + y * y * inv_2B)
    disc = b * b - 4.0 * a * c
    ok = disc >= 0.0
    sq = _where(ok, torch.sqrt(_where(ok, disc, 1.0)), 0.0)
    qq = _where(b == 0.0, -0.5 * sq, -0.5 * (b + torch.sign(b) * sq))
    n1, d1 = qq, a
    n2, d2 = c, qq

    def _valid(n, d):
        forward = (n - t_eps * d) * d > 0.0
        mirror_side = d * (z * d + n * uz) < 0.0
        return forward & mirror_side

    v1 = _valid(n1, d1)
    v2 = _valid(n2, d2)
    t1_nearer = (n1 * d2 - n2 * d1) * (d1 * d2) <= 0.0
    pick1 = (~v2) | (v1 & t1_nearer)
    num = _where(pick1, n1, n2)
    den = _where(pick1, d1, d2)
    # a vanishing denominator selects t = 0 (the post-polish test rejects it)
    t = _where(den != 0.0, num / _where(den != 0.0, den, 1.0), 0.0)
    return _where(ok, t, -1.0)


def _sphere_seeds(surface, q, u):
    """Roots of the osculating sphere |q| = R + r of the toroid patch."""
    R, r = surface.major_radius, surface.minor_radius
    x, y, z = q
    ux, uy, uz = u
    b_s = 2.0 * (ux * x + uy * y + uz * z)
    c_s = x * x + y * y + z * z - (R + r) ** 2
    s1, s2 = _solve_quadratic(torch.ones_like(b_s), b_s, c_s)
    return [s1, s2]


def _toroid_seeds(surface, q, u):
    """4 Ferrari roots of the exact quartic (nondimensionalized by R) + the
    2 roots of the osculating sphere."""
    R, r = surface.major_radius, surface.minor_radius
    x, y, z = q
    ux, uy, uz = u
    K = 2.0 * (ux * x + uy * y + uz * z)
    L = x * x + y * y + z * z + R * R - r * r
    G = 4.0 * R * R * (ux * ux + uz * uz)
    H = 8.0 * R * R * (ux * x + uz * z)
    II = 4.0 * R * R * (x * x + z * z)
    b = 2.0 * K
    c = K * K + 2.0 * L - G
    dd = 2.0 * K * L - H
    e = L * L - II
    s = R
    quartic = _quartic_roots(b / s, c / s**2, dd / s**3, e / s**4)
    quartic = [_where(torch.isfinite(t), t, -1.0) * s for t in quartic]
    return quartic + _sphere_seeds(surface, q, u)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def support_offset_xy(surface):
    """Offset of the support centre in the local x-y plane."""
    if isinstance(surface, (Parabola, Ellipsoid)):
        return surface.center_x, 0.0
    return 0.0, 0.0


def _branch_ok_z(surface, z):
    if isinstance(surface, (Sphere, Cylinder, Ellipsoid)):
        return z < 0.0
    if isinstance(surface, Toroid):
        return z < -surface.major_radius
    return torch.ones(z.shape, dtype=torch.bool, device=z.device)


def _toroid_fast_root(surface, q, u, t_eps):
    """Shared float32 fast path for the toroid: the paraboloid seed, one
    Newton correction, and one final residual evaluation shared by root
    validation, the hit point and the normal. Returns
    ``(t, g_abs, (x, y, z), (inv_rho, inv_s, w))``."""
    qx, qy, qz = q
    ux, uy, uz = u
    R, r = surface.major_radius, surface.minor_radius
    t = _paraboloid_seed_pick(surface, q, u, t_eps)
    for _ in range(_NEWTON_ITERS_TOROID_FAST - 1):
        x, y, z = qx + t * ux, qy + t * uy, qz + t * uz
        g, gp = _residual_c(surface, x, y, z, ux, uy, uz)
        big = torch.abs(gp) > 1e-12
        t = t - g * _where(big, 1.0 / _where(big, gp, 1.0), 0.0)
    x, y, z = qx + t * ux, qy + t * uy, qz + t * uz
    inv_rho = rsqrt(torch.clamp(x * x + z * z, min=1e-30))
    w = (x * x + z * z) * inv_rho - R
    s2_ = w * w + y * y
    inv_s = rsqrt(torch.clamp(s2_, min=1e-30))
    g_abs = torch.abs(s2_ * inv_s - r)
    return t, g_abs, (x, y, z), (inv_rho, inv_s, w)


def _toroid_fast(qx, surface):
    return isinstance(surface, Toroid) and qx.dtype == torch.float32 and not _TOROID_EXACT


def intersect_c(surface, support, q, u, t_eps=T_EPS, tol=HIT_TOL):
    """Component-form nearest valid intersection. Returns (t, hit) with
    t = 0 where there is no hit."""
    qx, qy, qz = q
    ux, uy, uz = u

    if isinstance(surface, Plane):
        t = -qz / _where(torch.abs(uz) > 1e-30, uz, float("inf"))
        ox, oy = support_offset_xy(surface)
        on_sup = sup.include(support, qx + t * ux - ox, qy + t * uy - oy)
        return t, (t > t_eps) & on_sup

    if isinstance(surface, Toroid):
        if _toroid_fast(qx, surface):
            t, g_abs, (x, y, z), _ = _toroid_fast_root(surface, q, u, t_eps)
            ox, oy = support_offset_xy(surface)
            hit = (
                (t > t_eps)
                & (g_abs < _hit_tol_for(surface, qx.dtype, tol))
                & (z < -surface.major_radius)
                & sup.include(support, x - ox, y - oy)
            )
            return _where(hit, t, 0.0), hit
        cands = _toroid_seeds(surface, q, u)
        iters = _NEWTON_ITERS_TOROID
    else:
        a, b, c = _quadratic_coeffs(surface, q, u)
        t1, t2 = _solve_quadratic(a, b, c)
        cands = [t1, t2]
        iters = _NEWTON_ITERS

    cands = [_where(torch.isfinite(t), t, -1.0) for t in cands]
    polished = _polish_candidates(surface, q, u, cands, iters)
    ox, oy = support_offset_xy(surface)
    tol_eff = _hit_tol_for(surface, qx.dtype, tol)
    t_best = torch.full_like(qx, float("inf"))
    for t, g_abs, (x, y, z) in polished:
        valid = (
            (t > t_eps)
            & (g_abs < tol_eff)
            & _branch_ok_z(surface, z)
            & sup.include(support, x - ox, y - oy)
        )
        t_best = torch.minimum(t_best, _where(valid, t, float("inf")))
    hit = torch.isfinite(t_best)
    return _where(hit, t_best, 0.0), hit


def intersect(surface, support, p, d, t_eps=T_EPS, tol=HIT_TOL):
    """Nearest valid intersection of local-frame rays ``p`` (N, 3) along
    unit directions ``d`` (:func:`intersect_c` on their components).
    Returns ``(t, hit)``; ``hit`` is False for rays that miss (wrong branch,
    outside the support, behind the ray, or no real root)."""
    return intersect_c(surface, support, (p[..., 0], p[..., 1], p[..., 2]),
                       (d[..., 0], d[..., 1], d[..., 2]), t_eps=t_eps, tol=tol)


def normal_at(surface, q):
    """Unit normals (..., 3) on the +z ('up') side at local points ``q``
    (:func:`normal_c` on their components)."""
    return torch.stack(normal_c(surface, q[..., 0], q[..., 1], q[..., 2]), dim=-1)


def normal_c(surface, x, y, z):
    """Unit 'up' normal in component form."""
    one = torch.ones_like(x)
    if isinstance(surface, Plane):
        zero = torch.zeros_like(x)
        return zero, zero, one
    if isinstance(surface, Sphere):
        nx, ny, nz = -x, -y, -z
    elif isinstance(surface, Cylinder):
        nx, ny, nz = torch.zeros_like(x), -y, -z
    elif isinstance(surface, Parabola):
        nx, ny, nz = -x, -y, torch.full_like(x, surface.p)
    elif isinstance(surface, Ellipsoid):
        inv_a2 = 1.0 / (surface.a * surface.a)
        inv_b2 = 1.0 / (surface.b * surface.b)
        nx, ny, nz = -x * inv_a2, -y * inv_b2, -z * inv_b2
    elif isinstance(surface, Toroid):
        R = surface.major_radius
        inv_rho = rsqrt(torch.clamp(x * x + z * z, min=1e-30))
        w = 1.0 - R * inv_rho
        nx, ny, nz = -w * x, -y, -w * z
    else:
        raise TypeError(f"unknown surface {type(surface)}")
    inv = rsqrt(nx * nx + ny * ny + nz * nz)
    return nx * inv, ny * inv, nz * inv


def normal_at_root_c(surface, x, y, z):
    """Unit 'up' normal for a point ON the surface, using the root identities
    (|q| = R for the sphere, |(y,z)| = R for the cylinder, the minor radius
    for the toroid) in place of a normalizing rsqrt."""
    if isinstance(surface, Sphere):
        inv = -1.0 / surface.radius
        return x * inv, y * inv, z * inv
    if isinstance(surface, Cylinder):
        inv = -1.0 / surface.radius
        return torch.zeros_like(x), y * inv, z * inv
    if isinstance(surface, Toroid):
        R, r = surface.major_radius, surface.minor_radius
        inv_rho = rsqrt(torch.clamp(x * x + z * z, min=1e-30))
        a = (1.0 - R * inv_rho) / r
        return -a * x, -y / r, -a * z
    return normal_c(surface, x, y, z)


def intersect_with_normal_c(surface, support, q, u, t_eps=T_EPS, tol=HIT_TOL):
    """Fused intersection + unit normal + hit point. Returns
    ``(t, hit, (nx, ny, nz), (x, y, z))``; values for missed rays are finite
    garbage that callers mask by ``hit``."""
    qx, qy, qz = q
    ux, uy, uz = u
    if _toroid_fast(qx, surface):
        t, g_abs, (x, y, z), (inv_rho, inv_s, w) = _toroid_fast_root(surface, q, u, t_eps)
        a = w * inv_rho * inv_s
        nx, ny, nz = -a * x, -y * inv_s, -a * z
        ox, oy = support_offset_xy(surface)
        hit = (
            (t > t_eps)
            & (g_abs < _hit_tol_for(surface, qx.dtype, tol))
            & (z < -surface.major_radius)
            & sup.include(support, x - ox, y - oy)
        )
        return _where(hit, t, 0.0), hit, (nx, ny, nz), (x, y, z)
    t, hit = intersect_c(surface, support, q, u, t_eps=t_eps, tol=tol)
    x, y, z = qx + t * ux, qy + t * uy, qz + t * uz
    return t, hit, normal_at_root_c(surface, x, y, z), (x, y, z)


def slope_normal_add(n1, n2):
    """Compose two 'up' normals (..., 3) by adding their surface slopes
    (vectorized ART/ModuleGeometry.py:394-407). Returns an unnormalized
    [-sum gx, -sum gy, 1] normal."""
    g1x = -n1[..., 0] / n1[..., 2]
    g1y = -n1[..., 1] / n1[..., 2]
    g2x = -n2[..., 0] / n2[..., 2]
    g2y = -n2[..., 1] / n2[..., 2]
    return torch.stack([-(g1x + g2x), -(g1y + g2y), torch.ones_like(g1x)], dim=-1)
