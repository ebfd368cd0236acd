"""Plain ray optics of the benchmark's chains, in PyTorch at any dtype.

The yardstick's own physics, written from the semantics of upstream ART
(github.com/mightymightys/AttosecondRaytracing: ModuleProcessing's
placement, ModuleSource's Vogel cone and Gaussian profile, ModuleMirror's
toroid and deformed mirror, ModuleMask, ModuleDefects' Zernike sum) and
frozen here. It imports nothing of the program under test, and takes none
of its numbers: every pose, ray, weight and plane is worked out again from
the configuration file and the request.

Every function takes the dtype and device to compute in: float64 for the
reference, a lower precision for the control that stands in the program's
place (``benchmark/control.py``). Rays are kept in component form, one
tensor per coordinate.
"""

from __future__ import annotations

import math
from decimal import Decimal, getcontext
from typing import NamedTuple

import torch

LIGHT_SPEED_MM_S = 299792458000.0
FS_PER_MM = 1e15 / LIGHT_SPEED_MM_S
#: a hit must lie this far [mm] ahead of the ray
T_MIN = 1e-9
#: a Newton root is a hit when its distance-like residual is below this [mm]
HIT_TOL = 1e-3
NEWTON_STEPS = 8


def _golden_parts():
    """frac(g) and frac(2^16 g) of the golden turn fraction g = (3 - sqrt 5)/2,
    to 40 digits, so frac(k g) splits into two float64 products that stay
    exact to ~1e-11 turns for k < 2^32."""
    getcontext().prec = 40
    g = (Decimal(3) - Decimal(5).sqrt()) / 2
    return float(g), float((g * 65536) % 1)


GOLDEN, GOLDEN_HI = _golden_parts()


class Optic(NamedTuple):
    """One optic of a chain: a mask or a toroidal mirror in its own frame,
    whose origin is the vertex (toroid (sqrt(x^2 + (z - major - minor)^2) -
    major)^2 + y^2 = minor^2, the patch on z < minor, the support centred at
    the origin), with Zernike height
    errors ``((n, m, coefficient [mm]), ...)`` over the circle of
    ``zernike_radius``."""

    kind: str
    support: tuple
    major: float = 0.0
    minor: float = 0.0
    zernike: tuple = ()
    zernike_radius: float = 1.0


class Pose(NamedTuple):
    """Lab-frame pose: position, unit normal, unit major axis, (3,) each."""

    position: torch.Tensor
    normal: torch.Tensor
    major: torch.Tensor


def toroid_radii(focal, incidence_deg):
    """The astigmatism-free toroid for a focal length and incidence angle."""
    i = math.radians(incidence_deg)
    return 2.0 * focal * (1.0 / math.cos(i) - math.cos(i)), 2.0 * focal * math.cos(i)


def _support(spec: dict) -> tuple:
    if spec["kind"] == "round_hole":
        return ("round_hole", float(spec["Radius"]), float(spec["RadiusHole"]),
                float(spec["CenterHoleX"]), float(spec["CenterHoleY"]))
    if spec["kind"] == "rectangle":
        return ("rectangle", float(spec["dimX"]), float(spec["dimY"]))
    raise ValueError(f"support kind {spec['kind']!r} is not in the reference")


def optics_from_config(cfg: dict) -> list:
    """The optics of a configuration file's ``optics`` list."""
    out = []
    for spec in cfg["optics"]:
        support = _support(spec["support"])
        if spec["kind"] == "mask":
            out.append(Optic("mask", support))
            continue
        if spec["kind"] != "toroidal":
            raise ValueError(f"optic kind {spec['kind']!r} is not in the reference")
        major, minor = toroid_radii(spec["focal"], spec["incidence"])
        zernike, radius = (), 1.0
        if spec.get("zernike"):
            zernike = tuple((int(n), int(m), float(c)) for n, m, c in spec["zernike"])
            # the support's circumscribed circle
            radius = math.hypot(support[1] / 2.0, support[2] / 2.0)
        out.append(Optic("toroid", support, major, minor, zernike, radius))
    return out


def on_support(support: tuple, x, y):
    if support[0] == "round_hole":
        _, r, rh, cx, cy = support
        return (x * x + y * y <= r * r) & ~((x - cx) ** 2 + (y - cy) ** 2 <= rh * rh)
    _, dx, dy = support
    return (torch.abs(x) <= 0.5 * dx) & (torch.abs(y) <= 0.5 * dy)


# ---------------------------------------------------------------------------
# small-vector geometry
# ---------------------------------------------------------------------------


def vec(values, dtype, device):
    return torch.tensor([float(v) for v in values], dtype=dtype, device=device)


def rodrigues(axis, angle):
    """Rotation matrix by ``angle`` [rad] about ``axis`` (tensors)."""
    k = axis / torch.linalg.vector_norm(axis)
    zero = torch.zeros((), dtype=k.dtype, device=k.device)
    K = torch.stack([torch.stack([zero, -k[2], k[1]]), torch.stack([k[2], zero, -k[0]]),
                     torch.stack([-k[1], k[0], zero])])
    angle = torch.as_tensor(angle, dtype=k.dtype, device=k.device)
    eye = torch.eye(3, dtype=k.dtype, device=k.device)
    return eye + torch.sin(angle) * K + (1.0 - torch.cos(angle)) * (K @ K)


def rotation_from_to(a, b):
    """The rotation taking direction ``a`` onto ``b`` (about a x b)."""
    a = a / torch.linalg.vector_norm(a)
    b = b / torch.linalg.vector_norm(b)
    axis = torch.linalg.cross(a, b)
    s = torch.linalg.vector_norm(axis)
    c = torch.dot(a, b)
    if float(s) < 1e-12:
        eye = torch.eye(3, dtype=a.dtype, device=a.device)
        return eye if float(c) > 0 else -eye
    return rodrigues(axis, torch.atan2(s, c))


def frame(pose: Pose):
    """Lab -> optic rotation: rows major, normal x major, normal."""
    return torch.stack([pose.major, torch.linalg.cross(pose.normal, pose.major), pose.normal])


def roll(pose: Pose, angle_deg) -> Pose:
    """The pose rotated about its major axis (ART's rotate_roll_by)."""
    R = rodrigues(pose.major, math.radians(angle_deg))
    return pose._replace(normal=R @ pose.normal)


def pitch(pose: Pose, angle_deg) -> Pose:
    """The pose rotated about normal x major (ART's rotate_pitch_by: the
    major axis turns with the normal)."""
    R = rodrigues(torch.linalg.cross(pose.normal, pose.major), math.radians(angle_deg))
    return pose._replace(normal=R @ pose.normal, major=R @ pose.major)


def misaligned(poses, request) -> list:
    """The poses with the request's optic rolled by ``roll_deg``, then
    pitched by ``pitch_deg`` where the request gives one (the order of
    ``OpticalChain.rotate_OE`` calls the program side makes)."""
    if "optic" not in request:
        return list(poses)
    out = list(poses)
    i = int(request["optic"])
    out[i] = roll(out[i], request["roll_deg"])
    if "pitch_deg" in request:
        out[i] = pitch(out[i], request["pitch_deg"])
    return out


def perturb(pose: Pose, angles, shifts) -> Pose:
    """The pose turned by (pitch, roll, yaw) [rad] about its (normal x major,
    major, normal) axes and shifted along (normal, major, normal x major)
    [mm]; differentiable in ``angles`` and ``shifts``."""
    m, n = pose.major, pose.normal
    c = torch.linalg.cross(n, m)
    R = rodrigues(c, angles[0]) @ rodrigues(m, angles[1]) @ rodrigues(n, angles[2])
    return Pose(position=pose.position + shifts[0] * n + shifts[1] * m + shifts[2] * c,
                normal=R @ n, major=R @ m)


# ---------------------------------------------------------------------------
# the trace
# ---------------------------------------------------------------------------


class Rays(NamedTuple):
    """Lab-frame rays: point, unit direction (3-tuples of (N,) tensors),
    optical path [mm] and alive mask."""

    p: tuple
    d: tuple
    opl: torch.Tensor
    alive: torch.Tensor


def _apply(R, v):
    return tuple(R[i, 0] * v[0] + R[i, 1] * v[1] + R[i, 2] * v[2] for i in range(3))


def _apply_t(R, v):
    return tuple(R[0, i] * v[0] + R[1, i] * v[1] + R[2, i] * v[2] for i in range(3))


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


def hit_tolerance(dtype, optic) -> float:
    """The residual [mm] under which a Newton root is a hit: ``HIT_TOL``, or
    four rounding units of the tube radius where the dtype is coarser."""
    return max(HIT_TOL, 4.0 * torch.finfo(dtype).eps * optic.minor)


def _toroid_residual(optic, x, y, z, ux, uy, uz):
    """Distance-like residual g of a point to the toroid and its derivative
    along the ray, in the vertex frame (the vertex at the origin, z along
    the normal there): every term is a small difference written without
    cancellation, so a low precision keeps its digits. With a = major +
    minor - z and rho = sqrt(x^2 + a^2), w = rho - major = minor - z +
    x^2 / (rho + a) and g = sqrt(w^2 + y^2) - minor."""
    a = (optic.major + optic.minor) - z
    rho = a * torch.sqrt(1.0 + (x / a) ** 2)
    w_m = x * x / (rho + a) - z
    w = w_m + optic.minor
    s = torch.sqrt(w * w + y * y)
    g = (w_m * (w + optic.minor) + y * y) / (s + optic.minor)
    gp = (w * (x * ux - a * uz) / rho + y * uy) / s
    return g, gp


def _toroid_normal(optic, x, y, z):
    a = (optic.major + optic.minor) - z
    rho = a * torch.sqrt(1.0 + (x / a) ** 2)
    w = (x * x / (rho + a) - z + optic.minor) / rho
    nx, ny, nz = -w * x, -y, w * a
    inv = 1.0 / torch.sqrt(nx * nx + ny * ny + nz * nz)
    return nx * inv, ny * inv, nz * inv


def _toroid_hit(optic, q, u):
    """(t, valid, point, normal) of the rays (vertex frame) on the toroid:
    Newton from the vertex plane z = 0, then the Zernike height shift along
    the ray."""
    qx, qy, qz = q
    ux, uy, uz = u
    # the root's derivatives by the implicit function theorem: Newton runs
    # untaped to the root, and one last step on the tape, whose derivative
    # there is -(dg/dparameters) / (dg/dt)
    with torch.no_grad():
        t = -qz / uz
        for _ in range(NEWTON_STEPS - 1):
            g, gp = _toroid_residual(optic, qx + t * ux, qy + t * uy, qz + t * uz, ux, uy, uz)
            t = t - g / gp
    g, gp = _toroid_residual(optic, qx + t * ux, qy + t * uy, qz + t * uz, ux, uy, uz)
    t = t - g / gp
    x, y, z = qx + t * ux, qy + t * uy, qz + t * uz
    g, _ = _toroid_residual(optic, x, y, z, ux, uy, uz)
    valid = ((t > T_MIN) & (torch.abs(g) < hit_tolerance(qx.dtype, optic)) & (z < optic.minor)
             & on_support(optic.support, x, y))
    normal = _toroid_normal(optic, x, y, z)
    if optic.zernike:
        h = zernike_height(optic.zernike, x / optic.zernike_radius, y / optic.zernike_radius)
        cos_alpha = torch.clamp(-(ux * normal[0] + uy * normal[1] + uz * normal[2]), min=1e-6)
        t = t - h / cos_alpha
        x, y, z = qx + t * ux, qy + t * uy, qz + t * uz
        normal = _toroid_normal(optic, x, y, z)
    return t, valid, (x, y, z), normal


def step(optic: Optic, pose: Pose, rays: Rays) -> Rays:
    """The rays after one optic; rays it loses keep their state, dead."""
    R = frame(pose)
    rel = tuple(rays.p[i] - pose.position[i] for i in range(3))
    q = _apply(R, rel)
    u = _apply(R, rays.d)
    if optic.kind == "mask":
        t = -q[2] / u[2]
        x, y = q[0] + t * u[0], q[1] + t * u[1]
        ok = (t > T_MIN) & ~on_support(optic.support, x, y)
        point, d_out = (x, y, torch.zeros_like(x)), rays.d
        p_out = tuple(v + pose.position[i] for i, v in enumerate(_apply_t(R, point)))
    else:
        t, ok, (x, y, z), n = _toroid_hit(optic, q, u)
        dn = u[0] * n[0] + u[1] * n[1] + u[2] * n[2]
        r = tuple(u[i] - 2.0 * dn * n[i] for i in range(3))
        p_out = tuple(v + pose.position[i] for i, v in enumerate(_apply_t(R, (x, y, z))))
        d_out = _apply_t(R, r)
    alive = rays.alive & ok
    keep = lambda new, old: torch.where(alive, new, old)  # noqa: E731
    return Rays(p=tuple(keep(a, b) for a, b in zip(p_out, rays.p)),
                d=tuple(keep(a, b) for a, b in zip(d_out, rays.d)),
                opl=rays.opl + torch.where(alive, t, torch.zeros_like(t)), alive=alive)


def trace(rays: Rays, optics, poses) -> Rays:
    for optic, pose in zip(optics, poses):
        rays = step(optic, pose, rays)
    return rays


def trace_survivors(rays: Rays, optics, poses):
    """(rays, index): the rays that survive the chain, dropped from the
    arrays as they die, and their indices in ``rays`` (a ray lost early
    takes no part in the later steps, nor in their gradients)."""
    index = torch.arange(rays.opl.shape[0], device=rays.opl.device)
    for optic, pose in zip(optics, poses):
        rays = step(optic, pose, rays)
        keep = torch.nonzero(rays.alive).reshape(-1)
        rays = Rays(tuple(c[keep] for c in rays.p), tuple(c[keep] for c in rays.d),
                    rays.opl[keep], rays.alive[keep])
        index = index[keep]
    return rays, index


# ---------------------------------------------------------------------------
# placement (the alignment laser of ART's OEPlacement)
# ---------------------------------------------------------------------------


def place(optics, distances, incidences_deg, planes_deg, *, dtype, device) -> list:
    """Poses of ``optics`` placed along the central ray from a source at the
    origin pointing along +x: each at its distance along the current
    central ray, its normal turned from the incidence angle about an axis
    that the incidence-plane angles turn, the central ray traced through
    the chain so far (masks made transparent) to aim the next."""
    centre = vec((0, 0, 0), dtype, device)
    central = vec((1, 0, 0), dtype, device)
    axis = vec((0, 1, 0), dtype, device)
    poses, laser = [], []
    for optic, dist, inc, plane in zip(optics, distances, incidences_deg, planes_deg):
        inc = math.radians(inc % 360)
        plane = math.radians(plane % 360)
        centre = centre + central * float(dist)
        if abs(plane - math.pi) < 1e-10:
            axis = -axis
        else:
            axis = rodrigues(central, -plane) @ axis
        normal = rodrigues(axis, -math.pi / 2 + inc) @ torch.linalg.cross(central, axis)
        pose = Pose(centre, normal, torch.linalg.cross(axis, normal))
        poses.append(pose)
        if optic.kind == "mask":
            laser.append((Optic("mask", ("round_hole", 100.0, 100.0, 0.0, 0.0)), pose))
            continue
        laser.append((optic, pose))
        one = lambda v: torch.full((1,), float(v), dtype=dtype, device=device)  # noqa: E731
        ray = Rays((one(0), one(0), one(0)), (one(1), one(0), one(0)), one(0),
                   torch.ones(1, dtype=torch.bool, device=device))
        ray = trace(ray, [o for o, _ in laser], [p for _, p in laser])
        if not bool(ray.alive[0]):
            raise RuntimeError(f"the alignment ray misses optic {len(poses) - 1}")
        central = torch.stack([c[0] for c in ray.d])
    return poses


# ---------------------------------------------------------------------------
# the cone source and its weights
# ---------------------------------------------------------------------------


def cone_axis_rotation(dtype, device):
    """The rotation taking the canonical +z beam onto the lab's +x."""
    return rotation_from_to(vec((0, 0, 1), dtype, device), vec((1, 0, 0), dtype, device))


def cone_rays(k0: int, n: int, n_total: int, divergence: float, *, dtype, device) -> Rays:
    """Rays ``k0 .. k0 + n - 1`` of the Vogel cone of ``n_total`` rays and
    half-angle ``divergence`` from the origin along +x (:func:`cone_rays_at`)."""
    k = torch.arange(k0, k0 + n, dtype=torch.int64, device=device)
    return cone_rays_at(k, n_total, divergence, dtype=dtype)


def cone_rays_at(k, n_total: int, divergence: float, *, dtype) -> Rays:
    """Rays of indices ``k`` (int64) of the Vogel cone of ``n_total`` rays:
    ray k at radius tan(divergence) sqrt(k / n_total) and azimuth 2 pi
    frac(k g), g the golden turn fraction."""
    device, n = k.device, k.shape[0]
    # a ray's index is its identity: its turn and radius fraction are worked
    # out in float64 at every dtype, the geometry from there in ``dtype``
    f64 = torch.float64
    hi, lo = torch.div(k, 65536, rounding_mode="floor"), torch.remainder(k, 65536)
    turns = torch.frac(hi.to(f64) * GOLDEN_HI + lo.to(f64) * GOLDEN).to(dtype)
    theta = 2.0 * math.pi * turns
    r = torch.sqrt((k.to(f64) / n_total).to(dtype)) * math.tan(divergence)
    cx, cy = r * torch.cos(theta), r * torch.sin(theta)
    inv = 1.0 / torch.sqrt(cx * cx + cy * cy + 1.0)
    d = _apply(cone_axis_rotation(dtype, device), (cx * inv, cy * inv, inv))
    zero = torch.zeros(n, dtype=dtype, device=device)
    return Rays((zero, zero.clone(), zero.clone()), d, zero.clone(),
                torch.ones(n, dtype=torch.bool, device=device))


def index_weights(k0: int, n: int, n_total: int, edge: float, *, dtype, device):
    """Gaussian weights of the radial law edge^(r^2 / r_max^2) = edge^(k / n)."""
    k = torch.arange(k0, k0 + n, dtype=torch.int64, device=device).to(torch.float64)
    return torch.exp((math.log(edge) * k / n_total).to(dtype))


def index_weight_total(n_total: int, edge: float) -> float:
    """Sum of :func:`index_weights` over the whole cone (a geometric sum)."""
    q = math.exp(math.log(edge) / n_total)
    return (1.0 - q ** n_total) / (1.0 - q)


def angle_weights(d, edge: float):
    """ART's ApplyGaussianIntensityToRayList on a diverging bundle: edge^(
    (tan a / a_max)^2), a the angle (Kahan's formula) of each ray to the
    bundle's mean direction and a_max the largest."""
    mean = torch.stack([c.mean() for c in d])
    mean = mean / torch.linalg.vector_norm(mean)
    a = (tuple(mean[i] - d[i] for i in range(3)), tuple(mean[i] + d[i] for i in range(3)))
    norm = [torch.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]) for v in a]
    angle = 2.0 * torch.atan2(norm[0], norm[1])
    return torch.exp((torch.tan(angle) / angle.max()) ** 2 * math.log(edge))


# ---------------------------------------------------------------------------
# the detector plane
# ---------------------------------------------------------------------------


class Plane(NamedTuple):
    """A detector plane: centre, normal (facing the rays), in-plane axes e1
    and e2 (rows of the rotation taking the normal onto +z), and the point
    distances are counted from."""

    centre: torch.Tensor
    normal: torch.Tensor
    e1: torch.Tensor
    e2: torch.Tensor
    refpoint: torch.Tensor

    def shifted(self, s) -> "Plane":
        """The plane moved ``s`` mm further from the refpoint."""
        return self._replace(centre=self.centre - s * self.normal)


def plane(centre, normal, refpoint) -> Plane:
    R = rotation_from_to(normal, vec((0, 0, 1), normal.dtype, normal.device))
    return Plane(centre, normal, R[0], R[1], refpoint)


def autoplace(rays: Rays, distance: float) -> Plane:
    """ART's Detector.autoplace: normal to the surviving rays' mean
    direction, ``distance`` from their mean point."""
    w = rays.alive.to(rays.p[0].dtype)
    cw = w.sum()
    cv = torch.stack([(c * w).sum() / cw for c in rays.d])
    cv = cv / torch.linalg.vector_norm(cv)
    cp = torch.stack([(c * w).sum() / cw for c in rays.p])
    return plane(cp + cv * distance, -cv, cp)


def on_plane(rays: Rays, pl: Plane):
    """(x, y, leg t) of the rays on the plane: in-plane coordinates from its
    centre and the distance travelled to it."""
    num = sum(pl.normal[i] * (pl.centre[i] - rays.p[i]) for i in range(3))
    den = sum(rays.d[i] * pl.normal[i] for i in range(3))
    t = num / den
    rel = tuple(rays.p[i] + t * rays.d[i] - pl.centre[i] for i in range(3))
    x = sum(rel[i] * pl.e1[i] for i in range(3))
    y = sum(rel[i] * pl.e2[i] for i in range(3))
    return x, y, t
