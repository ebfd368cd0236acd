"""Plain ray optics of the benchmark's chains, in PyTorch at any dtype.

The yardstick's own physics, written from the semantics of upstream ART
(github.com/mightymightys/AttosecondRaytracing: ModuleProcessing's
placement, ModuleMirror's deformed mirror, ModuleMask) and frozen here. What
is specific to one kind of optic, defect or source lies in its module,
``benchmark/optics/<kind>.py``, ``benchmark/defects/<kind>.py`` or
``benchmark/sources/<kind>.py``, which the functions here find by name. It
imports nothing of the program under test, and takes none of its numbers:
every pose, ray, weight and plane is worked out again from the configuration
file and the request.

Every function takes the dtype and device to compute in: float64 for the
reference, a lower precision for the control that stands in the program's
place (``benchmark/control.py``). Rays are kept in component form, one
tensor per coordinate.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

LIGHT_SPEED_MM_S = 299792458000.0
FS_PER_MM = 1e15 / LIGHT_SPEED_MM_S
#: a hit must lie this far [mm] ahead of the ray
T_MIN = 1e-9


class Defect(NamedTuple):
    """A height error of a mirror: its kind (``benchmark/defects/<kind>.py``)
    and that module's numbers."""

    kind: str
    params: dict


class Optic(NamedTuple):
    """One optic of a chain in its own frame, whose origin is the vertex,
    the support centred there: its kind (``benchmark/optics/<kind>.py``),
    its support, that module's numbers of its surface, and its defects."""

    kind: str
    support: tuple
    shape: dict | None = None
    defects: tuple = ()


class Pose(NamedTuple):
    """Lab-frame pose: position, unit normal, unit major axis, (3,) each."""

    position: torch.Tensor
    normal: torch.Tensor
    major: torch.Tensor


def _support(spec: dict) -> tuple:
    if spec["kind"] == "round_hole":
        return ("round_hole", float(spec["Radius"]), float(spec["RadiusHole"]),
                float(spec["CenterHoleX"]), float(spec["CenterHoleY"]))
    if spec["kind"] == "rectangle":
        return ("rectangle", float(spec["dimX"]), float(spec["dimY"]))
    raise ValueError(f"support kind {spec['kind']!r} is not in the reference")


def optics_from_config(cfg: dict) -> list:
    """The optics of a configuration file's ``optics`` list, each built by
    its kind's module, with the defects its entry lists."""
    from .. import defects, optics

    out = []
    for spec in cfg["optics"]:
        support = _support(spec["support"])
        optic = optics.kind(spec["kind"]).reference(spec, support)
        found = tuple(defects.kind(d["kind"]).reference(d, support)
                      for d in defects.specs(spec))
        out.append(optic._replace(defects=found) if found else optic)
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


def apply(R, v):
    return tuple(R[i, 0] * v[0] + R[i, 1] * v[1] + R[i, 2] * v[2] for i in range(3))


def apply_t(R, v):
    return tuple(R[0, i] * v[0] + R[1, i] * v[1] + R[2, i] * v[2] for i in range(3))


def surface_hit(optic: Optic, q, u):
    """(t, valid, point, normal) of the rays (vertex frame) on the optic: the
    bare surface's hit by its kind's module, then the defects' summed height
    shifted along the ray, the normal the bare surface's at the moved point
    (the port's ``ignore_defects`` True); ``normal`` None where the rays
    pass through."""
    from .. import defects, optics

    surface = optics.kind(optic.kind)
    t, valid, point, normal = surface.hit(optic, q, u)
    if optic.defects:
        h = None
        for defect in optic.defects:
            dh = defects.kind(defect.kind).height(defect, point[0], point[1])
            h = dh if h is None else h + dh
        cos_alpha = torch.clamp(-(u[0] * normal[0] + u[1] * normal[1] + u[2] * normal[2]),
                                min=1e-6)
        t = t - h / cos_alpha
        point = tuple(q[i] + t * u[i] for i in range(3))
        normal = surface.normal(optic, point)
    return t, valid, point, normal


def step(optic: Optic, pose: Pose, rays: Rays) -> Rays:
    """The rays after one optic; rays it loses keep their state, dead."""
    R = frame(pose)
    rel = tuple(rays.p[i] - pose.position[i] for i in range(3))
    q = apply(R, rel)
    u = apply(R, rays.d)
    t, ok, point, n = surface_hit(optic, q, u)
    p_out = tuple(v + pose.position[i] for i, v in enumerate(apply_t(R, point)))
    if n is None:
        d_out = rays.d
    else:
        dn = u[0] * n[0] + u[1] * n[1] + u[2] * n[2]
        d_out = apply_t(R, tuple(u[i] - 2.0 * dn * n[i] for i in range(3)))
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
