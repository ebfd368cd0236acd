"""Host-side (NumPy, float64) geometry used for *scene construction*.

Scene building — auto-placement, misalignment, detector placement — involves a
handful of 3-vectors, so it stays on the host in float64 (exact parity with
the reference's quaternion math, ART/ModuleGeometry.py), while the ray trace
itself runs on device via :mod:`..ops.geometry`.
"""

from __future__ import annotations

import numpy as np


def normalize(v):
    v = np.asarray(v, dtype=float)
    return v / np.linalg.norm(v)


def perpendicular(v):
    """Some unit vector perpendicular to ``v`` (ART/ModuleGeometry.py:23-36)."""
    v = np.asarray(v, dtype=float)
    if abs(v[0]) < 1e-15:
        return np.array([1.0, 0.0, 0.0])
    if abs(v[1]) < 1e-15:
        return np.array([0.0, 1.0, 0.0])
    if abs(v[2]) < 1e-15:
        return np.array([0.0, 0.0, 1.0])
    return normalize(np.array([1.0, 1.0, -(v[0] + v[1]) / v[2]]))


def angle_between(u, v):
    """Kahan's stable angle formula (ART/ModuleGeometry.py:40-44)."""
    nu = np.linalg.norm(u)
    nv = np.linalg.norm(v)
    return 2.0 * np.arctan2(np.linalg.norm(u * nv - v * nu), np.linalg.norm(u * nv + v * nu))


def rotation_around_axis(axis, angle):
    """Rodrigues rotation matrix; ``R @ v`` rotates v by ``angle`` around
    ``axis`` (matrix form of ART/ModuleGeometry.py:321-329)."""
    k = normalize(axis)
    K = np.array([[0.0, -k[2], k[1]], [k[2], 0.0, -k[0]], [-k[1], k[0], 0.0]])
    return np.eye(3) + np.sin(angle) * K + (1.0 - np.cos(angle)) * (K @ K)


def rotate_vector(axis, angle, v):
    return rotation_around_axis(axis, angle) @ np.asarray(v, dtype=float)


def rotation_from_to(a, b):
    """Rotation matrix mapping direction ``a`` onto ``b``.

    Matrix equivalent of the reference's RotationPoint
    (ART/ModuleGeometry.py:333-343), including its antiparallel special case
    (which the reference implements as a point reflection, i.e. -I).
    """
    a = normalize(a)
    b = normalize(b)
    ang = angle_between(a, b)
    if abs(ang) < 1e-10:
        return np.eye(3)
    if abs(ang - np.pi) < 1e-10:
        return -np.eye(3)
    return rotation_around_axis(np.cross(a, b), ang)


def frame_rotation(normal, majoraxis):
    """Lab->optic rotation: rows are (majoraxis, normal x majoraxis, normal).

    ``R @ majoraxis = ex``, ``R @ normal = ez``; the matrix form of the two
    successive rotations in the reference trace loop
    (ART/ModuleProcessing.py:288-295).
    """
    n = normalize(normal)
    m = normalize(majoraxis)
    return np.stack([m, np.cross(n, m), n], axis=0)


def vogel_spiral(n_points: int, radius: float) -> np.ndarray:
    """(n,2) Vogel spiral (ART/ModuleGeometry.py:61-76)."""
    golden = np.pi * (3.0 - np.sqrt(5.0))
    k = np.arange(n_points, dtype=float)
    r = np.sqrt(k / n_points) * radius
    theta = golden * k
    return np.stack([r * np.cos(theta), r * np.sin(theta)], axis=-1)


def reflect(d, n):
    """Specular reflection d' = d - 2 (d.n) n."""
    d = np.asarray(d, dtype=float)
    n = np.asarray(n, dtype=float)
    return d - 2.0 * np.dot(d, n) * n


def extended_source_counts(diameter: float, n_rays: int):
    """(n_sources, n_each) for an extended source: the reference's
    sub-source count heuristics (ART/ModuleSource.py:85-131). Shared by
    models.sources.ExtendedSource and the in-kernel synthesizer
    (ops.pallas_trace.make_source_spec) so the two always agree; the total
    emitted ray count is n_sources * n_each (not the requested n_rays)."""
    min_sources, min_rays_each = 30, 300
    n_sources = max(min_sources, int(250 * diameter))
    n_sources = min(n_sources, int(n_rays / min_rays_each))
    n_sources = max(n_sources, 1)
    n_each = max(min_rays_each, int(n_rays / n_sources))
    return n_sources, n_each
