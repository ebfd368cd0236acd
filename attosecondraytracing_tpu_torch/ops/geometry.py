"""Batched geometry on tensors (counterpart of the JAX package's
``ops/geometry.py``).

Host-side float64 NumPy geometry for scene construction lives in
:mod:`.host_geometry`.
"""

from __future__ import annotations

import math

import torch


def normalize(v, dim=-1, eps=0.0):
    """Unit vector(s) along ``dim``."""
    n = torch.linalg.vector_norm(v, dim=dim, keepdim=True)
    if eps:
        n = torch.clamp(n, min=eps)
    return v / n


def angle_between(u, v, dim=-1):
    """Angle between vectors, W. Kahan's numerically stable formula."""
    nu = torch.linalg.vector_norm(u, dim=dim, keepdim=True)
    nv = torch.linalg.vector_norm(v, dim=dim, keepdim=True)
    a = torch.linalg.vector_norm(u * nv - v * nu, dim=dim)
    b = torch.linalg.vector_norm(u * nv + v * nu, dim=dim)
    return 2.0 * torch.atan2(a, b)


def rotation_around_axis(axis, angle, *, dtype=torch.float64, device="cpu"):
    """Rodrigues rotation matrix; ``R @ v`` rotates ``v`` by ``angle``
    around ``axis``."""
    k = normalize(torch.as_tensor(axis, dtype=dtype, device=device))
    kx, ky, kz = k[0], k[1], k[2]
    zero = torch.zeros((), dtype=dtype, device=device)
    K = torch.stack([
        torch.stack([zero, -kz, ky]),
        torch.stack([kz, zero, -kx]),
        torch.stack([-ky, kx, zero]),
    ])
    eye = torch.eye(3, dtype=dtype, device=device)
    angle = torch.as_tensor(angle, dtype=dtype, device=device)
    return eye + torch.sin(angle) * K + (1.0 - torch.cos(angle)) * (K @ K)


def frame_rotation(normal, majoraxis):
    """Lab->optic rotation: rows are (majoraxis, normal x majoraxis, normal)."""
    return torch.stack([majoraxis, torch.linalg.cross(normal, majoraxis), normal], dim=0)


def vogel_spiral(n_points: int, radius, *, dtype=torch.float64, device="cpu"):
    """(n_points, 2) Vogel golden-angle spiral filling a disk of ``radius``."""
    golden = math.pi * (3.0 - math.sqrt(5.0))
    k = torch.arange(n_points, dtype=dtype, device=device)
    r = torch.sqrt(k / n_points) * radius
    theta = golden * k
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)


def reflect(d, n):
    """Specular reflection d' = d - 2 (d.n) n."""
    dn = torch.sum(d * n, dim=-1, keepdim=True)
    return d - 2.0 * dn * n


def kahan_add(s, c, x):
    """One step of classic Kahan-compensated accumulation.

    ``c`` holds the rounding excess already absorbed into ``s``
    (``c = (t - s) - y``), so the refined readout is ``s - c``. Eager
    PyTorch runs each operation as its own rounded kernel, so nothing
    contracts the compensation away (the CUDA kernels use ``__fadd_rn`` for
    the same reason)."""
    y = x - c
    t = s + y
    c_new = (t - s) - y
    return t, c_new


def line_plane_intersection(p, d, plane_point, plane_normal):
    """Batched line/plane intersection; ``p``/``d`` are (..., 3). Returns
    (t, point)."""
    num = torch.sum(plane_normal * (plane_point - p), dim=-1)
    den = torch.sum(d * plane_normal, dim=-1)
    t = num / den
    return t, p + t[..., None] * d
