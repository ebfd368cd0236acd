"""Structure-of-arrays ray bundle of tensors (counterpart of the JAX
package's ``ops/bundle.py``).

A bundle of N rays is a NamedTuple of tensors with static shapes; rays that
miss an optic carry ``alive=False`` and are excluded from every statistic by
weighting. Scene construction builds bundles on the host (CPU tensors); the
trace moves them to its device and dtype with :meth:`RayBundle.to`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class RayBundle(NamedTuple):
    """SoA bundle of N rays.

    p : (N, 3) ray origin points [mm]
    d : (N, 3) unit direction vectors
    opl : (N,) accumulated optical path length [mm]
    opl_c : (N,) Kahan compensation term for ``opl``
    alive : (N,) bool — False once a ray missed an optic / was blocked
    intensity : (N,) fluence fraction carried by the ray
    incidence : (N,) incidence angle [rad] on the last optic hit
    wavelength : () wavelength [mm]
    """

    p: torch.Tensor
    d: torch.Tensor
    opl: torch.Tensor
    opl_c: torch.Tensor
    alive: torch.Tensor
    intensity: torch.Tensor
    incidence: torch.Tensor
    wavelength: torch.Tensor

    @property
    def n_rays(self) -> int:
        return self.p.shape[-2]

    def weights(self):
        """Statistics weights: intensity where alive, else 0."""
        return torch.where(self.alive, self.intensity, torch.zeros_like(self.intensity))

    def to(self, device=None, dtype=None) -> "RayBundle":
        """The bundle on ``device`` with its float leaves in ``dtype``
        (either may be None to keep it)."""
        def move(x):
            if x.is_floating_point():
                return x.to(device=device, dtype=dtype)
            return x.to(device=device)

        return RayBundle(*(move(x) for x in self))


def make_bundle(points, directions, wavelength=None, intensity=None, dtype=None,
                device="cpu"):
    """RayBundle from (N,3) points and direction vectors (directions are
    normalized). ``dtype`` defaults to the ``ART_TPU_DTYPE`` override, else
    float64: construction is host-side work, like the JAX package's NumPy
    bundles, and the trace casts to its own dtype."""
    if dtype is None:
        from .precision import env_dtype

        dtype = env_dtype() or torch.float64
    p = torch.as_tensor(np.asarray(points) if not torch.is_tensor(points) else points,
                        dtype=dtype, device=device)
    d = torch.as_tensor(np.asarray(directions) if not torch.is_tensor(directions) else directions,
                        dtype=dtype, device=device)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    n = p.shape[0]
    if intensity is None:
        intensity = torch.ones((n,), dtype=dtype, device=device)
    else:
        intensity = torch.as_tensor(intensity, dtype=dtype, device=device)
    wl = torch.as_tensor(0.0 if wavelength is None else wavelength, dtype=dtype, device=device)
    return RayBundle(
        p=p,
        d=d,
        opl=torch.zeros((n,), dtype=dtype, device=device),
        opl_c=torch.zeros((n,), dtype=dtype, device=device),
        alive=torch.ones((n,), dtype=torch.bool, device=device),
        intensity=intensity,
        incidence=torch.zeros((n,), dtype=dtype, device=device),
        wavelength=wl,
    )


def total_path(bundle: RayBundle):
    """Accurate accumulated optical path: ``opl - opl_c`` (``kahan_add``
    keeps the rounding excess already folded into the running sum in
    ``opl_c``)."""
    return bundle.opl - bundle.opl_c


def to_host(bundle: RayBundle) -> RayBundle:
    """The bundle as a RayBundle of NumPy arrays on the host."""
    return RayBundle(*(x.detach().cpu().numpy() for x in bundle))


def compact_host(bundle: RayBundle):
    """Drop dead rays on the host (dynamic shape) — for plotting/export.
    Returns (bundle of CPU tensors, original indices)."""
    b = bundle.to(device="cpu")
    idx = torch.nonzero(b.alive).reshape(-1)
    return RayBundle(
        p=b.p[idx],
        d=b.d[idx],
        opl=b.opl[idx],
        opl_c=b.opl_c[idx],
        alive=b.alive[idx],
        intensity=b.intensity[idx],
        incidence=b.incidence[idx],
        wavelength=b.wavelength,
    ), idx


def pad_bundle(bundle: RayBundle, n_total: int):
    """Pad a bundle with dead rays up to ``n_total``."""
    n = bundle.n_rays
    if n == n_total:
        return bundle
    extra = n_total - n
    if extra < 0:
        raise ValueError(f"cannot pad bundle of {n} rays down to {n_total}")

    def pad(x, fill):
        block = torch.full((extra,) + tuple(x.shape[1:]), fill, dtype=x.dtype, device=x.device)
        return torch.cat([x, block], dim=0)

    # dead padding rays point along +z so the math stays finite
    d_fill = torch.zeros((extra, 3), dtype=bundle.d.dtype, device=bundle.d.device)
    d_fill[:, 2] = 1.0
    return RayBundle(
        p=pad(bundle.p, 0.0),
        d=torch.cat([bundle.d, d_fill], dim=0),
        opl=pad(bundle.opl, 0.0),
        opl_c=pad(bundle.opl_c, 0.0),
        alive=pad(bundle.alive, False),
        intensity=pad(bundle.intensity, 0.0),
        incidence=pad(bundle.incidence, 0.0),
        wavelength=bundle.wavelength,
    )
