"""Light sources: build SoA ray bundles (ART/ModuleSource.py).

Same source types and signatures as the reference, but each returns one
:class:`~attosecondraytracing_tpu_torch.ops.bundle.RayBundle` of CPU tensors
instead of a Python list of Ray objects. Construction is host-side NumPy in
float64 (deterministic Vogel spirals); the trace moves the bundle to its
device and dtype.

Known reference quirks handled here (SURVEY.md §7 "implement the intended
behavior"):
* PlaneWaveDisk emits the full NbRays (the reference emits NbRays-1,
  ART/ModuleSource.py:162);
* PlaneWaveSquare works (the reference's array-vs-scalar comparison raises,
  ART/ModuleSource.py:202).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.bundle import RayBundle, make_bundle
from ..ops.host_geometry import rotation_from_to, vogel_spiral


def _finish(points, dirs, axis, origin, wavelength, dtype=None):
    """Rotate a +z-built source onto ``axis`` and translate to ``origin``."""
    R = rotation_from_to(np.array([0.0, 0.0, 1.0]), np.asarray(axis, dtype=float))
    points = points @ R.T + np.asarray(origin, dtype=float)
    dirs = dirs @ R.T
    return make_bundle(points, dirs, wavelength=wavelength, dtype=dtype)


def _cone_dirs(angle: float, n_rays: int) -> np.ndarray:
    """Direction vectors filling a cone of half-angle ``angle`` via a Vogel
    spiral (ART/ModuleSource.py:23-50)."""
    radius = np.tan(angle)
    xy = vogel_spiral(n_rays, radius)
    d = np.concatenate([xy, np.ones((n_rays, 1))], axis=-1)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def PointSource(S, Axis, Divergence: float, NbRays: int, Wavelength=None, dtype=None) -> RayBundle:
    """Point source at S with cone half-angle ``Divergence`` [rad]
    (ART/ModuleSource.py:54-81)."""
    dirs = _cone_dirs(Divergence, NbRays)
    points = np.zeros((NbRays, 3))
    return _finish(points, dirs, Axis, S, Wavelength, dtype)


def ExtendedSource(S, Axis, Diameter: float, Divergence: float, NbRays: int, Wavelength=None, dtype=None) -> RayBundle:
    """Array of point sources over a disk of ``Diameter``, each emitting a
    cone (ART/ModuleSource.py:85-131; same point-source count heuristics,
    shared with the in-kernel synthesizer via host_geometry)."""
    from ..ops.host_geometry import extended_source_counts

    n_sources, n_each = extended_source_counts(Diameter, NbRays)
    centres = vogel_spiral(n_sources, Diameter / 2.0)
    cone = _cone_dirs(Divergence, n_each)
    points = np.zeros((n_sources * n_each, 3))
    points[:, :2] = np.repeat(centres, n_each, axis=0)
    dirs = np.tile(cone, (n_sources, 1))
    return _finish(points, dirs, Axis, S, Wavelength, dtype)


def PlaneWaveDisk(Centre, Axis, Radius: float, NbRays: int, Wavelength=None, dtype=None) -> RayBundle:
    """Collimated round beam: parallel rays on a Vogel spiral
    (ART/ModuleSource.py:135-169)."""
    xy = vogel_spiral(NbRays, Radius)
    points = np.concatenate([xy, np.zeros((NbRays, 1))], axis=-1)
    dirs = np.tile(np.array([0.0, 0.0, 1.0]), (NbRays, 1))
    return _finish(points, dirs, Axis, Centre, Wavelength, dtype)


def PlaneWaveSquare(Centre, Axis, SideLength: float, NbRays: int, Wavelength=None, dtype=None) -> RayBundle:
    """Collimated square beam on a regular grid (ART/ModuleSource.py:173-207,
    with the broken scalar comparison fixed)."""
    n_side = max(int(np.sqrt(NbRays)), 1)
    xs = np.linspace(-SideLength / 2, SideLength / 2, n_side)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    points = np.stack([X.ravel(), Y.ravel(), np.zeros(n_side * n_side)], axis=-1)
    dirs = np.tile(np.array([0.0, 0.0, 1.0]), (points.shape[0], 1))
    return _finish(points, dirs, Axis, Centre, Wavelength, dtype)


def PlaneWaveSquareFused(Centre, Axis, SideLength: float, NbRays: int,
                         Wavelength=None, gaussian_edge: float | None = None,
                         dtype=None):
    """:func:`PlaneWaveSquare` plus the fused-source description that lets
    the fused engines synthesize the grid from the ray index
    (ops.fused_trace.synth_source kind='square'). Returns
    ``(bundle, FusedSourceInfo)`` — pass both to the OpticalChain ctor::

        bundle, spec = PlaneWaveSquareFused(S, Axis, 10.0, 1_000_000)
        chain = OpticalChain(bundle, elements, source_spec=spec, device="cuda")

    ``gaussian_edge`` applies
    :func:`ApplyGaussianIntensityToRayList` with that edge fraction and
    records it in the spec."""
    from .chain import FusedSourceInfo

    bundle = PlaneWaveSquare(Centre, Axis, SideLength, NbRays, Wavelength, dtype)
    if gaussian_edge is not None:
        bundle = ApplyGaussianIntensityToRayList(bundle, gaussian_edge)
    axis = np.asarray(Axis, dtype=float)
    axis = axis / np.linalg.norm(axis)
    spec = FusedSourceInfo(
        kind="square", origin=tuple(np.asarray(Centre, dtype=float)),
        axis=tuple(axis), param=float(SideLength),
        gaussian_edge=gaussian_edge, n_rays=bundle.n_rays,
        wavelength=float(Wavelength) if Wavelength is not None else 0.0,
    )
    return bundle, spec


def ApplyGaussianIntensityToRayList(bundle: RayBundle, IntensityFraction: float = 1 / np.e**2) -> RayBundle:
    """Gaussian intensity profile: 1 at the bundle centre, ``IntensityFraction``
    at the edge (ART/ModuleSource.py:219-261).

    For diverging bundles the profile is a function of ray angle; for plane
    waves a function of distance from the axis — same switch as the reference.
    """
    if IntensityFraction >= 1 or IntensityFraction <= 0:
        print(
            "When applying a Gaussian intensity profile to a ray list, the IntensityFraction "
            "should be between 0 and 1! I'm setting it to 1/e^2."
        )
        IntensityFraction = 1 / np.e**2

    p = bundle.p.detach().cpu().double().numpy()
    d = bundle.d.detach().cpu().double().numpy()
    axis = d.mean(axis=0)
    axis /= np.linalg.norm(axis)
    # batched Kahan angle formula (ART/ModuleGeometry.py:40-44)
    nu = np.linalg.norm(axis)
    nv = np.linalg.norm(d, axis=-1, keepdims=True)
    angles = 2.0 * np.arctan2(
        np.linalg.norm(axis * nv - d * nu, axis=-1),
        np.linalg.norm(axis * nv + d * nu, axis=-1),
    )
    divergence = float(np.max(angles))
    if divergence > 1e-12:
        arg = (np.tan(angles) / divergence) ** 2
    else:
        dist = np.linalg.norm(p, axis=-1)
        max_dist = max(float(np.max(dist)), 1e-300)
        arg = (dist / max_dist) ** 2
    intensity = np.exp(arg * np.log(IntensityFraction))
    return bundle._replace(intensity=torch.as_tensor(
        intensity, dtype=bundle.intensity.dtype, device=bundle.intensity.device))
