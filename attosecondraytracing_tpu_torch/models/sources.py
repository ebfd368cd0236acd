"""Light sources: build SoA ray bundles (ART/ModuleSource.py).

Same source types and signatures as the reference, plus a ``device``: each
returns one :class:`~attosecondraytracing_tpu_torch.ops.bundle.RayBundle`
instead of a Python list of Ray objects. Construction is float64 PyTorch
(deterministic Vogel spirals) on ``device``, the CPU by default; the trace
moves the bundle to its device and dtype.

:func:`factory_bundle` builds the bundle a factory source description
(``models.chain.FusedSourceInfo``) stands for, and :func:`factory_intensity`
only its intensity, so that a chain whose bundle nobody reads never builds
it on the host (``models.chain.OpticalChain.source_rays``).

Known reference quirks handled here (SURVEY.md §7 "implement the intended
behavior"):
* PlaneWaveDisk emits the full NbRays (the reference emits NbRays-1,
  ART/ModuleSource.py:162);
* PlaneWaveSquare works (the reference's array-vs-scalar comparison raises,
  ART/ModuleSource.py:202).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.bundle import RayBundle
from ..ops.host_geometry import extended_source_counts, rotation_from_to
from ..ops.precision import env_dtype

F64 = torch.float64
#: the Vogel spiral's angle step (ART/ModuleGeometry.py:61-76)
GOLDEN_ANGLE = math.pi * (3.0 - math.sqrt(5.0))
#: rays per pass of the Gaussian profile's angle formula (bounds its
#: temporaries on a 1e7-ray source)
CHUNK = 1 << 20


def _vogel_spiral(n_points: int, radius: float, device):
    """(x, y) of an ``n_points`` Vogel spiral of ``radius``, float64: point
    k at ``sqrt(k / n) radius e^(i k golden)``. The root and the phase go
    through complex128, which takes the C library's correctly rounded sqrt,
    cos and sin on the CPU (PyTorch's vectorized float64 ones are a unit in
    the last place off at times), so there the spiral is NumPy's bit for
    bit."""
    k = torch.arange(n_points, dtype=F64, device=device)
    r = torch.sqrt((k / n_points).to(torch.complex128)).real * radius
    xy = torch.polar(r, GOLDEN_ANGLE * k)
    return xy.real, xy.imag


def _cone_dirs(angle: float, n_rays: int, device) -> torch.Tensor:
    """(n, 3) unit directions filling a cone of half-angle ``angle`` about
    +z via a Vogel spiral (ART/ModuleSource.py:23-50)."""
    x, y = _vogel_spiral(n_rays, math.tan(angle), device)
    norm = torch.sqrt(x * x + y * y + 1.0)
    return torch.stack([x / norm, y / norm, 1.0 / norm], dim=-1)


def _plane(x, y) -> torch.Tensor:
    return torch.stack([x, y, torch.zeros_like(x)], dim=-1)


def _along_z(n: int, device) -> torch.Tensor:
    return torch.tensor([0.0, 0.0, 1.0], dtype=F64, device=device).expand(n, 3)


def _linspace(start: float, stop: float, num: int, device) -> torch.Tensor:
    """``np.linspace(start, stop, num)``'s values: ``start + k * step``,
    the last point ``stop`` itself."""
    if num == 1:
        return torch.full((1,), start, dtype=F64, device=device)
    xs = torch.arange(num, dtype=F64, device=device) * ((stop - start) / (num - 1)) + start
    xs[-1] = stop
    return xs


def _canonical(kind: str, param: float, n_rays: int, diameter: float, device):
    """(points, directions) of a factory source along +z at the origin,
    (N, 3) float64: 'cone' a point source of half-divergence ``param``,
    'extended' a Vogel disk of ``diameter`` of such cones, 'disk' a plane
    wave of radius ``param``, 'square' one on a side-``param`` grid."""
    if kind == "cone":
        dirs = _cone_dirs(param, n_rays, device)
        return torch.zeros_like(dirs), dirs
    if kind == "extended":
        n_sources, n_each = extended_source_counts(diameter, n_rays)
        cx, cy = _vogel_spiral(n_sources, diameter / 2.0, device)
        points = _plane(cx.repeat_interleave(n_each), cy.repeat_interleave(n_each))
        return points, _cone_dirs(param, n_each, device).repeat(n_sources, 1)
    if kind == "disk":
        points = _plane(*_vogel_spiral(n_rays, param, device))
        return points, _along_z(n_rays, device)
    if kind == "square":
        n_side = max(int(math.sqrt(n_rays)), 1)
        xs = _linspace(-param / 2, param / 2, n_side, device)
        points = _plane(xs.repeat_interleave(n_side), xs.repeat(n_side))
        return points, _along_z(n_side * n_side, device)
    raise ValueError(f"no factory source of kind {kind!r}")


def _rays(kind, origin, axis, param, n_rays, diameter, dtype, device):
    """(points, unit directions) in ``dtype`` on ``device`` of a factory
    source rotated from +z onto ``axis`` and moved to ``origin``; the
    directions are normalized in ``dtype``."""
    points, dirs = _canonical(kind, float(param), int(n_rays), float(diameter), device)
    R = torch.as_tensor(rotation_from_to(np.array([0.0, 0.0, 1.0]), np.asarray(axis, dtype=float)),
                        dtype=F64, device=device)
    o = torch.as_tensor(np.asarray(origin, dtype=float), dtype=F64, device=device)
    p = (points @ R.T).add_(o).to(dtype)
    del points
    d = (dirs @ R.T).to(dtype)
    del dirs
    return p, d.div_(torch.linalg.vector_norm(d, dim=-1, keepdim=True))


def _bundle(p, d, wavelength, intensity=None) -> RayBundle:
    """A fresh bundle of points ``p`` and unit directions ``d``, its other
    leaves made on their device."""
    n, dtype, device = p.shape[0], p.dtype, p.device
    return RayBundle(
        p=p, d=d,
        opl=torch.zeros((n,), dtype=dtype, device=device),
        opl_c=torch.zeros((n,), dtype=dtype, device=device),
        alive=torch.ones((n,), dtype=torch.bool, device=device),
        intensity=torch.ones((n,), dtype=dtype, device=device) if intensity is None else intensity,
        incidence=torch.zeros((n,), dtype=dtype, device=device),
        wavelength=torch.as_tensor(0.0 if wavelength is None else wavelength, dtype=dtype,
                                   device=device),
    )


def _factory(kind, origin, axis, param, n_rays, wavelength, dtype, device, diameter=0.0):
    dtype = dtype or env_dtype() or F64
    return _bundle(*_rays(kind, origin, axis, param, n_rays, diameter, dtype,
                          torch.device(device)), wavelength)


def PointSource(S, Axis, Divergence: float, NbRays: int, Wavelength=None, dtype=None,
                device="cpu") -> RayBundle:
    """Point source at S with cone half-angle ``Divergence`` [rad]
    (ART/ModuleSource.py:54-81)."""
    return _factory("cone", S, Axis, Divergence, NbRays, Wavelength, dtype, device)


def ExtendedSource(S, Axis, Diameter: float, Divergence: float, NbRays: int, Wavelength=None,
                   dtype=None, device="cpu") -> RayBundle:
    """Array of point sources over a disk of ``Diameter``, each emitting a
    cone (ART/ModuleSource.py:85-131; same point-source count heuristics,
    shared with the in-kernel synthesizer via host_geometry)."""
    return _factory("extended", S, Axis, Divergence, NbRays, Wavelength, dtype, device,
                    diameter=Diameter)


def PlaneWaveDisk(Centre, Axis, Radius: float, NbRays: int, Wavelength=None, dtype=None,
                  device="cpu") -> RayBundle:
    """Collimated round beam: parallel rays on a Vogel spiral
    (ART/ModuleSource.py:135-169)."""
    return _factory("disk", Centre, Axis, Radius, NbRays, Wavelength, dtype, device)


def PlaneWaveSquare(Centre, Axis, SideLength: float, NbRays: int, Wavelength=None, dtype=None,
                    device="cpu") -> RayBundle:
    """Collimated square beam on a regular grid (ART/ModuleSource.py:173-207,
    with the broken scalar comparison fixed)."""
    return _factory("square", Centre, Axis, SideLength, NbRays, Wavelength, dtype, device)


def emitted_rays(kind: str, n_rays: int, diameter: float = 0.0) -> int:
    """Rays a factory source asked for ``n_rays`` emits: ``n_sources *
    n_each`` for 'extended', the largest square at most ``n_rays`` for
    'square', ``n_rays`` otherwise. Asked for that count again, each
    emits it again."""
    if kind == "extended":
        n_sources, n_each = extended_source_counts(diameter, n_rays)
        return n_sources * n_each
    if kind == "square":
        return max(int(math.sqrt(n_rays)), 1) ** 2
    return int(n_rays)


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


def _gaussian(p, d, fraction: float) -> torch.Tensor:
    """Float64 intensity of the Gaussian profile of float64 points ``p``
    and directions ``d`` (ART/ModuleSource.py:219-261): a function of each
    ray's angle to the mean direction for a diverging bundle, else of its
    point's distance from the origin."""
    axis = d.mean(dim=0)
    axis = axis / torch.linalg.vector_norm(axis)
    nu = torch.linalg.vector_norm(axis)
    angles = torch.empty(d.shape[0], dtype=F64, device=d.device)
    for s in range(0, d.shape[0], CHUNK):
        # batched Kahan angle formula (ART/ModuleGeometry.py:40-44)
        dc = d[s:s + CHUNK]
        u = axis * torch.linalg.vector_norm(dc, dim=-1, keepdim=True)
        v = dc * nu
        angles[s:s + CHUNK] = 2.0 * torch.atan2(torch.linalg.vector_norm(u - v, dim=-1),
                                                torch.linalg.vector_norm(u + v, dim=-1))
    divergence = float(angles.max())
    if divergence > 1e-12:
        arg = (torch.tan(angles) / divergence) ** 2
    else:
        dist = torch.linalg.vector_norm(p, dim=-1)
        arg = (dist / max(float(dist.max()), 1e-300)) ** 2
    return torch.exp(arg * math.log(fraction))


def _edge_fraction(IntensityFraction: float) -> float:
    if IntensityFraction >= 1 or IntensityFraction <= 0:
        print(
            "When applying a Gaussian intensity profile to a ray list, the IntensityFraction "
            "should be between 0 and 1! I'm setting it to 1/e^2."
        )
        return 1 / np.e**2
    return IntensityFraction


def ApplyGaussianIntensityToRayList(bundle: RayBundle, IntensityFraction: float = 1 / np.e**2) -> RayBundle:
    """Gaussian intensity profile: 1 at the bundle centre, ``IntensityFraction``
    at the edge (ART/ModuleSource.py:219-261), computed in float64 on the
    bundle's device.

    For diverging bundles the profile is a function of ray angle; for plane
    waves a function of distance from the axis — same switch as the reference.
    """
    fraction = _edge_fraction(IntensityFraction)
    intensity = _gaussian(bundle.p.detach().double(), bundle.d.detach().double(), fraction)
    return bundle._replace(intensity=intensity.to(bundle.intensity.dtype))


def _spec_rays(spec, dtype, device):
    return _rays(spec.kind, spec.origin, spec.axis, spec.param, spec.n_rays, spec.diameter,
                 dtype, torch.device(device))


def _spec_profile(spec, p, d, dtype) -> torch.Tensor:
    """The Gaussian profile ``spec`` names over the rays (p, d), in ``dtype``."""
    return _gaussian(p.double(), d.double(), _edge_fraction(spec.gaussian_edge)).to(dtype)


def factory_bundle(spec, *, device="cpu") -> RayBundle:
    """The bundle of the factory source ``spec`` (a
    ``models.chain.FusedSourceInfo``) describes, with its Gaussian profile:
    the bundle its factory and :func:`ApplyGaussianIntensityToRayList`
    give. Built on ``device`` and returned as CPU tensors; counted in
    ``factory_bundle.builds``."""
    factory_bundle.builds += 1
    dtype = env_dtype() or F64
    p, d = _spec_rays(spec, dtype, device)
    intensity = None if spec.gaussian_edge is None else _spec_profile(spec, p, d, dtype).cpu()
    return _bundle(p.cpu(), d.cpu(), spec.wavelength, intensity)


def factory_intensity(spec, *, device) -> torch.Tensor:
    """The intensity of :func:`factory_bundle`'s bundle, computed on
    ``device`` without building the bundle; counted in
    ``factory_intensity.syntheses``."""
    factory_intensity.syntheses += 1
    dtype = env_dtype() or F64
    if spec.gaussian_edge is None:
        return torch.ones((spec.n_rays,), dtype=dtype, device=device)
    return _spec_profile(spec, *_spec_rays(spec, dtype, device), dtype)


#: factory bundles built by :func:`factory_bundle`
factory_bundle.builds = 0
#: intensities synthesized by :func:`factory_intensity`
factory_intensity.syntheses = 0
