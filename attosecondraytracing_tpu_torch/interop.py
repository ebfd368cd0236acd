"""Carry the JAX package's objects across to this package.

Each function takes a JAX-package object whose leaves are NumPy arrays or
python scalars (e.g. ``jax.tree.map(np.asarray, chain.device_elements())``)
and returns this package's counterpart on a given device and dtype. Objects
are recognized by class name and field names, so this module never imports
JAX; the tests use it to feed one chain to both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.chain import FusedSourceInfo
from .ops import supports as sup
from .ops import surfaces as srf
from .ops.bundle import RayBundle
from .ops.defects import GridDefect, ZernikeDefect
from .ops.fused_trace import BakedSource
from .ops.trace import MaskElement, MirrorElement, bake

_SURFACES = {cls.__name__: cls for cls in (
    srf.Plane, srf.Sphere, srf.Parabola, srf.Toroid, srf.Ellipsoid, srf.Cylinder)}
_SUPPORTS = {cls.__name__: cls for cls in (
    sup.SupportRound, sup.SupportRoundHole, sup.SupportRectangle,
    sup.SupportRectangleHole, sup.SupportRectangleRectHole)}


def _record(obj, table):
    """This package's NamedTuple of python floats for a JAX-package record
    of the same class name and fields."""
    name = type(obj).__name__
    if name not in table:
        raise TypeError(f"no counterpart for {name}")
    cls = table[name]
    return cls(**{f: float(np.asarray(getattr(obj, f))) for f in cls._fields})


def _tensor(x, device, dtype):
    return torch.as_tensor(np.array(x, dtype=np.float64), dtype=dtype, device=device)


def _defect(d, device, dtype):
    """This package's defect record for a JAX-package ``ZernikeDefect``
    (coefficients as floats) or ``GridDefect`` (maps as tensors on
    ``device`` in ``dtype``)."""
    name = type(d).__name__
    if name == "ZernikeDefect":
        items = d.coeffs.items() if isinstance(d.coeffs, dict) else d.coeffs
        return ZernikeDefect(coeffs={(int(n), int(m)): float(np.asarray(c)) for (n, m), c in items},
                             radius=float(np.asarray(d.radius)))
    if name == "GridDefect":
        return GridDefect(height=_tensor(d.height, device, dtype),
                          slope_x=_tensor(d.slope_x, device, dtype),
                          slope_y=_tensor(d.slope_y, device, dtype),
                          **{f: float(np.asarray(getattr(d, f))) for f in ("x0", "y0", "dx", "dy")})
    raise TypeError(f"no counterpart for defect {name}")


def elements_from_numpy(elements, *, device, dtype):
    """Element records (``MirrorElement`` / ``MaskElement``) on ``device``
    with poses in ``dtype``, a mirror's defects carried across
    (:func:`_defect`)."""
    out = []
    for el in elements:
        name = type(el).__name__
        if name == "MaskElement":
            out.append(MaskElement(rot=_tensor(el.rot, device, dtype),
                                   position=_tensor(el.position, device, dtype),
                                   support=_record(el.support, _SUPPORTS)))
        elif name == "MirrorElement":
            out.append(MirrorElement(rot=_tensor(el.rot, device, dtype),
                                     position=_tensor(el.position, device, dtype),
                                     centre=_tensor(el.centre, device, dtype),
                                     surface=_record(el.surface, _SURFACES),
                                     support=_record(el.support, _SUPPORTS),
                                     defects=tuple(_defect(d, device, dtype) for d in el.defects)))
        else:
            raise TypeError(f"no counterpart for element {name}")
    return out


def bundle_from_numpy(bundle, *, device, dtype):
    """RayBundle on ``device`` with float leaves in ``dtype``."""
    fields = {f: np.asarray(getattr(bundle, f)) for f in RayBundle._fields}
    return RayBundle(**{
        f: (torch.as_tensor(np.array(v), device=device) if f == "alive"
            else _tensor(v, device, dtype))
        for f, v in fields.items()
    })


def alignment_params_from_numpy(params, *, device, dtype=torch.float32):
    """``AlignmentParams`` (angles, shifts: (K, 3)) on ``device`` in
    ``dtype``."""
    from .analysis.alignment import AlignmentParams

    return AlignmentParams(angles=_tensor(params.angles, device, dtype),
                           shifts=_tensor(params.shifts, device, dtype))


def source_spec_from_numpy(spec):
    """``FusedSourceInfo`` or ``BakedSource`` of this package."""
    name = type(spec).__name__
    if name == "FusedSourceInfo":
        return FusedSourceInfo(
            kind=str(spec.kind), origin=bake(spec.origin), axis=bake(spec.axis),
            param=float(spec.param),
            gaussian_edge=None if spec.gaussian_edge is None else float(spec.gaussian_edge),
            n_rays=int(spec.n_rays), wavelength=float(spec.wavelength),
            diameter=float(spec.diameter))
    if name == "BakedSource":
        return BakedSource(
            kind=str(spec.kind), rot=bake(spec.rot), origin=bake(spec.origin),
            radius=float(spec.radius), pos_radius=float(spec.pos_radius),
            n_each=int(spec.n_each), n_sources=int(spec.n_sources))
    raise TypeError(f"no counterpart for source spec {name}")
