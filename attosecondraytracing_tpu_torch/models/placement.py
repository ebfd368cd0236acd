"""Automatic placement and alignment of optical elements ("OEPlacement") —
scene construction (ART/ModuleProcessing.py:32-246).

Works like an alignment laser: the source sits at the origin pointing +x; each
element is placed at its distance along the current central ray, oriented from
its incidence angle and incidence-plane rotation, and a single central ray is
traced through the partial chain (host-side, float64) to aim the next element.
Masks are replaced by a fully transparent stand-in for the alignment ray, and
convex mirrors are flipped by 180 degrees — both as in the reference.

Exactly one entry of the Distance/Incidence/IncidencePlane lists may itself be
a list/array, producing a scan list of OpticalChains.
"""

from __future__ import annotations

import copy

import numpy as np

from ..ops import host_geometry as hg
from ..ops.host_trace import HostRay, trace_ray
from . import sources as msource
from .chain import OpticalChain
from .elements import OpticalElement
from .masks import Mask
from .supports import SupportRoundHole


def _source_spec(SourceProperties: dict, optics_list):
    """The source's FusedSourceInfo per the reference's rules
    (ART/ModuleProcessing.py:55-79): plane wave / point / extended source +
    Gaussian intensity to 1/e^2. The chain builds the bundle on its first
    read (``OpticalChain.source_rays``); the fused engine synthesizes the
    rays from the ray index (ops/fused_trace.synth_source)."""
    from .chain import FusedSourceInfo

    divergence = SourceProperties["Divergence"]
    source_size = SourceProperties["SourceSize"]
    n_rays = SourceProperties["NumberRays"]
    common = dict(origin=(0.0, 0.0, 0.0), axis=(1.0, 0.0, 0.0), gaussian_edge=1 / np.e**2,
                  wavelength=float(SourceProperties["Wavelength"]))
    if divergence == 0:
        if source_size == 0:
            support = optics_list[0].support
            try:
                radius = 0.5 * min(support.dimX, support.dimY)
            except AttributeError:
                radius = support.radius
        else:
            radius = source_size / 2
        return FusedSourceInfo(kind="disk", param=float(radius), n_rays=int(n_rays), **common)
    if source_size == 0:
        return FusedSourceInfo(kind="cone", param=float(divergence), n_rays=int(n_rays), **common)
    return FusedSourceInfo(kind="extended", param=float(divergence),
                           n_rays=msource.emitted_rays("extended", int(n_rays), source_size),
                           diameter=float(source_size), **common)


def _single_placement(
    SourceProperties: dict,
    OpticsList: list,
    DistanceList: list,
    IncidenceAngleList: list,
    IncidencePlaneAngleList: list,
    Description: str,
) -> OpticalChain:
    incidence = [np.deg2rad(i % 360) for i in IncidenceAngleList]
    inc_plane = [np.deg2rad(i % 360) for i in IncidencePlaneAngleList]

    source_spec = _source_spec(SourceProperties, OpticsList)

    centre = np.zeros(3)
    central_vec = np.array([1.0, 0.0, 0.0])
    rotation_axis = np.array([0.0, 1.0, 0.0])  # perpendicular to the incidence plane

    elements: list[OpticalElement] = []
    align_elements: list[OpticalElement] = []  # masks replaced by transparent fakes

    for k, optic in enumerate(OpticsList):
        inc_k = incidence[k]
        # convex mirrors are flipped to reflect off the back side
        # (ART/ModuleProcessing.py:93-95)
        if optic.type in ("SphericalCX Mirror", "CylindricalCX Mirror"):
            inc_k = np.pi - inc_k

        centre = central_vec * DistanceList[k] + centre

        if abs(inc_plane[k] - np.pi) < 1e-10:
            rotation_axis = -rotation_axis
        else:
            rotation_axis = hg.rotate_vector(central_vec, -inc_plane[k], rotation_axis)

        normal = hg.rotate_vector(
            rotation_axis, -np.pi / 2 + inc_k, np.cross(central_vec, rotation_axis)
        )
        majoraxis = np.cross(rotation_axis, normal)

        element = OpticalElement(optic, centre, normal, majoraxis)
        elements.append(element)

        if isinstance(optic, Mask):
            # alignment ray must always pass: use a fully transparent mask
            # (ART/ModuleProcessing.py:119-126); central_vec unchanged
            fake = Mask(SupportRoundHole(Radius=100, RadiusHole=100, CenterHoleX=0, CenterHoleY=0))
            align_elements.append(OpticalElement(fake, centre, normal, majoraxis))
        else:
            align_elements.append(element)
            out = trace_ray(HostRay(np.zeros(3), np.array([1.0, 0.0, 0.0])), align_elements)
            if out[-1] is None:
                raise RuntimeError(
                    f"Auto-placement alignment ray missed optical element #{k} ({optic.type})."
                )
            central_vec = out[-1].vector

    return OpticalChain(None, elements, Description, source_spec=source_spec)


def _which_indices(lst):
    return [i for i, x in enumerate(lst) if isinstance(x, (list, np.ndarray))]


def OEPlacement(
    SourceProperties: dict,
    OpticsList: list,
    DistanceList: list,
    IncidenceAngleList: list,
    IncidencePlaneAngleList: list | None = None,
    Description: str = "",
):
    """Place optics along the beam path; returns an OpticalChain, or a list of
    them if one entry of one input list is itself a list/array
    (ART/ModuleProcessing.py:133-246)."""
    if IncidencePlaneAngleList is None:
        IncidencePlaneAngleList = np.zeros(len(OpticsList)).tolist()

    nested_inc = _which_indices(IncidenceAngleList)
    nested_dist = _which_indices(DistanceList)
    nested_plane = _which_indices(IncidencePlaneAngleList)
    total_nested = len(nested_inc) + len(nested_dist) + len(nested_plane)

    if total_nested > 1:
        raise ValueError(
            "Only one element of one of the lists IncidenceAngleList, IncidencePlaneAngleList, "
            "or DistanceList can be a list or array itself. Otherwise things get too tangled..."
        )

    if total_nested == 0:
        return _single_placement(
            SourceProperties, OpticsList, DistanceList, IncidenceAngleList, IncidencePlaneAngleList, Description
        )

    i = (nested_inc + nested_plane + nested_dist)[0]
    loop_variable_name = OpticsList[i].type + "_idx_" + str(i)
    if nested_inc:
        loop_variable_name += " incidence angle (deg)"
        loop_values = copy.deepcopy(IncidenceAngleList[i])
        loop_list = IncidenceAngleList
    elif nested_dist:
        loop_variable_name += " distance (mm)"
        loop_values = copy.deepcopy(DistanceList[i])
        loop_list = DistanceList
    else:
        loop_variable_name += " incidence-plane angle rotation (deg)"
        loop_values = copy.deepcopy(IncidencePlaneAngleList[i])
        loop_list = IncidencePlaneAngleList

    chains = []
    for x in loop_values:
        loop_list[i] = x
        chain = _single_placement(
            SourceProperties, OpticsList, DistanceList, IncidenceAngleList, IncidencePlaneAngleList, Description
        )
        chain.loop_variable_name = loop_variable_name
        chain.loop_variable_value = float(x)
        chains.append(chain)
    return chains
