"""The work a request needs, and the least time the H100 could do it in.

Operations are float32 operations per ray of the device code, counted from
its source for the parts these chains use (an add, subtract or multiply 1,
a fused multiply-add 2, a divide, square root, reciprocal square root, exp
or arccos 1; comparisons and selects 0), charged where the rays die: the
source for every ray, an optic's step for the rays that reach it, the
epilogue for the rays that survive. Bytes are each output byte written
once. The counts are a frozen copy of the port's own work model of
``chip_smoke.py`` (``OPS``, ``_stage_ops``, ``_ops_where_rays_die``,
``_dual_defect_ops``), kept here so that a later change to the program
cannot change the yardstick; the counts of one kind of optic, defect or
source lie in its module (``benchmark/optics``, ``benchmark/defects``,
``benchmark/sources``). The rays alive at each stage come from the
reference optics (:mod:`benchmark.reference.optics`) on rays spread evenly
through the request's source, so the work is the same whatever implements
it.
"""

from __future__ import annotations

import torch

from .. import defects as defect_kinds
from .. import optics as optic_kinds

#: NVIDIA H100 SXM data sheet: float32 rate outside the tensor cores and
#: HBM3 rate, at the full 700 W power limit
PEAK_FP32_OPS_PER_S = 67e12
PEAK_HBM_BYTES_PER_S = 3.35e12

OPS = {
    "affine": 33,        # the composed map of a step or a folded mask
    "store": 34,         # the to-lab map of p and d, the incidence arccos
    "weight": 2,         # exp(ln edge * rr)
    "image": 78,         # an image ray's plane crossing, coordinates, delay, pixel
    "moments": 78,       # the 16 moment terms of an alive ray
    "stats": 58,         # the 7 stats terms at one distance of an alive ray
    "dual_trace_once": 23,
    "dual_trace_tangent": 658,
    "dual_stats_once": 1,
    "dual_stats_tangent": 106,
}
#: bytes a traced ray's outputs take: point and direction (24), the path
#: pair (8), the alive flag (1), the incidence (4)
RAY_OUTPUT_BYTES = 37


def _step_ops(optic) -> int:
    return optic_kinds.kind(optic.kind).step_ops(optic) + sum(
        defect_kinds.kind(d.kind).ops(d) for d in optic.defects)


def alive_by_stage(source, optics, poses, n_total, *, device, n_probe=1 << 18):
    """Rays of an ``n_total``-ray source (:class:`benchmark.sources.Source`)
    entering each optic and alive at the end, ``[entering 0, entering 1,
    ..., at the end]``, scaled from ``n_probe`` rays spread evenly through
    the source's indices."""
    from ..reference import optics as op

    n_probe = min(n_probe, n_total)
    k = torch.div(torch.arange(n_probe, dtype=torch.int64, device=device) * n_total, n_probe,
                  rounding_mode="floor")
    rays = source.rays_at(k, n_total, dtype=torch.float64)
    counts = [n_probe]
    for optic, pose in zip(optics, poses):
        rays = op.step(optic, pose, rays)
        counts.append(int(rays.alive.sum()))
    return [c * n_total / n_probe for c in counts]


def trace_ops(source, optics, alive, folded: bool) -> float:
    """Operations of a source synthesized in the kernel and walked through
    ``optics``, charged where the rays die. ``folded``: an optic that is
    not the last and whose kind can be folded (a mask) is a test on the rays
    entering the next step, as the forward kernels fold it; else a step of
    its own."""
    ops = source.ops_per_ray() * alive[0]
    for i, optic in enumerate(optics):
        fold = getattr(optic_kinds.kind(optic.kind), "folded_ops", None)
        if folded and fold is not None and i < len(optics) - 1:
            ops += fold(optic) * alive[i]
        else:
            ops += _step_ops(optic) * alive[i]
    return ops


def least_seconds(ops: float, n_bytes: float) -> float:
    """The larger of the operations at the float32 peak and the bytes at the
    HBM peak."""
    return max(ops / PEAK_FP32_OPS_PER_S, n_bytes / PEAK_HBM_BYTES_PER_S)


def design_seconds(source, optics, alive, n_rays) -> float:
    """A design: the trace of every ray with its outputs stored (K1's work),
    and one pass of source, trace, weight and moments for the detector's
    optimizer (K2's); the optimizer's float64 refinement on 20,000 host
    rays is left out."""
    trace = trace_ops(source, optics, alive, folded=True)
    ops = trace + OPS["store"] * n_rays + trace + (OPS["weight"] + OPS["moments"]) * alive[-1]
    return least_seconds(ops, RAY_OUTPUT_BYTES * n_rays)


def align_step_seconds(source, optics, alive, n_rays, n_tangents) -> float:
    """One gradient step: the primal trace (masks as steps), weight and
    stats where the rays die, and what the dual numbers add: once per ray
    and per tangent row for every ray, per tangent row for the stats of the
    surviving rays."""
    ops = (trace_ops(source, optics, alive, folded=False)
           + (OPS["weight"] + OPS["stats"]) * alive[-1])
    dual = OPS["dual_trace_once"] + n_tangents * OPS["dual_trace_tangent"]
    for optic in optics:
        for d in optic.defects:
            dual += defect_kinds.kind(d.kind).dual_ops(d, n_tangents)
    ops += dual * n_rays
    ops += (OPS["dual_stats_once"] + n_tangents * OPS["dual_stats_tangent"]) * alive[-1]
    return least_seconds(ops, 0.0)


def image_seconds(source, optics, alive, n_pixels) -> float:
    """One image: the source, trace, weight and binning of every ray where
    the rays die; the two float64 images written once."""
    ops = trace_ops(source, optics, alive, folded=True) + (OPS["weight"] + OPS["image"]) * alive[-1]
    return least_seconds(ops, 2 * 8 * n_pixels)


def tangent_rows(n_optics: int) -> int:
    """Pose parameters of a chain: 3 angles and 3 shifts per optic."""
    return 6 * n_optics

