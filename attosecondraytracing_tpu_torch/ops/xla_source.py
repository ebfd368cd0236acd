"""The fused-source engine under the JAX package's ``ops/xla_source.py``
names (its XLA engine for chains the Pallas kernels did not take: grid
defect maps).

Here the kernels take every chain, grid maps included, so these are the
fused source engine: :func:`xla_trace_source` is kernel K1
(``fused_trace.fused_source_trace``) and :func:`xla_source_moments` kernel
K2's moments (``fused_trace.fused_source_moments``) on a CUDA device, their
plain versions on the CPU. The signatures are the JAX package's
(``ops/xla_source.py:111,164,214``), with ``device`` added: by default the
elements' own device, so a script written for the JAX package runs where
its elements live. A grid map is uploaded and packed once per device
(``fused_trace.grid_rows``), as the JAX engine uploads its inputs once.
"""

from __future__ import annotations

import numpy as np
import torch

from . import fused_trace as ft
from .bundle import RayBundle
from .precision import default_dtype

#: moment passes chunk the ray range at this size (the JAX engine's law)
CHUNK = ft.CHUNK


def _elements_device(elements) -> torch.device:
    el = elements[0]
    return el.rot.device if torch.is_tensor(el.rot) else torch.device("cpu")


def xla_trace_source(spec: ft.BakedSource, elements, n_rays: int, wavelength=50e-6, phase=0.0,
                     k_frac=0.0, n_total: int | None = None, ignore_defects: bool = True, *,
                     device=None) -> RayBundle:
    """Trace ``n_rays`` rays of the in-kernel Vogel source through the
    chain (chained frames, folded premasks): kernel K1 on a CUDA
    ``device``, its plain version on the CPU. Every ray keeps intensity 1,
    as in the JAX engine."""
    if n_rays >= 1 << 24:
        raise ValueError("per-call ray count must stay < 2^24 (float index exactness); "
                         "chunk larger ranges")
    device = _elements_device(elements) if device is None else torch.device(device)
    out = ft.fused_source_trace(ft.chain_table(spec, elements), spec, n_rays, device=device,
                                phase=phase, k_frac=k_frac, n_total=n_total,
                                ignore_defects=ignore_defects)
    return RayBundle(
        p=out.p, d=out.d, opl=out.opl, opl_c=out.opl_c, alive=out.alive,
        intensity=torch.ones((n_rays,), dtype=torch.float32, device=out.p.device),
        incidence=out.incidence,
        wavelength=torch.tensor(wavelength, dtype=torch.float32, device=out.p.device),
    )


def xla_source_moments(spec: ft.BakedSource, elements, n_rays: int, det_centre, det_normal,
                       det_rot, opl_ref: float | None = None, gaussian_edge: float | None = None,
                       centre_distance: float = 0.0, ignore_defects: bool = True, inputs=None, *,
                       device=None):
    """The 16 distance-independent detector moments of ``n_rays`` source
    rays (kernel K2 on a CUDA ``device``, its plain version on the CPU),
    chunked at :data:`CHUNK` rays by the (phase, k_frac) law; the contract of
    ``fused_trace.source_detector_moments``. ``inputs`` (from
    :func:`make_xla_moments_fn`) is the chain table made once."""
    device = _elements_device(elements) if device is None else torch.device(device)
    centre_distance = float(np.float32(centre_distance))
    opl_ref, inv_dn_chief = ft.chief_ray_refs(spec, elements, det_centre, det_normal, opl_ref,
                                              device=device, dtype=default_dtype())
    det = ft.bake_detector(elements, det_centre, det_normal, det_rot, opl_ref=opl_ref,
                           inv_dn_chief=inv_dn_chief)
    table = inputs if inputs is not None else ft.chain_table(spec, elements)
    chunks = ft.source_chunks(spec.kind, n_rays, n_rays, CHUNK, n_each=spec.n_each,
                              n_sources=spec.n_sources)
    moments = ft.fused_source_moments(table, spec, det, chunks, n_rays, device=device,
                                      gaussian_edge=gaussian_edge,
                                      centre_distance=centre_distance,
                                      ignore_defects=ignore_defects)
    return {"moments": moments, "opl_ref": opl_ref, "inv_dn_chief": inv_dn_chief,
            "centre_distance": centre_distance}


def make_xla_moments_fn(spec: ft.BakedSource, elements, n_rays: int, ignore_defects: bool = True,
                        *, device=None):
    """``moments_fn`` for ``analysis.optimizer.FindOptimalDistanceFused``
    (``FindOptimalDistancePallas``) over :func:`xla_source_moments`: the
    chain table is made once and every call reuses it (and the grid maps'
    packed rows on the device)."""
    table = ft.chain_table(spec, elements)

    def moments_fn(det_centre, det_normal, det_rot, gaussian_edge=None, centre_distance=0.0):
        return xla_source_moments(spec, elements, n_rays, det_centre, det_normal, det_rot,
                                  gaussian_edge=gaussian_edge, centre_distance=centre_distance,
                                  ignore_defects=ignore_defects, inputs=table, device=device)

    return moments_fn
