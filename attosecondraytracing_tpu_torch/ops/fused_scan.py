"""The runtime-pose scan kernel K5, its plain PyTorch version, and the scan
engine's host side (counterpart of the JAX package's ``ops/pallas_scan.py``).

A parameter scan (``get_OE_loop_list``, ``get_source_loop_list``, the
OEPlacement distance axis, Monte-Carlo tolerancing) runs many chains that
differ only in pose. K5 (``csrc/fused_scan.cu``, ``scan_moments_kernel``)
replaces ``_kernel_scan_moments``: the pose-independent part of the chain
(element kinds, surfaces, supports, support centres, the source kind and
law) is one packed record shared by every chain of the scan (:class:`ScanSpec`),
and each chain hands the kernel only its pose vector ``svec``
(:func:`~.fused_grad.chain_scalars_np`, ~12 floats per element) and the
auxiliary scalars ``aux`` below. The kernel synthesizes the chain's source,
traces it with masks as their own (unfolded) steps, and reduces to the 16
detector moments of :data:`~.fused_trace.MOMENT_FIELDS`; no per-ray bundle
is ever built.

``aux`` layout (float32, one row per chunk): [opl_ref, inv_dn_chief,
centre_distance, source radius, weight coefficient, phase, k_frac,
source-disk radius], where the weight coefficient is ``ln(gaussian_edge)``
(the weight is ``exp(coef * rr)``; 0 gives weight 1) and (phase, k_frac) are
the chunk's offsets on the global source (:func:`~.fused_trace.source_chunks`).

:func:`fused_scan_moments` takes the plain version :func:`scan_moments_ref`
only for a CPU device; for a CUDA device it launches K5 or raises, and
counts its launches in ``fused_scan_moments.launches``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import fused_trace as ft
from .defects import ZernikeDefect, _coeff_items
from .fused_grad import _unpack_scalars, chain_scalars_np, n_scalars
from .trace import MaskElement, TraceState, bake, chained_step

N_AUX = 8
(AUX_OPL_REF, AUX_INV_DN, AUX_CENTRE_D, AUX_RADIUS, AUX_WCOEF, AUX_PHASE,
 AUX_KFRAC, AUX_POS_RADIUS) = range(N_AUX)


class ScanSpec(NamedTuple):
    """The shared structure of a scan: one packed record serves every chain
    whose pose-independent parts match these. ``elements`` are one
    representative chain's host float64 element records; their poses are
    unused (each chain's poses come from its ``svec``)."""

    source_kind: str   # 'cone' | 'disk' | 'extended' | 'square'
    elements: tuple
    n_total: int       # global ray count (radius-law divisor)
    ignore_defects: bool = True
    n_each: int = 0    # rays per sub-source ('extended'), grid side ('square')
    n_sources: int = 0


def make_scan_spec(source_kind: str, elements, n_total: int, ignore_defects: bool = True,
                   n_each: int = 0, n_sources: int = 0) -> ScanSpec:
    """The :class:`ScanSpec` of a scan whose chains share ``elements``'
    pose-independent parts."""
    return ScanSpec(source_kind=source_kind,
                    elements=tuple(ft.elements_to(elements, "cpu", torch.float64)),
                    n_total=int(n_total), ignore_defects=bool(ignore_defects),
                    n_each=int(n_each), n_sources=int(n_sources))


def _defect_key(defect):
    """A hashable identity of a defect record: a Zernike table by value, a
    grid map by its height map's identity."""
    if isinstance(defect, ZernikeDefect):
        return ("zernike", tuple(sorted((tuple(k), float(v)) for k, v in _coeff_items(defect.coeffs))),
                float(defect.radius))
    return ("grid", id(defect.height))


def pose_independent_signature(elements):
    """Hashable signature of everything a :class:`ScanSpec` packs: element
    kinds, surfaces, supports, support centres and defects. Chains with
    equal signatures share one record; their poses may differ freely."""
    sig = []
    for el in elements:
        if isinstance(el, MaskElement):
            sig.append(("mask", el.support))
        else:
            sig.append(("mirror", bake(el.centre), el.surface, el.support,
                        tuple(_defect_key(d) for d in el.defects)))
    return tuple(sig)


#: a chain's float32 pose vector, composed in host float64 (the JAX
#: package's name for it in the scan engine)
scan_chain_scalars = chain_scalars_np


def scan_aux(chunks, opl_ref, inv_dn_chief, centre_distance=0.0, radius=0.0,
             gaussian_edge=None, pos_radius=0.0) -> np.ndarray:
    """(n_chunks, N_AUX) float32 ``aux`` rows of one moment pass."""
    wcoef = 0.0 if gaussian_edge is None else float(np.log(gaussian_edge))
    return np.asarray([[opl_ref, inv_dn_chief, centre_distance, radius, wcoef, phase, k_frac,
                        pos_radius] for _n, phase, k_frac in chunks], dtype=np.float32)


def _source_record(spec: ScanSpec) -> ft.BakedSource:
    """The pose-independent source description (the kernel takes radius,
    weight and source-disk radius from ``aux``)."""
    return ft.BakedSource(kind=spec.source_kind, rot=((1.0, 0.0, 0.0),) * 3,
                          origin=(0.0, 0.0, 0.0), radius=1.0, n_each=spec.n_each,
                          n_sources=spec.n_sources)


def pack_scan_chain(spec: ScanSpec, device=None) -> np.ndarray:
    """K5's chain record: kinds, surface constants, supports, centres and
    defects of the unfolded chain, maps left zero (the kernel writes them
    from ``svec``); grid rows on ``device`` as :func:`~.fused_trace.pack_chain`
    packs them. Raises NotImplementedError on what the kernel does not take."""
    n = len(spec.elements)
    zero_map = (np.zeros((3, 3)), np.zeros(3))
    table = ft.ChainTable(elements=spec.elements, maps=(zero_map,) * n, final=zero_map,
                          premasks=((),) * n)
    return ft.pack_chain(table, spec.ignore_defects, device)


def scan_moments_ref(spec: ScanSpec, svec, aux_rows, chunks, *, device) -> np.ndarray:
    """Plain PyTorch version of K5, following the JAX package's
    ``_kernel_scan_moments``: per chunk, the float32 source with the runtime
    radius, the chained trace with every pose from ``svec`` and masks as
    their own steps (dead rays not frozen at mirrors), the weight
    ``exp(aux[WCOEF] * rr)`` and the 16 moment terms about the runtime
    detector, summed in float64. Returns (16,)."""
    svec = np.asarray(svec, np.float32)
    n_el = len(spec.elements)
    if svec.shape != (n_scalars(n_el),):
        raise ValueError(f"svec of a {n_el}-element chain has {n_scalars(n_el)} scalars, "
                         f"got shape {svec.shape}")
    maps, det_rel = _unpack_scalars([float(v) for v in svec], n_el)
    elements = ft.elements_to(spec.elements, device, torch.float64)
    total = torch.zeros(len(ft.MOMENT_FIELDS), dtype=torch.float64, device=device)
    for (n_local, _phase, _k_frac), row in zip(chunks, np.asarray(aux_rows, np.float32)):
        a = [float(v) for v in row]
        k = torch.arange(n_local, dtype=torch.int64, device=device)
        (px, py, pz), (dx, dy, dz), rr = ft.synth_source(
            spec.source_kind, k, spec.n_total, a[AUX_RADIUS], a[AUX_PHASE], a[AUX_KFRAC],
            pos_radius=a[AUX_POS_RADIUS], n_each=spec.n_each, n_sources=spec.n_sources)
        zeros = torch.zeros_like(rr)
        s = TraceState(px, py, pz, dx, dy, dz, zeros, zeros,
                       torch.ones_like(rr, dtype=torch.bool), zeros)
        for el, (M, b) in zip(elements, maps):
            s = chained_step(el, M, b, s, want_incidence=False, ignore_defects=spec.ignore_defects,
                             freeze_dead=False)
        det = ft.BakedDetector(centre=det_rel[0], normal=det_rel[1], e1=det_rel[2],
                               e2=det_rel[3], opl_ref=a[AUX_OPL_REF],
                               inv_dn_chief=a[AUX_INV_DN])
        w = torch.exp(ft._scalar32(a[AUX_WCOEF], device) * rr)
        total += ft.moment_rows(s, det, w, ft._scalar32(a[AUX_CENTRE_D], device)).double().sum(dim=1)
    return total.cpu().numpy()


def prepare_scan_moments(spec: ScanSpec, svec, aux_rows, chunks, *, device):
    """K5's host work for a CUDA ``device``: pack the shared records
    (raising on what the kernel does not take), copy ``svec`` and the
    ``aux`` rows to the device, and allocate the per-block rows. Returns
    ``(rows, launch)``; each ``launch()`` runs the kernel once over every
    chunk, writing one float64 row of the 16 moments per block, and counts
    it in ``fused_scan_moments.launches``."""
    sizes = ft._check_chunks(chunks)
    device = ft._cuda_device(device, "fused_scan_moments")
    chain_rec = pack_scan_chain(spec, device)
    grids = ft.launch_grids(spec.elements, device)
    src_rec = ft.pack_source(_source_record(spec), spec.n_total)
    svec = np.asarray(svec, np.float32)
    aux_rows = np.asarray(aux_rows, np.float32)
    n_el = len(spec.elements)
    if svec.shape != (n_scalars(n_el),) or aux_rows.shape != (len(chunks), N_AUX):
        raise ValueError(f"K5 takes svec ({n_scalars(n_el)},) and aux ({len(chunks)}, {N_AUX}), "
                         f"got {svec.shape} and {aux_rows.shape}")
    from . import _cuda

    svec_t = torch.as_tensor(svec).to(device)
    aux_t = torch.as_tensor(aux_rows).to(device)
    n_rays, chunk = sum(sizes), sizes[0]
    grid = ft.ray_grid(sizes, _cuda.moment_rays_per_block())
    rows = torch.empty((grid[1], len(ft.MOMENT_FIELDS)), dtype=torch.float64,
                       device=svec_t.device)
    for name, x, dtype in (("svec", svec_t, torch.float32), ("aux", aux_t, torch.float32),
                           ("moment rows", rows, torch.float64)):
        ft._check_out(name, x, dtype, svec_t.device)

    def launch():
        with torch.cuda.device(rows.device):
            stream = torch.cuda.current_stream(rows.device).cuda_stream
            _cuda.launch_scan_moments(chain_rec, src_rec, n_rays, chunk, grid, svec_t, aux_t,
                                      rows, stream, grids)
        fused_scan_moments.launches += 1

    return rows, launch


def fused_scan_moments(spec: ScanSpec, svec, aux_rows, chunks, *, device) -> np.ndarray:
    """K5 (replaces ``ops/pallas_scan.py::_kernel_scan_moments`` of the JAX
    package): the 16 weighted detector moments of every chunk's rays, summed
    in float64. All chunks of equal nominal size go in one launch, on a
    grid sized to the rays (:func:`~.fused_trace.ray_grid`). CPU runs
    :func:`scan_moments_ref`."""
    ft._check_chunks(chunks)
    if torch.device(device).type == "cpu":
        return scan_moments_ref(spec, svec, aux_rows, chunks, device=device)
    rows, launch = prepare_scan_moments(spec, svec, aux_rows, chunks, device=device)
    launch()
    return rows.sum(dim=0).cpu().numpy()


fused_scan_moments.launches = 0


def scan_chunks(spec: ScanSpec, n_rays: int, phase=0.0, k_frac=0.0):
    """The chunk law of one moment pass over ``n_rays`` rays of the source."""
    return ft.source_chunks(spec.source_kind, n_rays, spec.n_total, ft.CHUNK, phase, k_frac,
                            n_each=spec.n_each, n_sources=spec.n_sources)


def scan_moments(spec: ScanSpec, svec, n_rays: int, opl_ref: float, inv_dn_chief: float,
                 centre_distance: float = 0.0, radius: float = 0.0,
                 gaussian_edge: float | None = None, phase: float = 0.0,
                 k_frac: float = 0.0, pos_radius: float = 0.0, *, device) -> np.ndarray:
    """The 16 weighted detector moments (float64, MOMENT_FIELDS order) of
    one chain of the scan, every pose a runtime value; chunks of 2^23 rays
    by the (phase, k_frac) law, summed in float64."""
    chunks = scan_chunks(spec, n_rays, phase, k_frac)
    aux = scan_aux(chunks, opl_ref, inv_dn_chief, float(np.float32(centre_distance)), radius,
                   gaussian_edge, pos_radius)
    return fused_scan_moments(spec, svec, aux, chunks, device=device)


def _scan_mesh(spec: ScanSpec, n_rays: int, *, device=None):
    """The mesh every scan-kernel pass shards its rays over when
    ``ART_TPU_SCAN_MESH=1`` (``parallel/mesh.scan_moments_sharded``: one
    16-moment row per shard and chain crosses the mesh): the process
    group's, one shard per rank on ``device``, when ``torch.distributed``
    is initialized, else every card of this process. None (one device) when
    the variable is unset, with fewer than 2 shards, for 'extended' and
    'square' sources (shard alignment), or when the ray count does not
    divide."""
    import os

    if os.environ.get("ART_TPU_SCAN_MESH", "0") != "1":
        return None
    from ..parallel.mesh import _default_mesh

    mesh = _default_mesh(device)
    if (mesh is None or mesh.size < 2 or spec.source_kind in ("extended", "square")
            or n_rays % mesh.size):
        return None
    return mesh


def make_moments_fn(spec: ScanSpec, elements, source_info, n_rays: int, *, device):
    """The per-chain ``moments_fn`` of
    :func:`~..analysis.optimizer.FindOptimalDistanceFused`: a closure over
    this chain's elements and factory-source description that evaluates the
    shared kernel (one packed record across the chains of ``spec``), its
    rays sharded over :func:`_scan_mesh`'s mesh when there is one.
    ``source_info`` is the chain's ``models.chain.FusedSourceInfo``."""
    from .precision import default_dtype

    baked = source_info.baked()
    src_rot = np.asarray(baked.rot, np.float64)
    src_origin = np.asarray(baked.origin, np.float64)
    mesh = _scan_mesh(spec, n_rays, device=device)

    def moments_fn(det_centre, det_normal, det_rot, gaussian_edge=None, centre_distance=0.0):
        opl_ref, inv_dn_chief = ft.chief_ray_refs(baked, elements, det_centre, det_normal,
                                                  device=device, dtype=default_dtype())
        svec = scan_chain_scalars(elements, src_rot, src_origin, det_centre, det_normal,
                                  det_rot)
        kw = dict(centre_distance=centre_distance, radius=baked.radius,
                  gaussian_edge=gaussian_edge, pos_radius=baked.pos_radius)
        if mesh is None:
            moments = scan_moments(spec, svec, n_rays, opl_ref, inv_dn_chief, device=device, **kw)
        else:
            from ..parallel.mesh import scan_moments_sharded

            moments = scan_moments_sharded(spec, svec, n_rays, mesh, opl_ref, inv_dn_chief, **kw)
        return {"moments": moments, "opl_ref": opl_ref, "inv_dn_chief": inv_dn_chief,
                "centre_distance": float(np.float32(centre_distance))}

    return moments_fn


def total_source_weight(n_rays: int, gaussian_edge: float | None, n_each: int = 0,
                        n_sources: int = 0, kind: str | None = None) -> float:
    """Closed-form total source weight ``sum_k exp(ln(edge) * rr_k)``, the
    transmission denominator of a fused scan: a geometric series for plain
    spirals (rr_k = k/n), ``n_sources`` times the per-cone series for
    extended sources, and the square of a 1-D sum for square grids (the
    corner-normalized law separates)."""
    if gaussian_edge is None:
        return float(n_rays)
    if kind == "square":
        xs = np.linspace(-0.5, 0.5, n_each) if n_each > 1 else np.array([-0.5])
        s = float(np.exp(np.log(gaussian_edge) * 2.0 * xs * xs).sum())
        return s * s
    if n_each:
        return n_sources * total_source_weight(n_each, gaussian_edge)
    c = float(np.log(gaussian_edge) / n_rays)
    return float(np.expm1(c * n_rays) / np.expm1(c))
