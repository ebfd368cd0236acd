"""Giga-ray detector images: the fused source traced chunk by chunk through
kernel K1 and binned on the device (counterpart of the JAX package's
``analysis/gigascan.py``).

K1 synthesizes and traces rays from nothing but the ray index, so the ray
count of an image is bounded by time, not memory: the spot diagram and the
spatio-temporal delay map (ART/ModuleAnalysisAndPlots.py:133-440) run at
billions of rays by streaming chunks of 2^23 rays through the kernel into
one reused output buffer and adding each chunk into two float64 images on
the device. Only the O(bins^2) images persist; nothing per ray reaches the
host.

Delays are taken against a fixed chief-ray reference (not a per-chunk mean,
which would move from chunk to chunk) and re-centred to the global weighted
mean at the end: the semantics of Detector.get_Delays at any scale.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import fused_trace as ft
from ..ops.geometry import kahan_add
from ..ops.precision import LIGHT_SPEED_MM_S
from ..ops.trace import trace
from ..ops.xla_source import _elements_device
from . import stats
from .histogram import _bin_indices, _flat_index, bin_add

#: the image engines' names in the JAX package: its Mosaic kernel
#: ("pallas") and its XLA program ("xla-source", which also took grid maps);
#: both are kernel K1 here, which takes grid maps
ENGINES = ("pallas", "xla-source")
#: rays of the trace that fits the image's extent when none is given
EXTENT_PROBE_RAYS = 1 << 17


def _chunk_binned_sums(out: ft.TraceOutputs, weights, centre, normal, rot, lo, hi, opl_ref,
                       bins, images):
    """Add one traced chunk into ``images`` (the flat float64 weight and
    weight x delay images): weights and delays [fs, against ``opl_ref``] on
    the FIXED extent ``(lo, hi)``."""
    pts3, t = stats.detector_points_3d(out, centre, normal)  # reads p and d
    xy = stats.plane_coords(pts3, centre, rot)
    s, c = kahan_add(out.opl, out.opl_c, t)
    # (s - opl_ref) is a same-magnitude cancellation (exact); the Kahan
    # compensation then applies at full significance
    delay_fs = ((s - opl_ref) - c) * (1e15 / LIGHT_SPEED_MM_S)
    ix, iy, inside = _bin_indices(xy, lo, hi, bins)
    wv = torch.where(out.alive & inside, weights, 0.0)
    bin_add(images, _flat_index(ix, iy, bins), (wv, wv * delay_fs))


def _weights_c(spec: ft.BakedSource, n_local, n_total, phase, k_frac, logedge, device):
    """A chunk's Gaussian weights ``edge ** rr`` from the source's radial law
    (1.0 without an edge), as the kernels synthesize them."""
    if logedge is None:
        return torch.ones((n_local,), dtype=torch.float32, device=device)
    k = torch.arange(n_local, dtype=torch.int64, device=device)
    _p, _d, rr = ft.synth_spec(spec, k, n_total, phase, k_frac)
    return torch.exp(logedge * rr)


def k1_chunks(table, spec, chunk, n_total, *, device, ignore_defects):
    """The image loop's chunk tracer: ``trace_chunk(n_local, phase, k_frac)``
    returning the chunk's :class:`~..ops.fused_trace.TraceOutputs`. On a
    CUDA ``device`` kernel K1 launches into one reused buffer of ``chunk``
    rays (:func:`~..ops.fused_trace.prepare_fused_source_chunks`: records
    packed once; each chunk's outputs are a prefix of the buffer, valid
    until the next launch); on the CPU its plain version runs
    (:func:`plain_chunks`)."""
    if device.type == "cpu":
        return plain_chunks(table, spec, chunk, n_total, device=device,
                            ignore_defects=ignore_defects)
    outs, launch = ft.prepare_fused_source_chunks(table, spec, chunk, n_total, device=device,
                                                  ignore_defects=ignore_defects)

    def trace_chunk(n_local, phase, k_frac):
        launch(n_local, phase, k_frac)
        return ft.TraceOutputs(*(x[:n_local] for x in outs))

    return trace_chunk


def plain_chunks(table, spec, chunk, n_total, *, device, ignore_defects):
    """The chunk tracer of K1's plain version
    (:func:`~..ops.fused_trace.fused_source_trace_ref`) on any device."""
    def trace_chunk(n_local, phase, k_frac):
        return ft.fused_source_trace_ref(table, spec, n_local, device=device, phase=phase,
                                         k_frac=k_frac, n_total=n_total,
                                         ignore_defects=ignore_defects)

    return trace_chunk


def _elements_dtype(elements) -> torch.dtype:
    """The probe traces' dtype: the elements' (float32 for host arrays)."""
    rot = elements[0].rot
    return rot.dtype if torch.is_tensor(rot) else torch.float32


def _fit_extent(spec, elements, n_probe, centre, normal, rot, ignore_defects, device):
    """The image window: the bounding box of a traced probe's surviving
    impact points, padded 5 % (and 1e-12 mm) about its middle."""
    dtype = _elements_dtype(elements)
    probe = ft.source_bundle(spec, n_probe, device=device).to(dtype=dtype)
    pout = trace(probe, ft.elements_to(elements, device, dtype), ignore_defects,
                 keep_history=False)
    xy = stats.detector_points_2d(pout, centre, normal, rot).cpu().numpy()
    alive = pout.alive.cpu().numpy()
    if not alive.any():
        raise RuntimeError("no probe ray reaches the detector; cannot auto-fit the image extent")
    lo, hi = xy[alive].min(axis=0), xy[alive].max(axis=0)
    mid, half = 0.5 * (lo + hi), 0.5 * (hi - lo) * 1.05 + 1e-12
    return mid - half, mid + half


def _images(source_spec, elements, detector, n_total, bins, extent, chunk, ignore_defects,
            device, tracer):
    """:func:`fused_source_images` with the chunk tracer ``tracer(table, spec,
    chunk, n_total, device=, ignore_defects=)`` (:func:`k1_chunks`, or
    :func:`plain_chunks` to hold the kernel against its plain version)."""
    spec = source_spec.baked()
    n_total = int(n_total if n_total is not None else source_spec.n_rays)
    bins = tuple(int(b) for b in bins)
    table = ft.chain_table(spec, elements)
    chunks = ft.source_chunks(spec.kind, n_total, n_total, chunk, n_each=spec.n_each,
                              n_sources=spec.n_sources)
    # pack once, before anything else touches the device
    trace_chunk = tracer(table, spec, chunks[0][0], n_total, device=device,
                         ignore_defects=ignore_defects)
    rot = detector._plane_rotation()
    centre = torch.as_tensor(detector.centre, dtype=torch.float32, device=device)
    normal = torch.as_tensor(detector.normal, dtype=torch.float32, device=device)
    rot_t = torch.as_tensor(rot, dtype=torch.float32, device=device)
    opl_ref, _ = ft.chief_ray_refs(spec, elements, detector.centre, detector.normal,
                                   device=device, dtype=_elements_dtype(elements))
    if extent is None:
        lo, hi = _fit_extent(spec, elements, min(n_total, EXTENT_PROBE_RAYS), centre, normal,
                             rot_t, ignore_defects, device)
    else:
        lo, hi = np.asarray(extent[0], float), np.asarray(extent[1], float)
    lo_t = torch.as_tensor(lo, dtype=torch.float32, device=device)
    hi_t = torch.as_tensor(hi, dtype=torch.float32, device=device)
    opl_ref_t = torch.tensor(opl_ref, dtype=torch.float32, device=device)
    edge = source_spec.gaussian_edge
    logedge = None if edge is None else float(np.log(edge))

    # One float64 accumulator pair on the device for all chunks: the JAX
    # package sums groups of chunks in float32 and the groups on the host in
    # float64 (pixel weights pass float32's 2^24 on giga-ray images); float64
    # device sums need no groups. Nothing synchronizes or crosses to the host
    # until the loop ends.
    images = tuple(torch.zeros(bins[0] * bins[1], dtype=torch.float64, device=device)
                   for _ in range(2))
    for n_local, phase, k_frac in chunks:
        out = trace_chunk(n_local, phase, k_frac)
        weights = _weights_c(spec, n_local, n_total, phase, k_frac, logedge, device)
        _chunk_binned_sums(out, weights, centre, normal, rot_t, lo_t, hi_t, opl_ref_t, bins,
                           images)
    w_img, wd_img = (img.reshape(bins).cpu().numpy() for img in images)
    sum_w = w_img.sum()
    global_mean = wd_img.sum() / max(sum_w, 1e-30)
    has = w_img > 0
    mean_delay = np.where(has, wd_img / np.where(has, w_img, 1.0) - global_mean, np.nan)
    return {"image": w_img, "mean_delay": mean_delay, "weight_image": w_img,
            "extent": (lo, hi), "sum_w": sum_w, "n_total": n_total}


def fused_source_images(source_spec, elements, detector, n_total: int | None = None,
                        bins=(512, 512), extent=None, chunk: int = 1 << 23,
                        ignore_defects: bool = True, engine: str = "pallas"):
    """Intensity image and mean-delay map of ``n_total`` fused-source rays.

    ``source_spec`` is a chain's ``FusedSourceInfo`` (models/chain.py);
    ``n_total`` defaults to its ray count and may be arbitrarily larger: the
    source is synthesized in the kernel, so a billion-ray image costs time,
    not memory. ``elements`` are the chain's element records (e.g.
    ``chain.device_elements()``), on the device the image is made on. Returns a
    dict: ``image`` (weighted intensity histogram, float64, x along axis 0),
    ``mean_delay`` [fs, NaN off the beam, re-centred to the global weighted
    mean], ``weight_image``, ``extent`` (lo, hi) [mm], ``sum_w`` and
    ``n_total``. ``extent=None`` fits the window to a traced probe of
    ``min(n_total, 2^17)`` rays.

    Chunks of ``chunk`` rays (aligned to whole sub-sources or grid rows for
    extended and square sources) follow the JAX package's (phase, k_frac)
    law (``ops/fused_trace.source_chunks``), so ray k is ray k of the one
    global spiral. On a CUDA device each chunk is one launch of kernel K1;
    on the CPU its plain version runs. Both of the JAX package's engine
    names are K1 here (:data:`ENGINES`); with ``ignore_defects=False`` the
    kernel composes the defect slopes into the normals, grid maps
    included."""
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
    return _images(source_spec, elements, detector, n_total, bins, extent, chunk,
                   ignore_defects, _elements_device(elements), k1_chunks)
