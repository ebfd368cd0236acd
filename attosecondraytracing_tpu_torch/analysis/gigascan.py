"""Giga-ray detector images: the fused source traced and binned on the
device (counterpart of the JAX package's ``analysis/gigascan.py``).

The source is synthesized from nothing but the ray index, so the ray count
of an image is bounded by time, not memory: the spot diagram and the
spatio-temporal delay map (ART/ModuleAnalysisAndPlots.py:133-440) run at
billions of rays. On a CUDA device kernel K1i traces every 2^23-ray chunk of
the image in one launch and adds each ray into two float64 images on the
device (``ops/fused_trace.prepare_fused_source_image``); nothing per ray is stored.
Its plain version, and the path on the CPU, is the chunk loop: each chunk
traced (K1's plain version), weighted, and binned by K1i's per-ray
arithmetic in plain PyTorch (``ops/fused_trace.image_rays_ref``).
Only the O(bins^2) images persist.

Delays are taken against a fixed chief-ray reference (not a per-chunk mean,
which would move from chunk to chunk) and re-centred to the global weighted
mean at the end: the semantics of Detector.get_Delays at any scale.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import fused_trace as ft
from ..ops.trace import trace
from ..ops.xla_source import _elements_device
from . import stats

#: the image engines' names in the JAX package: its Mosaic kernel
#: ("pallas") and its XLA program ("xla-source", which also took grid maps);
#: both are kernel K1i here, which takes grid maps
ENGINES = ("pallas", "xla-source")
#: rays of the trace that fits the image's extent when none is given
EXTENT_PROBE_RAYS = 1 << 17


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


class _Image(NamedTuple):
    """An image's work: the baked source, its ray count and chunks, the
    chain table, the pixels, the plane (``ImageDetector``) and the window."""

    spec: ft.BakedSource
    n_total: int
    chunks: list
    table: ft.ChainTable
    bins: tuple
    det: ft.ImageDetector
    window: tuple
    edge: float | None


def _setup(source_spec, elements, detector, n_total, bins, extent, chunk, ignore_defects,
           device) -> _Image:
    """The image's :class:`_Image`: chain table, chunks, chief-ray path and
    window."""
    spec = source_spec.baked()
    n_total = int(n_total if n_total is not None else source_spec.n_rays)
    bins = tuple(int(b) for b in bins)
    table = ft.chain_table(spec, elements)
    chunks = ft.source_chunks(spec.kind, n_total, n_total, chunk, n_each=spec.n_each,
                              n_sources=spec.n_sources)
    rot = detector._plane_rotation()
    opl_ref, _ = ft.chief_ray_refs(spec, elements, detector.centre, detector.normal,
                                   device=device, dtype=_elements_dtype(elements))
    if extent is None:
        t = [torch.as_tensor(v, dtype=torch.float32, device=device)
             for v in (detector.centre, detector.normal, rot)]
        lo, hi = _fit_extent(spec, elements, min(n_total, EXTENT_PROBE_RAYS), *t,
                             ignore_defects, device)
    else:
        lo, hi = np.asarray(extent[0], float), np.asarray(extent[1], float)
    det = ft.ImageDetector(tuple(np.asarray(detector.centre, np.float64)),
                           tuple(np.asarray(detector.normal, np.float64)),
                           tuple(map(tuple, np.asarray(rot, np.float64)[:2])), float(opl_ref))
    return _Image(spec, n_total, chunks, table, bins, det, (lo, hi), source_spec.gaussian_edge)


def _finish(job: _Image, images) -> dict:
    """The image dict from the two flat float64 device images: the mean
    delays re-centred to the global weighted mean on the host."""
    w_img, wd_img = (img.reshape(job.bins).cpu().numpy() for img in images)
    sum_w = w_img.sum()
    global_mean = wd_img.sum() / max(sum_w, 1e-30)
    has = w_img > 0
    mean_delay = np.where(has, wd_img / np.where(has, w_img, 1.0) - global_mean, np.nan)
    return {"image": w_img, "mean_delay": mean_delay, "weight_image": w_img,
            "extent": job.window, "sum_w": sum_w, "n_total": job.n_total}


def _zeros(job: _Image, device):
    return tuple(torch.zeros(job.bins[0] * job.bins[1], dtype=torch.float64, device=device)
                 for _ in range(2))


def _images(source_spec, elements, detector, n_total, bins, extent, chunk, ignore_defects,
            device, tracer):
    """The chunk loop: :func:`fused_source_images` with the chunk tracer
    ``tracer(table, spec, chunk, n_total, device=, ignore_defects=)``
    (:func:`plain_chunks`: K1i's plain version; :func:`k1_chunks`: K1 per
    chunk), each chunk weighted and binned by K1i's per-ray arithmetic on
    the window's FIXED pixels, delays against the chief-ray path
    (``ops/fused_trace.fused_source_image_ref``)."""
    job = _setup(source_spec, elements, detector, n_total, bins, extent, chunk, ignore_defects,
                 device)
    trace_chunk = tracer(job.table, job.spec, job.chunks[0][0], job.n_total, device=device,
                         ignore_defects=ignore_defects)
    # One float64 accumulator pair on the device for all chunks: the JAX
    # package sums groups of chunks in float32 and the groups on the host in
    # float64 (pixel weights pass float32's 2^24 on giga-ray images); float64
    # device sums need no groups. Nothing synchronizes or crosses to the host
    # until the loop ends.
    images = _zeros(job, device)
    ft.fused_source_image_ref(job.table, job.spec, job.chunks, job.n_total, job.det, job.window,
                              job.bins, images, device=device, gaussian_edge=job.edge,
                              ignore_defects=ignore_defects, trace_chunk=trace_chunk)
    return _finish(job, images)


def _images_k1i(source_spec, elements, detector, n_total, bins, extent, chunk, ignore_defects,
                device, record=None):
    """:func:`fused_source_images` through kernel K1i on a CUDA ``device``:
    one launch for every chunk (``ops/fused_trace.prepare_fused_source_image``;
    ``record``: an ``ImageRecord`` of some chunks' rays, for checks)."""
    job = _setup(source_spec, elements, detector, n_total, bins, extent, chunk, ignore_defects,
                 device)
    launch = ft.prepare_fused_source_image(
        job.table, job.spec, job.chunks, job.n_total, job.det, job.window, job.bins,
        device=device, gaussian_edge=job.edge, ignore_defects=ignore_defects, record=record)
    images = _zeros(job, device)
    launch(images)
    return _finish(job, images)


def fused_source_images(source_spec, elements, detector, n_total: int | None = None,
                        bins=(512, 512), extent=None, chunk: int = 1 << 23,
                        ignore_defects: bool = True, engine: str = "pallas"):
    """Intensity image and mean-delay map of ``n_total`` fused-source rays.

    ``source_spec`` is a chain's ``FusedSourceInfo`` (models/chain.py);
    ``n_total`` defaults to its ray count and may be arbitrarily larger (below
    2^31 on the card): the source is synthesized in the kernel, so a
    billion-ray image costs time, not memory. ``elements`` are the chain's
    element records (e.g. ``chain.device_elements()``), on the device the
    image is made on. Returns a dict: ``image`` (weighted intensity
    histogram, float64, x along axis 0), ``mean_delay`` [fs, NaN off the
    beam, re-centred to the global weighted mean], ``weight_image``,
    ``extent`` (lo, hi) [mm], ``sum_w`` and ``n_total``. ``extent=None`` fits
    the window to a traced probe of ``min(n_total, 2^17)`` rays.

    Chunks of ``chunk`` rays (aligned to whole sub-sources or grid rows for
    extended and square sources) follow the JAX package's (phase, k_frac)
    law (``ops/fused_trace.source_chunks``), so ray k is ray k of the one
    global spiral. On a CUDA device all chunks are one launch of kernel K1i
    (float64 atomics: reproducible to float64 rounding, not bit for bit); on
    the CPU its plain version runs, chunk by chunk. Both of the JAX
    package's engine names are K1i here (:data:`ENGINES`); with
    ``ignore_defects=False`` the kernel composes the defect slopes into the
    normals, grid maps included."""
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
    device = _elements_device(elements)
    args = (source_spec, elements, detector, n_total, bins, extent, chunk, ignore_defects, device)
    if device.type == "cpu":
        return _images(*args, plain_chunks)
    return _images_k1i(*args)
