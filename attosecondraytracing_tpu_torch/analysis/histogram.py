"""Detector images on the bundle's device: intensity histograms and
mean-delay maps (counterpart of the JAX package's ``analysis/histogram.py``).

The reference's analysis plots gather every ray to the host and
scatter-plot them (SpotDiagram / DelayGraph, ART/ModuleAnalysisAndPlots.py:
133-440). These functions bin the bundle where it lives into fixed-size
images, so only O(bins) numbers ever leave the device.

The images are linear, and so differentiable, in the ray weights: bin
indices are discrete, gradients flow through the intensities. The layout is
the JAX package's (and ``np.histogram2d``'s): x along axis 0, y along
axis 1.
"""

from __future__ import annotations

import torch

from ..ops.bundle import RayBundle
from . import stats


def _detector_extent(xy, w, pad: float = 1.05):
    """Symmetric-padded bounding box ``(lo, hi)`` of the impact points with
    weight > 0."""
    big = torch.finfo(xy.dtype).max
    alive = (w > 0)[:, None]
    lo = torch.min(torch.where(alive, xy, big), dim=0).values
    hi = torch.max(torch.where(alive, xy, -big), dim=0).values
    mid = 0.5 * (lo + hi)
    half = torch.clamp(0.5 * (hi - lo) * pad, min=torch.finfo(xy.dtype).tiny)
    return mid - half, mid + half


def _bin_indices(xy, lo, hi, bins):
    """Per-axis bin index and in-range mask. The fractional index is
    truncated toward zero, then clipped, so a point exactly on the upper
    edge falls in the last bin (``np.histogram2d``'s edges)."""
    nx, ny = bins
    sx = nx / (hi[0] - lo[0])
    sy = ny / (hi[1] - lo[1])
    fx = (xy[:, 0] - lo[0]) * sx
    fy = (xy[:, 1] - lo[1]) * sy
    ix = torch.clamp(fx.to(torch.int32), 0, nx - 1)
    iy = torch.clamp(fy.to(torch.int32), 0, ny - 1)
    inside = (fx >= 0) & (fx <= nx) & (fy >= 0) & (fy <= ny)
    return ix, iy, inside


def _flat_index(ix, iy, bins):
    """Row-major pixel index ``ix * by + iy`` (int64, ``index_add_``'s)."""
    return ix.to(torch.int64) * bins[1] + iy.to(torch.int64)


def bin_add(images, flat, cols):
    """Add each column of ``cols`` at the pixels ``flat`` into the flat
    float64 image of ``images`` with the same position, in place."""
    for img, col in zip(images, cols):
        img.index_add_(0, flat, col.to(torch.float64))


def binned_sums(ix, iy, cols, bins, precision=None):
    """K weighted 2-D histograms: for each column of ``cols``, the sum of its
    values at each pixel ``(ix, iy)`` of a ``bins``-shaped image. The JAX
    package forms them by blocked one-hot matmuls because its TPU has no
    fast scatter; here ``index_add`` on the flat pixel index sums them in
    float64 on the device (``precision``, the JAX matmul precision, is
    accepted and has no meaning here). Linear in ``cols`` and differentiable
    in them. Returns a tuple of K images in the dtype of ``cols``."""
    images = tuple(torch.zeros(bins[0] * bins[1], dtype=torch.float64, device=col.device)
                   for col in cols)
    bin_add(images, _flat_index(ix, iy, bins), cols)
    return tuple(img.to(col.dtype).reshape(bins) for img, col in zip(images, cols))


def _weights_and_extent(bundle: RayBundle, xy, extent, intensity_weighted):
    w = bundle.alive.to(xy.dtype)
    if intensity_weighted:
        w = w * bundle.intensity.to(xy.dtype)
    if extent is None:
        lo, hi = _detector_extent(xy, w)
    else:
        lo = torch.as_tensor(extent[0], dtype=xy.dtype, device=xy.device)
        hi = torch.as_tensor(extent[1], dtype=xy.dtype, device=xy.device)
    return w, lo, hi


def detector_image(bundle: RayBundle, centre, normal, rot, bins=(256, 256), extent=None,
                   intensity_weighted: bool = True):
    """Intensity image of the bundle on the detector plane.

    Returns ``(image, (lo, hi))``: ``image`` is ``bins``-shaped with x along
    axis 0, ``lo`` / ``hi`` the in-plane corners [mm]. ``extent=None``
    fits the surviving points with 5 % padding; ``(lo, hi)`` fixes the
    window (points outside it are dropped)."""
    bins = tuple(int(b) for b in bins)
    xy = stats.detector_points_2d(bundle, centre, normal, rot)
    w, lo, hi = _weights_and_extent(bundle, xy, extent, intensity_weighted)
    ix, iy, inside = _bin_indices(xy, lo, hi, bins)
    (img,) = binned_sums(ix, iy, (torch.where(inside, w, 0.0),), bins)
    return img, (lo, hi)


def value_map(bundle: RayBundle, values, centre, normal, rot, bins=(256, 256), extent=None,
              intensity_weighted: bool = True):
    """Per-pixel weighted mean of the per-ray scalars ``values`` on the
    detector plane (the binned form of the reference's colour-coded scatter
    plots). Returns ``(mean_image, weight_image, (lo, hi))``; pixels of zero
    weight hold NaN."""
    bins = tuple(int(b) for b in bins)
    xy = stats.detector_points_2d(bundle, centre, normal, rot)
    values = torch.as_tensor(values, device=xy.device)
    w, lo, hi = _weights_and_extent(bundle, xy, extent, intensity_weighted)
    ix, iy, inside = _bin_indices(xy, lo, hi, bins)
    wv = torch.where(inside, w, 0.0)
    w_img, wd_img = binned_sums(ix, iy, (wv, wv * values), bins)
    has = w_img > 0
    mean = torch.where(has, wd_img / torch.where(has, w_img, 1.0), float("nan"))
    return mean, w_img, (lo, hi)


def delay_map(bundle: RayBundle, centre, normal, rot, bins=(256, 256), extent=None,
              intensity_weighted: bool = True):
    """Spatio-temporal distortion image: the per-pixel weighted mean delay
    [fs] of the reference's detector delays (Detector.get_Delays,
    ART/ModuleDetector.py:254-279), the binned DelayGraph at any bundle
    size. Returns ``(mean_delay, weight_image, (lo, hi))``; pixels of zero
    weight hold NaN."""
    delays = stats.detector_delays(bundle, centre, normal)
    return value_map(bundle, delays, centre, normal, rot, bins=bins, extent=extent,
                     intensity_weighted=intensity_weighted)
