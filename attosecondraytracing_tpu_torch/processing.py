"""Compatibility façade mirroring ART/ModuleProcessing.py's public surface
(counterpart of the JAX package's ``processing.py``).

CONFIG scripts call ``mp.OEPlacement(...)``, ``mp.FindOptimalDistance(...)``
etc.; the work lives in the layered modules (ops/, models/, analysis/).
"""

from __future__ import annotations

import torch

from .analysis import stats as _stats
from .analysis.optimizer import FindOptimalDistance  # noqa: F401
from .models import chain as _chain
from .models.placement import OEPlacement  # noqa: F401
from .ops.bundle import RayBundle
from .ops.trace import trace
from .utils.io import load_compressed, save_compressed  # noqa: F401


def RayTracingCalculation(source_rays: RayBundle, optical_elements, IgnoreDefects=True, *,
                          device=None, dtype=None):
    """Trace a bundle through host OpticalElements on ``device``; returns the
    list of bundles after each element (ART/ModuleProcessing.py:250-313).
    ``device=None`` takes the device of the CONFIG file being run
    (``models/chain.config_device``) and raises outside one, as a chain with
    no device does."""
    if device is None:
        device = _chain._CONFIG_DEVICE.get()
        if device is None:
            raise RuntimeError(_chain.NO_DEVICE)
    elements = [e.to_device(device, dtype) for e in optical_elements]
    source = source_rays.to(device, elements[0].rot.dtype)
    return trace(source, elements, ignore_defects=IgnoreDefects, keep_history=True)


def FindCentralRay(bundle: RayBundle):
    """(mean point, mean direction) of surviving rays as NumPy arrays."""
    return (_stats.central_point(bundle).cpu().numpy(),
            _stats.central_direction(bundle).cpu().numpy())


def StandardDeviation(x):
    """SD of scalars, or sqrt(sum of per-axis variances) of point arrays."""
    x = torch.as_tensor(x)
    if x.ndim == 1:
        return float(torch.std(x, correction=0))
    return float(torch.sqrt(torch.var(x, dim=0, correction=0).sum()))


def WeightedStandardDeviation(x, weights):
    """Intensity-weighted SD."""
    x = torch.as_tensor(x)
    w = torch.as_tensor(weights, dtype=x.dtype)
    if x.ndim == 1:
        return float(_stats.std_scalar(x, w))
    return float(_stats.std_points(x, w))


def ReturnNumericalAperture(bundle: RayBundle, RefractiveIndex: float = 1.0):
    return float(_stats.numerical_aperture(bundle, RefractiveIndex))


def ReturnAiryRadius(Wavelength, NumericalAperture):
    return float(_stats.airy_radius(Wavelength, NumericalAperture))
