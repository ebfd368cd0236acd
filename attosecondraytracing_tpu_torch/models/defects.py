"""Host-side surface-defect models (ART/ModuleDefects.py; counterpart of the
JAX package's ``models/defects.py``).

Three kinds, with the same constructor signatures as the reference:

* :class:`MeasuredMap` — a measured height map over the support;
* :class:`Fourrier` — synthesized random rough surface with a power-law PSD
  (name spelling kept from the reference for config compatibility; `Fourier`
  is an alias);
* :class:`Zernike` — height error as a Zernike-coefficient dictionary keyed by
  the Andersen (n, m) indices.

Construction happens on the host with NumPy (cheap, once per scene); each
defect exports a device representation
(:mod:`attosecondraytracing_tpu_torch.ops.defects`) used inside the batched trace.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import supports as sup
from ..ops.defects import GridDefect, ZernikeDefect
from ..ops.zernike import zernike_value_and_grad


class Defect:
    """Base class: a height-error map h(x, y) over an optic's support."""

    def RMS(self):
        raise NotImplementedError

    def PV(self):
        raise NotImplementedError

    def offset_at(self, x, y):
        raise NotImplementedError

    def slopes_at(self, x, y):
        """(dh/dx, dh/dy) at support coordinates."""
        raise NotImplementedError

    def get_offset(self, Point):
        """Reference-compatible: height at a 3D point's (x, y)
        (ART/ModuleDefects.py get_offset)."""
        return self.offset_at(Point[0], Point[1])

    def trace_defect(self):
        """The record the trace takes (:mod:`..ops.defects`)."""
        return self.device_defect()

    def get_normal(self, Point):
        """Reference-compatible 'up' normal of the defect alone.

        Note: we return the correct [-dh/dx, -dh/dy, 1]-direction for all
        defect types; the reference flips the sign for Fourrier/MeasuredMap
        (ART/ModuleDefects.py:52-58 — see ops/defects.py docstring).
        """
        gx, gy = self.slopes_at(Point[0], Point[1])
        n = np.array([-gx, -gy, 1.0])
        return n / np.linalg.norm(n)


class _GridBackedDefect(Defect):
    """Shared bilinear-grid plumbing (host mirror of ops.defects.GridDefect)."""

    # subclasses set: _height, _slope_x, _slope_y as [ix, iy]-indexed arrays,
    # plus _x0, _y0, _dx, _dy
    def _bilinear(self, grid, x, y):
        nx, ny = grid.shape
        fx = np.clip((x - self._x0) / self._dx, 0.0, nx - 1.000001)
        fy = np.clip((y - self._y0) / self._dy, 0.0, ny - 1.000001)
        ix = np.clip(np.floor(fx).astype(int), 0, nx - 2)
        iy = np.clip(np.floor(fy).astype(int), 0, ny - 2)
        wx, wy = fx - ix, fy - iy
        return (
            grid[ix, iy] * (1 - wx) * (1 - wy)
            + grid[ix + 1, iy] * wx * (1 - wy)
            + grid[ix, iy + 1] * (1 - wx) * wy
            + grid[ix + 1, iy + 1] * wx * wy
        )

    def offset_at(self, x, y):
        return self._bilinear(self._height, x, y)

    def slopes_at(self, x, y):
        return self._bilinear(self._slope_x, x, y), self._bilinear(self._slope_y, x, y)

    def device_defect(self):
        """The trace's :class:`GridDefect`: host float64 maps here (the
        element's ``to_device`` makes them tensors on its device), the grid
        origin and spacing as python floats."""
        return GridDefect(
            height=self._height,
            slope_x=self._slope_x,
            slope_y=self._slope_y,
            x0=float(self._x0),
            y0=float(self._y0),
            dx=float(self._dx),
            dy=float(self._dy),
        )

    def trace_defect(self):
        """:meth:`device_defect` with the maps as CPU float64 tensors over
        the host arrays, made once per defect: the identity of its height
        map names the grid, so the copies and packed rows made from it
        (``ops.defects.grid_to``, ``ops.fused_trace.grid_rows``) are made
        once per device."""
        if getattr(self, "_trace", None) is None:
            d = self.device_defect()
            self._trace = d._replace(height=torch.from_numpy(d.height),
                                     slope_x=torch.from_numpy(d.slope_x),
                                     slope_y=torch.from_numpy(d.slope_y))
        return self._trace

    def __deepcopy__(self, memo):
        # the maps never change once built: copies of a chain (scans, the
        # OpticalChain constructor) share them, and what is made from them
        return self

    def __getstate__(self):
        state = dict(self.__dict__)
        state.pop("_trace", None)
        return state

    def RMS(self):
        return self.rms

    def PV(self):
        return float(np.max(self._height) - np.min(self._height))


class MeasuredMap(_GridBackedDefect):
    """Defect from a measured height map covering the support
    (ART/ModuleDefects.py:34-67).

    The reference lays the map over [-dimX, dimX] x [-dimY, dimY] (i.e. twice
    the support, ART/ModuleDefects.py:42-43); that quirk is kept so measured
    maps land on the same physical coordinates.
    """

    def __init__(self, Support, Map):
        self.deformation = np.asarray(Map, dtype=float)
        self.Support = Support
        rect = sup.circum_rect(Support)
        nx, ny = self.deformation.shape
        # gradient spacing per reference: rect / shape
        gx, gy = np.gradient(self.deformation, rect[0] / nx, rect[1] / ny)
        self._height = self.deformation
        self._slope_x = gx
        self._slope_y = gy
        self._x0, self._y0 = -rect[0], -rect[1]
        self._dx = 2.0 * rect[0] / (nx - 1)
        self._dy = 2.0 * rect[1] / (ny - 1)
        self.rms = float(np.std(self.deformation))


class Fourrier(_GridBackedDefect):
    """Random rough surface with power-law PSD ~ k^slope between spatial-
    frequency cutoffs, synthesized by masked inverse FFT and normalized to a
    target RMS (ART/ModuleDefects.py:69-146).

    Parameters follow the reference: RMS [mm], ``slope`` (default -2),
    ``smallest``/``biggest`` wavelengths [mm]. ``seed`` (new) makes the
    synthesis reproducible; None uses the global NumPy RNG like the reference.
    """

    def __init__(self, Support, RMS, slope=-2, smallest=0.1, biggest=None, seed=None):
        rect = sup.circum_rect(Support)
        if biggest is None:
            biggest = float(np.max(rect))
        k_max = 2.0 / smallest
        k_min = 2.0 / biggest
        res_x = int(round(k_max * rect[0] / 2)) + 1
        res_y = int(round(k_max * rect[1]))

        # The k-grid, band mask, and amplitudes are computed in float32 like
        # the reference (ART/ModuleDefects.py:81-92): the inner cutoff k_min
        # lands exactly ON grid nodes by construction (grid step 2/rect =
        # k_min when biggest=max(rect)), so the in/out decision for those
        # boundary modes depends on the rounding precision — a float64 grid
        # would include a different mode set than the reference and the maps
        # would diverge by whole (high-amplitude, k^slope) modes.
        kx = np.linspace(0.0, k_max, num=res_x, endpoint=False, dtype=np.float32)[None, :]
        ky = np.linspace(-k_max, k_max, num=res_y, endpoint=False, dtype=np.float32)[:, None]
        k_abs = np.sqrt(kx**2 + ky**2)
        in_band = (k_abs >= np.float32(k_min)) & (k_abs <= np.float32(k_max))
        amp = np.where(in_band, np.where(in_band, k_abs, np.float32(1.0)) ** slope, np.float32(0.0))

        rng = np.random.default_rng(seed) if seed is not None else np.random
        phases = rng.uniform(0.0, 2.0 * np.pi, size=k_abs.shape).astype(np.float32)
        spectrum = amp * np.exp(1j * phases)

        deformation = np.fft.irfft2(np.fft.ifftshift(spectrum, axes=0))
        rms_factor = RMS / np.std(deformation)
        deformation = deformation * rms_factor

        # spectral derivatives, with the reference's pi/2 scaling
        deriv_x = np.fft.irfft2(np.fft.ifftshift(spectrum * 1j * kx * rms_factor, axes=0)) * np.pi / 2
        ky_shifted = np.concatenate((ky[res_y // 2 :], ky[: res_y // 2]))
        deriv_y = np.fft.irfft2(np.fft.ifftshift(spectrum * 1j * rms_factor, axes=0) * ky_shifted) * np.pi / 2

        nx = (res_x - 1) * 2  # irfft2 output width
        self._height = deformation.T  # [ix, iy]
        self._slope_x = deriv_x.T
        self._slope_y = deriv_y.T
        self._x0, self._y0 = -rect[0] / 2, -rect[1] / 2
        self._dx = rect[0] / (nx - 1)
        self._dy = rect[1] / (res_y - 1)
        self.deformation = deformation
        self.rms = float(np.std(deformation))


Fourier = Fourrier  # correctly-spelled alias


class Zernike(Defect):
    """Zernike-sum height error (ART/ModuleDefects.py:149-181).

    ``coefficients`` maps Andersen (n, m) indices (m = 0..n) to coefficients
    in mm, evaluated over the support's circumscribed circle.
    """

    def __init__(self, Support, coefficients):
        self.coefficients = dict(coefficients)
        self.max_order = int(max(k[0] for k in self.coefficients))
        self.support = Support
        self.R = sup.circum_circle(Support)

    def offset_at(self, x, y):
        Z, _, _ = zernike_value_and_grad(np.atleast_1d(x / self.R), np.atleast_1d(y / self.R), self.max_order)
        h = sum(c * np.asarray(Z[k]) for k, c in self.coefficients.items())
        return h if np.ndim(x) else float(h[0])

    def slopes_at(self, x, y):
        _, DX, DY = zernike_value_and_grad(np.atleast_1d(x / self.R), np.atleast_1d(y / self.R), self.max_order)
        gx = sum(c * np.asarray(DX[k]) for k, c in self.coefficients.items()) / self.R
        gy = sum(c * np.asarray(DY[k]) for k, c in self.coefficients.items()) / self.R
        if np.ndim(x):
            return gx, gy
        return float(gx[0]), float(gy[0])

    def device_defect(self):
        return ZernikeDefect(coeffs=dict(self.coefficients), radius=float(self.R))

    def RMS(self):
        return float(np.sqrt(np.sum([c**2 for c in self.coefficients.values()])))

    def PV(self):
        return None
