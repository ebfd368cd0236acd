"""Surface-defect evaluation inside the trace: height offsets and slopes
(counterpart of the JAX package's ``ops/defects.py``).

The reference wraps mirrors in a DeformedMirror whose intersection is shifted
along the ray by the local height error, and whose normal is composed from the
base normal and per-defect slope normals (ART/ModuleMirror.py:945-981,
ART/ModuleGeometry.py:394-407). Host-side construction (PSD synthesis,
measured-map ingestion) lives in
:mod:`attosecondraytracing_tpu_torch.models.defects`; here are the batched
lookups that run inside the trace, on tensors.

Two representations:

* :class:`GridDefect` — height + precomputed slope maps on a regular grid,
  bilinearly interpolated (the reference's RegularGridInterpolator usage,
  ART/ModuleDefects.py:34-146); the maps are tensors on the trace's device;
* :class:`ZernikeDefect` — coefficients (python floats) evaluated exactly
  through the Andersen recurrence (ART/ModuleDefects.py:149-181).

The CUDA kernels take both (``csrc/trace_common.cuh``: ``zernike_sums`` on
a table of coefficients, ``grid_sums`` on a grid's maps packed as float32
rows, ``ops/fused_trace.grid_rows``). A grid's maps are never changed once
built, and the identity of its height map names it: :func:`derived` keeps
what is made from a map (a copy on a device, the kernels' packed rows) once
per map for as long as the map lives, so a map is uploaded once per device.

Note: the reference's Fourrier/MeasuredMap ``get_normal`` returns
[+dX, +dY, ...] while its Zernike returns [-dX, -dY, 1]
(ART/ModuleDefects.py:52-58 vs :156-166). For a height map h(x, y) the correct
'up' normal is [-dh/dx, -dh/dy, 1]; we use that consistently for all defect
types (divergence noted per SURVEY.md §7 "implement the intended behavior").
"""

from __future__ import annotations

import weakref
from typing import NamedTuple

import torch

from .zernike import zernike_value_and_grad


class GridDefect(NamedTuple):
    """Regular-grid height/slope maps, indexed [ix, iy]."""

    height: torch.Tensor   # (Nx, Ny)
    slope_x: torch.Tensor  # (Nx, Ny) dh/dx
    slope_y: torch.Tensor  # (Nx, Ny) dh/dy
    x0: float              # grid origin
    y0: float
    dx: float              # grid spacing
    dy: float


class ZernikeDefect(NamedTuple):
    """Zernike-sum height error over the circumscribed circle of radius R.

    ``coeffs`` maps the Andersen (n, m) index to a coefficient [mm] (a dict,
    or a tuple of ((n, m), value) pairs)."""

    coeffs: dict
    radius: float  # circumscribed-circle radius used to normalize


def _coeff_items(coeffs):
    return coeffs.items() if isinstance(coeffs, dict) else coeffs


def _bilinear_multi(grids, x0, y0, dx, dy, x, y):
    """Clamped bilinear interpolation of several SAME-SHAPE grids at physical
    (x, y), sharing one index/weight computation. The grids are packed as
    the columns of one flattened (nx*ny, K) view, so each corner is one
    indexed read of a K-wide row. Returns a list of (N,) values, one per
    grid."""
    nx, ny = grids[0].shape
    fx = (x - x0) / dx
    fy = (y - y0) / dy
    fx = torch.clamp(fx, 0.0, nx - 1.000001)
    fy = torch.clamp(fy, 0.0, ny - 1.000001)
    ix = torch.clamp(torch.floor(fx).to(torch.int64), 0, nx - 2)
    iy = torch.clamp(torch.floor(fy).to(torch.int64), 0, ny - 2)
    wx = fx - ix
    wy = fy - iy
    packed = torch.stack([g.reshape(-1) for g in grids], dim=-1)
    base = ix * ny + iy
    c00 = packed[base]
    c10 = packed[base + ny]
    c01 = packed[base + 1]
    c11 = packed[base + ny + 1]
    w00 = ((1 - wx) * (1 - wy))[..., None]
    w10 = (wx * (1 - wy))[..., None]
    w01 = ((1 - wx) * wy)[..., None]
    w11 = (wx * wy)[..., None]
    # the maps are read in the coordinates' dtype, as the kernels read their
    # float32 rows (the kernels' plain versions hold float64 host maps)
    c00, c10, c01, c11 = (c.to(x.dtype) for c in (c00, c10, c01, c11))
    vals = c00 * w00 + c10 * w10 + c01 * w01 + c11 * w11
    return [vals[..., k] for k in range(len(grids))]


def _bilinear_multi_cells(grids, x0, y0, dx, dy, x, y):
    """:func:`_bilinear_multi` with each grid's derivatives along x and y,
    as the gradient kernel K6 takes them on the primal
    (``csrc/trace_common.cuh``, ``grid_cell``): d/dx = ((c10 - c00) (1 -
    wy) + (c11 - c01) wy) / dx, d/dy = ((c01 - c00) (1 - wx) + (c11 - c10)
    wx) / dy, zero where the fractional index is clamped (the clamp's zero
    tangent; the cell is the value's). Its plain twin for the tests, which
    nothing on the kernels' path calls. Returns a list of (value, d/dx,
    d/dy), one per grid."""
    nx, ny = grids[0].shape
    ux = (x - x0) / dx
    uy = (y - y0) / dy
    fx = torch.clamp(ux, 0.0, nx - 1.000001)
    fy = torch.clamp(uy, 0.0, ny - 1.000001)
    ix = torch.clamp(torch.floor(fx).to(torch.int64), 0, nx - 2)
    iy = torch.clamp(torch.floor(fy).to(torch.int64), 0, ny - 2)
    wx = fx - ix
    wy = fy - iy
    sx = ((ux > 0) & (ux < nx - 1.000001)).to(x.dtype) / dx
    sy = ((uy > 0) & (uy < ny - 1.000001)).to(x.dtype) / dy
    base = ix * ny + iy
    out = []
    for g in grids:
        flat = g.reshape(-1)
        c00, c10, c01, c11 = (flat[i].to(x.dtype) for i in (base, base + ny, base + 1, base + ny + 1))
        value = c00 * ((1 - wx) * (1 - wy)) + c10 * (wx * (1 - wy)) + c01 * ((1 - wx) * wy) + c11 * (wx * wy)
        out.append((value, ((c10 - c00) * (1 - wy) + (c11 - c01) * wy) * sx,
                    ((c01 - c00) * (1 - wx) + (c11 - c10) * wx) * sy))
    return out


#: what is made from a grid's maps, per height map: id(height) -> {key: value}
_DERIVED: dict = {}
#: the key under which a grid's entry lists the ids of its copies' maps
_COPIES = "copies"


def _forget(key) -> None:
    """Drop a collected map's entry and its copies' (which the entry held)."""
    per = _DERIVED.pop(key, None) or {}
    for copy_key in per.get(_COPIES, ()):
        _DERIVED.pop(copy_key, None)


def derived(defect: GridDefect, key, make):
    """``make()`` for the grid ``defect`` and ``key``, made once while its
    height map lives (the map's identity names the grid; the entry goes
    when the map is collected). ``make``'s value must not hold the map. A
    copy made by :func:`grid_to` shares its grid's entry, so what is made
    from the copy (the kernels' rows) is made once per grid, whichever of
    its copies an element record holds."""
    h = defect.height
    per = _DERIVED.get(id(h))
    if per is None:
        per = _DERIVED[id(h)] = {}
        weakref.finalize(h, _forget, id(h))
    if key not in per:
        per[key] = make()
    return per[key]


def indexed_device(device) -> torch.device:
    """``device`` with its index: "cuda" names the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def grid_to(defect: GridDefect, device, dtype) -> GridDefect:
    """The grid with its maps as tensors on ``device`` in ``dtype``: itself
    when they are, else a copy made once per (map, device, dtype), counted
    in ``grid_to.copies`` and its three maps' bytes in
    ``grid_to.copied_bytes``."""
    device = indexed_device(device)
    maps = (defect.height, defect.slope_x, defect.slope_y)
    if all(torch.is_tensor(m) and m.device == device and m.dtype == dtype for m in maps):
        return defect

    def make():  # copies, so the entry never holds the map it is keyed by
        h, gx, gy = (torch.as_tensor(m).to(device=device, dtype=dtype, copy=True) for m in maps)
        grid_to.copies += 1
        grid_to.copied_bytes += sum(m.numel() * m.element_size() for m in (h, gx, gy))
        return defect._replace(height=h, slope_x=gx, slope_y=gy)

    copy = derived(defect, ("maps", str(device), dtype), make)
    per = _DERIVED[id(defect.height)]
    if id(copy.height) not in _DERIVED:
        # the copy lives in the grid's entry, so its map's id stays its own
        # until the grid is collected and the entry dropped
        _DERIVED[id(copy.height)] = per
        per.setdefault(_COPIES, []).append(id(copy.height))
    return copy


#: copies of a grid's maps made by :func:`grid_to`, on any device
grid_to.copies = 0
#: the bytes of those copies
grid_to.copied_bytes = 0


def _bilinear(grid, x0, y0, dx, dy, x, y):
    """Clamped bilinear interpolation of one grid at physical (x, y)."""
    return _bilinear_multi((grid,), x0, y0, dx, dy, x, y)[0]


def defect_offset(defect, x, y):
    """Height error h(x, y) [mm] at local support coordinates, batched."""
    if isinstance(defect, GridDefect):
        return _bilinear(defect.height, defect.x0, defect.y0, defect.dx, defect.dy, x, y)
    if isinstance(defect, ZernikeDefect):
        items = tuple(_coeff_items(defect.coeffs))
        xn = x / defect.radius
        yn = y / defect.radius
        max_order = max(k[0] for k, _ in items)
        Z, _, _ = zernike_value_and_grad(xn, yn, max_order)
        h = torch.zeros_like(xn)
        for k, c in items:
            h = h + c * Z[k]
        return h
    raise TypeError(f"unknown defect type {type(defect)}")


def defect_slopes(defect, x, y):
    """(dh/dx, dh/dy) at local support coordinates, batched."""
    if isinstance(defect, GridDefect):
        gx, gy = _bilinear_multi((defect.slope_x, defect.slope_y),
                                 defect.x0, defect.y0, defect.dx, defect.dy, x, y)
        return gx, gy
    if isinstance(defect, ZernikeDefect):
        items = tuple(_coeff_items(defect.coeffs))
        xn = x / defect.radius
        yn = y / defect.radius
        max_order = max(k[0] for k, _ in items)
        _, DX, DY = zernike_value_and_grad(xn, yn, max_order)
        gx = torch.zeros_like(xn)
        gy = torch.zeros_like(xn)
        for k, c in items:
            gx = gx + c * DX[k]
            gy = gy + c * DY[k]
        return gx / defect.radius, gy / defect.radius
    raise TypeError(f"unknown defect type {type(defect)}")
