"""Chain-table kernels K1-K4 and K8, their plain PyTorch versions, and the
host-side baking they share.

Counterpart of the JAX package's ``ops/pallas_trace.py``. Five CUDA kernels
replace its Pallas kernels:

* **K1** :func:`fused_source_trace` (``csrc/fused_trace.cu``,
  ``fused_source_trace_kernel``) replaces ``_kernel_source``: the Vogel
  source is synthesized from the ray index, traced through the whole chain
  in chained frames with folded masks, mapped back to the lab, and written
  as one bundle (incidence at the last element).
* **K2** :func:`fused_source_moments` (``fused_source_moments_kernel``)
  replaces ``_kernel_source_moments``: the same trace without incidence,
  the Gaussian weight ``exp(ln_edge * rr)``, and the 16 weighted detector
  moments of :data:`MOMENT_FIELDS`, reduced to one row per block.
* **K3** / **K4** :func:`streamed_trace` (``csrc/streamed_trace.cu``)
  replace ``_kernel`` and ``_kernel_fresh``: a bundle the user built is read
  ray by ray (K4, for a bundle fresh from a factory, reads p and d only) and
  traced through the lab-frame table (:func:`chain_table` with
  ``spec=None``).
* **K1i** :func:`prepare_fused_source_image` (``fused_source_image_kernel``)
  replaces the image loop of the JAX package's
  ``analysis/gigascan.py::_images_fused_pallas`` (K1 per chunk, the chunk's
  weights, matmul binning): one launch traces every chunk of a giga-ray
  image and adds each alive ray's weight and weight x delay at its pixel
  into two float64 images (:func:`image_rays_ref` per ray). Its one caller,
  ``analysis/gigascan.fused_source_images``, takes the plain version
  (:func:`fused_source_image_ref`) on the CPU.
* **K8** :func:`fused_source_stats` (``fused_source_stats_kernel``)
  replaces ``_kernel_source_stats``: K2's trace with the stats epilogue
  (:func:`stats_rows`, 7 weighted sums) at up to 128 distances, the
  per-distance baseline that K2's distance-independent moments replaced.

Each wrapper takes its plain version (``*_ref``) only for CPU tensors; for
CUDA tensors it launches the kernel or raises. Each counts its launches in
a plain int attribute ``launches``. On CUDA a wrapper is its ``prepare_*``
function (pack the records, raising on what the kernel does not take, and
allocate the outputs) followed by one launch, so a launch can be timed
alone.

Both kernels walk the chain as a runtime loop over a small element table
(:func:`pack_chain`): a chain change costs no rebuild. The table is built in
host float64 (:func:`chain_table`: ``compose_chain`` + the source frame +
``fold_premasks``) and rounded to float32 once, exactly like the constants
the Pallas kernels bake, so kernel and plain version see identical
constants.

Mirrors with surface defects go through every kernel, and
``ignore_defects`` is a field of the record. Zernike coefficients ride in
the chain record as one small table per mirror (:func:`pack_chain`, up to
:data:`MAX_ZERNIKE` tables of order :data:`MAX_ZERNIKE_ORDER`). A grid map
(``Fourrier``, ``MeasuredMap``) is packed once per device into float32 rows
{h, dh/dx, dh/dy, 0} on the card (:func:`grid_rows`), and the record holds
the rows' device pointer with the grid's origin, spacing and clamp bounds
(up to :data:`MAX_GRIDS` grids per chain).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .bundle import RayBundle
from .defects import GridDefect, ZernikeDefect, _coeff_items, derived, grid_to, indexed_device
from .trace import (
    MaskElement,
    TraceState,
    bake,
    chained_step,
    compose_chain,
    fold_premasks,
    fold_source,
    run_chain_chained,
    to_lab_c,
    trace,
)
from . import precision
from . import supports as sup
from . import surfaces as srf

#: per-call ray-index limit of the fused kernels: ray k's float index must be
#: exact in float32 (the spiral law of the JAX package)
MAX_RAYS_PER_CALL = 1 << 24
#: moment passes chunk the ray range at this size (same law as the JAX
#: package, so ray k gets the same spiral angle in both)
CHUNK = 1 << 23

# ---------------------------------------------------------------------------
# source synthesis
# ---------------------------------------------------------------------------

#: golden-ratio turn fraction 1 - 1/phi and its 2^8 / 2^16 multiples mod 1,
#: so frac(k * phi) splits into small float products over base-256 digits
_PHI_FRAC = 0.3819660112501051
_PHI_G = tuple(float(np.mod(_PHI_FRAC * 256.0**i, 1.0)) for i in range(3))

#: minimax sin(pi x) / cos(pi x) on [-1, 1] of the JAX package's source
#: law, evaluated in float32 Horner form (unfused in the kernel). It is part
#: of the law: it fixes ray k's direction to the last bit the JAX package
#: gives it, so the two packages' sources agree ray for ray.
_SIN_PI = (3.1415926362231827, -5.16771212974953, 2.550156988459466,
           -0.599230762176276, 0.08206264637303859, -0.007259921822795766,
           0.00039054382726498024)
_COS_PI = (0.999999999885547, -4.934802185862838, 4.058711817231867,
           -1.3352602860924583, 0.2353208253010271, -0.025785808393817295,
           0.0019043286626063097, -8.869084444024393e-05)

#: source kinds the fused engines synthesize (the kernels and their plain
#: versions alike, as the JAX package's fused engines do)
FUSED_SOURCE_KINDS = ("cone", "disk", "extended", "square")


class BakedSource(NamedTuple):
    """Description of an in-kernel source (canonical frame: beam along +z;
    ``rot``/``origin`` place it in the lab)."""

    kind: str       # 'cone' | 'disk' | 'extended' | 'square'
    rot: tuple      # 3x3 canonical->lab rotation
    origin: tuple   # lab-frame source point / disk centre
    radius: float   # tan(divergence) for 'cone'/'extended', beam radius [mm] for 'disk'
    pos_radius: float = 0.0
    n_each: int = 0
    n_sources: int = 0


def make_source_spec(kind: str, S, Axis, param: float, diameter: float = 0.0,
                     n_rays: int = 0) -> BakedSource:
    """BakedSource from reference-style source arguments: 'cone' is a point
    source at ``S`` with half-divergence ``param`` [rad]; 'disk' a plane-wave
    disk of radius ``param`` [mm]; 'extended' a Vogel grid of point sources
    over a disk of ``diameter``, each a ``param``-rad cone; 'square' a
    collimated square grid of side ``param`` [mm] (as in the JAX package)."""
    from .host_geometry import extended_source_counts, rotation_from_to

    axis = np.asarray(Axis, dtype=np.float64)
    axis = axis / np.linalg.norm(axis)
    rot = rotation_from_to(np.array([0.0, 0.0, 1.0]), axis)
    base = dict(rot=bake(rot), origin=bake(np.asarray(S, float)))
    if kind == "extended":
        n_sources, n_each = extended_source_counts(diameter, n_rays)
        return BakedSource(kind=kind, radius=float(np.tan(param)),
                           pos_radius=float(diameter) / 2.0,
                           n_each=n_each, n_sources=n_sources, **base)
    if kind == "square":
        n_side = max(int(np.sqrt(n_rays)), 1)
        return BakedSource(kind=kind, radius=float(param), n_each=n_side, **base)
    radius = float(np.tan(param)) if kind == "cone" else float(param)
    return BakedSource(kind=kind, radius=radius, **base)


def _sincos_pi(x):
    """(sin(pi x), cos(pi x)) of float32 ``x`` in [-1, 1] by the source
    law's polynomials."""
    x2 = x * x
    s = torch.full_like(x, _SIN_PI[-1])
    for c in _SIN_PI[-2::-1]:
        s = s * x2 + c
    co = torch.full_like(x, _COS_PI[-1])
    for c in _COS_PI[-2::-1]:
        co = co * x2 + c
    return s * x, co


def _scalar32(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _vogel_unit(k, n_total, phase, k_frac):
    """Unit-radius Vogel point ``(r cos theta, r sin theta)`` of int64 ray
    indices ``k`` in float32. The golden angle ``frac(k * phi)`` is summed
    over the base-256 digits of k with float32 products, and its sine and
    cosine come from the law's polynomials (:func:`_sincos_pi`), in the JAX
    package's order, so ray k lands where the JAX source puts it."""
    f32 = torch.float32
    a = (k >> 16).to(f32)
    b = ((k >> 8) & 255).to(f32)
    c = (k & 255).to(f32)
    tt = a * _PHI_G[2] + b * _PHI_G[1] + c * _PHI_G[0] + phase
    fr = tt - torch.floor(tt)
    s, co = _sincos_pi(2.0 * fr - 1.0)
    r = precision.sqrt(k.to(f32) * (1.0 / n_total) + k_frac)
    return -r * co, -r * s


def synth_source(kind, k, n_total, radius, phase, k_frac, *, pos_radius=0.0,
                 n_each=0, n_sources=0):
    """Canonical-frame source synthesis from int64 ray indices ``k`` (local
    to the call, < 2^24). Returns ``((px,py,pz), (dx,dy,dz), rr)`` in
    float32; ``rr`` is the Gaussian radial-law argument in [0, 1].

    'cone'/'disk': ray k of a Vogel spiral; ``phase``/``k_frac`` are the
    chunk's spiral phase [turns] and radius-law offset. 'extended': ray k is
    cone ray j of sub-source i, ``(i, j) = divmod(k, n_each)``; ``phase``/
    ``k_frac`` offset the sub-source (position) spiral, and every sub-source
    emits the same cone. 'square': ray k is grid point (row i, column j) =
    ``divmod(k, n_each)`` of a side-``radius`` grid, ``phase`` carries the
    chunk's integer row offset, and ``rr`` is corner-normalized."""
    if kind not in FUSED_SOURCE_KINDS:
        raise NotImplementedError(
            f"fused source synthesis covers {FUSED_SOURCE_KINDS}, not {kind!r}")
    device = k.device
    f32 = torch.float32
    phase = _scalar32(phase, device)
    k_frac = _scalar32(k_frac, device)
    if kind in ("extended", "square"):
        qi = torch.div(k, n_each, rounding_mode="floor")
        rj = k - qi * n_each
    if kind == "square":
        # np.linspace(-L/2, L/2, n_side) of the host source: step L/(n_side-1)
        inv_step = 1.0 / (n_each - 1) if n_each > 1 else 0.0
        x = ((qi.to(f32) + phase) * inv_step - 0.5) * radius
        y = (rj.to(f32) * inv_step - 0.5) * radius
        rr = (x * x + y * y) / (max(radius, 1e-300) ** 2 * 0.5)
        zeros = torch.zeros_like(x)
        return (x, y, zeros), (zeros, zeros, zeros + 1.0), rr
    if kind == "extended":
        sx, sy = _vogel_unit(qi, n_sources, phase, k_frac)
        sx, sy = sx * pos_radius, sy * pos_radius
        zero = _scalar32(0.0, device)
        cx, cy = _vogel_unit(rj, n_each, zero, zero)
    else:
        cx, cy = _vogel_unit(k, n_total, phase, k_frac)
    cx, cy = cx * radius, cy * radius
    rr = (cx * cx + cy * cy) / (max(radius, 1e-300) ** 2)
    zeros = torch.zeros_like(cx)
    if kind == "disk":
        return (cx, cy, zeros), (zeros, zeros, zeros + 1.0), rr
    inv = precision.rsqrt(cx * cx + cy * cy + 1.0)
    p = (sx, sy, zeros) if kind == "extended" else (zeros, zeros, zeros)
    return p, (cx * inv, cy * inv, inv), rr


def source_chunks(kind, n_rays, n_total, chunk=CHUNK, phase=0.0, k_frac=0.0, *,
                  n_each=0, n_sources=0):
    """[(n_local, phase, k_frac)] chunks covering a source (the JAX
    package's law). Spirals chunk at any ray offset ``off`` with ``phase =
    frac(off * phi)`` (float64, so the global golden angle is exact) and
    ``k_frac = off / n_total``; 'extended' chunks align to whole sub-sources
    and offset the sub-source spiral; 'square' chunks align to whole grid
    rows, the row offset riding in the phase slot."""
    if kind not in FUSED_SOURCE_KINDS:
        raise NotImplementedError(f"source chunking covers {FUSED_SOURCE_KINDS}, not {kind!r}")
    chunks = []
    if kind == "square":
        per = max(1, chunk // n_each) * n_each
        for off in range(0, n_rays, per):
            chunks.append((min(per, n_rays - off), float(phase) + off // n_each, 0.0))
        return chunks
    if kind == "extended":
        if n_each >= 1 << 22:
            raise ValueError(f"extended-source cones of {n_each} rays exceed the "
                             "chunk law's range (2^22)")
        per = max(1, chunk // n_each) * n_each
        for off in range(0, n_rays, per):
            i0 = off // n_each
            chunks.append((min(per, n_rays - off),
                           float(np.mod(float(phase) + i0 * _PHI_FRAC, 1.0)),
                           float(k_frac) + i0 / max(n_sources, 1)))
        return chunks
    off = 0
    while off < n_rays:
        n_local = min(chunk, n_rays - off)
        chunks.append((
            n_local,
            float(np.mod(float(phase) + off * _PHI_FRAC, 1.0)),
            float(k_frac) + off / n_total,
        ))
        off += n_local
    return chunks


def synth_spec(spec: BakedSource, k, n_total, phase=0.0, k_frac=0.0):
    """:func:`synth_source` of the source ``spec`` describes."""
    return synth_source(spec.kind, k, n_total, spec.radius, phase, k_frac,
                        pos_radius=spec.pos_radius, n_each=spec.n_each,
                        n_sources=spec.n_sources)


def _rotate_c(R, x, y, z):
    """``R @ (x, y, z)`` component-wise in the tensors' dtype (full float32
    products; no matmul backend is involved)."""
    return (R[0][0] * x + R[0][1] * y + R[0][2] * z,
            R[1][0] * x + R[1][1] * y + R[1][2] * z,
            R[2][0] * x + R[2][1] * y + R[2][2] * z)


def source_bundle(spec: BakedSource, n_rays: int, *, device, wavelength=50e-6,
                  phase=0.0, k_frac=0.0, n_total=None) -> RayBundle:
    """The float32 lab-frame bundle the fused kernels synthesize (for
    probes, tests, and the transmission denominator)."""
    k = torch.arange(n_rays, dtype=torch.int64, device=device)
    (px, py, pz), (dx, dy, dz), _rr = synth_spec(spec, k, n_total or n_rays, phase, k_frac)
    R = spec.rot
    o = spec.origin
    lx, ly, lz = _rotate_c(R, px, py, pz)
    ex, ey, ez = _rotate_c(R, dx, dy, dz)
    zeros = torch.zeros((n_rays,), dtype=torch.float32, device=device)
    return RayBundle(
        p=torch.stack([lx + o[0], ly + o[1], lz + o[2]], dim=-1),
        d=torch.stack([ex, ey, ez], dim=-1),
        opl=zeros, opl_c=zeros.clone(),
        alive=torch.ones((n_rays,), dtype=torch.bool, device=device),
        intensity=torch.ones((n_rays,), dtype=torch.float32, device=device),
        incidence=zeros.clone(),
        wavelength=_scalar32(wavelength, device),
    )


# ---------------------------------------------------------------------------
# the chain table shared by the kernels and their plain versions
# ---------------------------------------------------------------------------


class ChainTable(NamedTuple):
    """A chain in chained frames, with the source frame folded into the
    first map and non-terminal masks folded into premasks. Every number is
    a python float formed in float64 (rounded to float32 at use)."""

    elements: tuple   # folded elements (MirrorElement / MaskElement)
    maps: tuple       # per element: (M 3x3, b 3)
    final: tuple      # (R_K 3x3, pos_K 3): patch-relative frame K -> lab
    premasks: tuple   # per element: tuple of (support, M, b)


def chain_table(spec: BakedSource | None, elements) -> ChainTable:
    """Chain maps whose first map takes canonical source-frame coordinates
    straight into element 0's surface frame (the source rotation and origin
    folded in), then :func:`~.trace.fold_premasks`. With ``spec=None`` the
    first map takes lab coordinates into element 0's frame (the streamed
    kernels' table: the JAX package's ``_static_chain``). Host float64;
    elements may live on any device and dtype (their poses are read as
    float64; their defects are carried as they are)."""
    maps, final = compose_chain(elements)
    if spec is not None:
        maps = fold_source(maps, elements, spec.rot, spec.origin)
    folded, maps, premasks = fold_premasks(elements, maps)
    return ChainTable(
        elements=tuple(folded),
        maps=tuple((bake(Mm), bake(bb)) for Mm, bb in maps),
        final=(bake(final[0]), bake(final[1])),
        premasks=tuple(tuple((s, bake(Mm), bake(bb)) for s, Mm, bb in pre)
                       for pre in premasks),
    )


# --- kernel-side layout (mirrors the structs of csrc/trace_common.cuh) ----

MAX_ELEMENTS = 8
MAX_PREMASKS = 8
#: Zernike tables per chain (one per deformed mirror) and their highest order
MAX_ZERNIKE = 4
MAX_ZERNIKE_ORDER = 8
#: coefficients of a table: (n, m) at n (n + 1) / 2 + m, 0 <= m <= n <= 8
N_ZERNIKE_TERMS = (MAX_ZERNIKE_ORDER + 1) * (MAX_ZERNIKE_ORDER + 2) // 2
#: grid defect maps per chain
MAX_GRIDS = 4

_ELEM_KIND = {MaskElement: 0, srf.Plane: 1, srf.Toroid: 2, srf.Parabola: 3,
              srf.Sphere: 4, srf.Cylinder: 5, srf.Ellipsoid: 6}
_SRC_KIND = {"cone": 0, "disk": 1, "extended": 2, "square": 3}

_SUPPORT_T = np.dtype([("kind", "<i4"), ("p", "<f4", (6,))])
_PREMASK_T = np.dtype([("sup", _SUPPORT_T), ("M", "<f4", (9,)), ("b", "<f4", (3,))])
_ELEMENT_T = np.dtype([
    ("kind", "<i4"), ("pre_begin", "<i4"), ("pre_end", "<i4"),
    ("M", "<f4", (9,)), ("b", "<f4", (3,)), ("cen", "<f4", (3,)),
    ("s", "<f4", (8,)), ("sup", _SUPPORT_T),
])
_ZERNIKE_T = np.dtype([("max_order", "<i4"), ("inv_r", "<f4"), ("c", "<f4", (N_ZERNIKE_TERMS,))])
#: a grid map: its packed rows' device pointer, nodes, origin, spacing and
#: the clamp bounds of the fractional index, nx - 1.000001 as float32
_GRID_T = np.dtype([
    ("rows", "<u8"), ("nx", "<i4"), ("ny", "<i4"), ("x0", "<f4"), ("y0", "<f4"),
    ("dx", "<f4"), ("dy", "<f4"), ("fx_max", "<f4"), ("fy_max", "<f4"),
])
CHAIN_T = np.dtype([
    ("n_elements", "<i4"), ("n_premasks", "<i4"),
    ("el", _ELEMENT_T, (MAX_ELEMENTS,)), ("pre", _PREMASK_T, (MAX_PREMASKS,)),
    ("RK", "<f4", (9,)), ("posK", "<f4", (3,)),
    ("ignore_defects", "<i4"), ("n_zernike", "<i4"), ("zk_of", "<i4", (MAX_ELEMENTS,)),
    ("zk", _ZERNIKE_T, (MAX_ZERNIKE,)),
    # the grid maps (the pad aligns GridP's pointer to 8 bytes, as the C
    # struct does)
    ("n_grids", "<i4"), ("grid_begin", "<i4", (MAX_ELEMENTS,)),
    ("grid_end", "<i4", (MAX_ELEMENTS,)), ("_pad", "<i4"), ("grid", _GRID_T, (MAX_GRIDS,)),
])
SOURCE_T = np.dtype([
    ("kind", "<i4"), ("radius", "<f4"), ("inv_n_total", "<f4"), ("rad2", "<f4"),
    ("ln_edge", "<f4"), ("weighted", "<i4"), ("g", "<f4", (3,)),
    ("n_each", "<i4"), ("inv_n_each", "<f4"), ("pos_radius", "<f4"),
])
DETECTOR_T = np.dtype([
    ("c", "<f4", (3,)), ("n", "<f4", (3,)), ("e1", "<f4", (3,)), ("e2", "<f4", (3,)),
    ("opl_ref", "<f4"), ("inv_dn_chief", "<f4"), ("centre_distance", "<f4"),
])
IMAGE_T = np.dtype([
    ("c", "<f4", (3,)), ("n", "<f4", (3,)), ("rot", "<f4", (6,)), ("opl_ref", "<f4"),
    ("fs_per_mm", "<f4"), ("lo", "<f4", (2,)), ("scale", "<f4", (2,)), ("nx", "<i4"), ("ny", "<i4"),
])


def _pack_support(rec, s):
    """Support constants, each formed in float64 as ``supports.include``
    forms them from python floats."""
    p = [0.0] * 6
    if isinstance(s, sup.SupportRound):
        kind, p[0] = 0, s.radius * s.radius
    elif isinstance(s, sup.SupportRoundHole):
        kind = 1
        p[:4] = [s.radius * s.radius, s.radius_hole * s.radius_hole,
                 s.center_hole_x, s.center_hole_y]
    elif isinstance(s, sup.SupportRectangle):
        kind = 2
        p[:2] = [abs(s.dim_x) * 0.5, abs(s.dim_y) * 0.5]
    elif isinstance(s, sup.SupportRectangleHole):
        kind = 3
        p[:5] = [abs(s.dim_x) * 0.5, abs(s.dim_y) * 0.5,
                 s.radius_hole * s.radius_hole, s.center_hole_x, s.center_hole_y]
    elif isinstance(s, sup.SupportRectangleRectHole):
        kind = 4
        p[:6] = [abs(s.dim_x) * 0.5, abs(s.dim_y) * 0.5, abs(s.hole_x) * 0.5,
                 abs(s.hole_y) * 0.5, s.center_hole_x, s.center_hole_y]
    else:
        raise NotImplementedError(f"support {type(s).__name__} has no kernel form")
    rec["kind"] = kind
    rec["p"] = p


def _surface_constants(surface):
    """Per-surface float64 constants of the kernel (the layouts are listed
    at ``ElementP`` in csrc/trace_common.cuh)."""
    if isinstance(surface, srf.Plane):
        return []
    tol = srf._hit_tol_for(surface, torch.float32, srf.HIT_TOL)
    if isinstance(surface, srf.Toroid):
        R, r = surface.major_radius, surface.minor_radius
        return [R, r, R + r, 0.5 / (R + r), 0.5 / r, tol]
    ox, _ = srf.support_offset_xy(surface)
    if isinstance(surface, srf.Parabola):
        k = [surface.p, 2.0 * surface.p, surface.p * surface.p, 0.0]
    elif isinstance(surface, (srf.Sphere, srf.Cylinder)):
        k = [surface.radius, surface.radius**2, -1.0 / surface.radius, 0.0]
    elif isinstance(surface, srf.Ellipsoid):
        a, b = surface.a, surface.b
        k = [1.0 / (a * a), 1.0 / (b * b), a**2, b**2]
    else:
        raise NotImplementedError(f"surface {type(surface).__name__} has no CUDA kernel form")
    return k + [ox, tol]


def _pack_zernike(rec, defects):
    """One mirror's Zernike table: its defects' coefficients summed in
    float64 (they share one radius), rounded to float32 once."""
    radii = {float(d.radius) for d in defects}
    if len(radii) != 1:
        raise NotImplementedError(
            f"Zernike defects of one mirror with different radii {sorted(radii)} have no kernel "
            "form (one table per mirror)")
    c = np.zeros(N_ZERNIKE_TERMS, np.float64)
    max_order = 2
    for d in defects:
        for (n, m), value in _coeff_items(d.coeffs):
            n, m = int(n), int(m)
            if not 0 <= m <= n:
                raise ValueError(f"Zernike index (n, m) = ({n}, {m}) needs 0 <= m <= n")
            if n > MAX_ZERNIKE_ORDER:
                raise NotImplementedError(
                    f"Zernike order {n} exceeds the kernels' cap of {MAX_ZERNIKE_ORDER}")
            c[n * (n + 1) // 2 + m] += float(value)
            max_order = max(max_order, n)
    rec["max_order"] = max_order
    rec["inv_r"] = 1.0 / radii.pop()
    rec["c"] = c


def _node_rows(defect: GridDefect, device) -> torch.Tensor:
    """(nx ny, 4) float32 rows {h, dh/dx, dh/dy, 0} of a grid's maps on
    ``device``, node (ix, iy) at row ix ny + iy; counted in
    ``grid_rows.packed`` and ``grid_rows.packed_bytes``."""
    nx, ny = defect.height.shape
    rows = torch.zeros((nx * ny, 4), dtype=torch.float32, device=device)
    for k, m in enumerate((defect.height, defect.slope_x, defect.slope_y)):
        rows[:, k] = torch.as_tensor(m).to(device=device, dtype=torch.float32).reshape(-1)
    grid_rows.packed += 1
    grid_rows.packed_bytes += rows.numel() * rows.element_size()
    return rows


def grid_rows(defect: GridDefect, device) -> torch.Tensor:
    """The kernels' packed rows of a grid map on ``device``
    (:func:`_node_rows`), made and uploaded once per (map, device) and kept
    while the map lives (:func:`~.defects.derived`)."""
    device = indexed_device(device)
    return derived(defect, ("rows", str(device)), lambda: _node_rows(defect, device))


#: grid maps packed into rows (:func:`_node_rows`), on any device
grid_rows.packed = 0
#: the bytes of those rows, 16 a node
grid_rows.packed_bytes = 0


def launch_grids(elements, device) -> list:
    """The packed rows of every grid map of ``elements`` on ``device``, in
    record order (:func:`grid_rows`: cache hits after the first): a prepared
    launch holds them, so the pointers in its record stay valid."""
    return [grid_rows(d, device) for el in elements if not isinstance(el, MaskElement)
            for d in el.defects if isinstance(d, GridDefect)]


def _check_grid(defect: GridDefect):
    shapes = {tuple(m.shape) for m in (defect.height, defect.slope_x, defect.slope_y)}
    (shape,) = shapes if len(shapes) == 1 else (None,)
    if shape is None or len(shape) != 2 or min(shape) < 2 or shape[0] * shape[1] >= 1 << 31:
        raise ValueError(f"a grid defect needs three equal 2-D maps of at least 2 x 2 nodes "
                         f"(fewer than 2^31), got shapes {sorted(shapes)}")
    return shape


def _pack_grid(rec, defect: GridDefect, shape):
    """A grid's record but its rows pointer: nodes, origin and spacing
    rounded to float32 as the plain version rounds them (python floats
    against float32 coordinates), and the clamp bounds nx - 1.000001 and
    ny - 1.000001 rounded the same way."""
    nx, ny = shape
    rec["nx"], rec["ny"] = nx, ny
    rec["x0"], rec["y0"], rec["dx"], rec["dy"] = defect.x0, defect.y0, defect.dx, defect.dy
    rec["fx_max"], rec["fy_max"] = nx - 1.000001, ny - 1.000001


def pack_chain(table: ChainTable, ignore_defects: bool = True, device=None) -> np.ndarray:
    """The kernels' by-value chain record from a :class:`ChainTable`;
    raises NotImplementedError on a chain the kernels do not take (the
    plain versions take any chain): more than :data:`MAX_ELEMENTS` elements
    or :data:`MAX_PREMASKS` folded masks, a defect other than Zernike or a
    grid map, more than :data:`MAX_ZERNIKE` mirrors with Zernike defects, a
    Zernike order above :data:`MAX_ZERNIKE_ORDER`, or more than
    :data:`MAX_GRIDS` grid maps. Every check runs before anything is
    uploaded. With a CUDA ``device`` each grid's rows pointer is its packed
    rows' there (:func:`grid_rows`: packed once per device, alive while the
    map is); without one it stays 0 (a record to inspect, not to launch)."""
    n = len(table.elements)
    n_pre = sum(len(p) for p in table.premasks)
    if n > MAX_ELEMENTS or n_pre > MAX_PREMASKS:
        raise NotImplementedError(
            f"chain of {n} elements / {n_pre} folded masks exceeds the kernel "
            f"table ({MAX_ELEMENTS} / {MAX_PREMASKS})")
    rec = np.zeros((), dtype=CHAIN_T)
    rec["n_elements"] = n
    rec["n_premasks"] = n_pre
    rec["ignore_defects"] = bool(ignore_defects)
    rec["zk_of"] = -1
    k = n_grids = 0
    for i, (el, (M, b), pre) in enumerate(zip(table.elements, table.maps, table.premasks)):
        e = rec["el"][i]
        if isinstance(el, MaskElement):
            e["kind"] = _ELEM_KIND[MaskElement]
        else:
            others = sorted({type(d).__name__ for d in el.defects
                             if not isinstance(d, (ZernikeDefect, GridDefect))})
            if others:
                raise NotImplementedError(
                    f"defects {others} have no kernel form: the kernels take Zernike defects "
                    "and grid maps")
            zernike = [d for d in el.defects if isinstance(d, ZernikeDefect)]
            if zernike:
                z = int(rec["n_zernike"])
                if z == MAX_ZERNIKE:
                    raise NotImplementedError(
                        f"more than {MAX_ZERNIKE} mirrors with Zernike defects exceed the "
                        "kernels' Zernike tables")
                _pack_zernike(rec["zk"][z], zernike)
                rec["zk_of"][i] = z
                rec["n_zernike"] = z + 1
            rec["grid_begin"][i] = n_grids
            for d in el.defects:
                if isinstance(d, GridDefect):
                    if n_grids == MAX_GRIDS:
                        raise NotImplementedError(
                            f"more than {MAX_GRIDS} grid defect maps exceed the kernels' cap "
                            f"of MAX_GRIDS = {MAX_GRIDS} per chain")
                    _pack_grid(rec["grid"][n_grids], d, _check_grid(d))
                    n_grids += 1
            rec["grid_end"][i] = n_grids
            consts = _surface_constants(el.surface)
            e["kind"] = _ELEM_KIND[type(el.surface)]
            e["cen"] = bake(el.centre)
            e["s"][: len(consts)] = consts
        _pack_support(e["sup"], el.support)
        e["M"] = np.asarray(M).reshape(-1)
        e["b"] = b
        e["pre_begin"] = k
        for support, Mm, bm in pre:
            pm = rec["pre"][k]
            _pack_support(pm["sup"], support)
            pm["M"] = np.asarray(Mm).reshape(-1)
            pm["b"] = bm
            k += 1
        e["pre_end"] = k
    rec["RK"] = np.asarray(table.final[0]).reshape(-1)
    rec["posK"] = table.final[1]
    rec["n_grids"] = n_grids
    if device is not None:
        for g, rows in enumerate(launch_grids(table.elements, device)):
            rec["grid"][g]["rows"] = rows.data_ptr()
    return rec


def pack_source(spec: BakedSource, n_total: int, gaussian_edge=None) -> np.ndarray:
    """The kernels' by-value source record; every constant is formed in
    float64 as :func:`synth_source` forms it (layouts at ``SourceP`` in
    csrc/trace_common.cuh)."""
    if spec.kind not in _SRC_KIND:
        raise NotImplementedError(f"source kind {spec.kind!r} has no kernel form")
    rec = np.zeros((), dtype=SOURCE_T)
    rec["kind"] = _SRC_KIND[spec.kind]
    rec["radius"] = spec.radius
    rec["rad2"] = max(spec.radius, 1e-300) ** 2
    if spec.kind == "extended":
        rec["inv_n_total"] = 1.0 / spec.n_sources
        rec["n_each"] = spec.n_each
        rec["inv_n_each"] = 1.0 / spec.n_each
        rec["pos_radius"] = spec.pos_radius
    elif spec.kind == "square":
        rec["n_each"] = spec.n_each
        rec["inv_n_each"] = 1.0 / (spec.n_each - 1) if spec.n_each > 1 else 0.0
        rec["rad2"] = max(spec.radius, 1e-300) ** 2 * 0.5
    else:
        rec["inv_n_total"] = 1.0 / n_total
    rec["weighted"] = gaussian_edge is not None
    rec["ln_edge"] = float(np.log(gaussian_edge)) if gaussian_edge is not None else 0.0
    rec["g"] = _PHI_G
    return rec


# ---------------------------------------------------------------------------
# K1: fused source trace
# ---------------------------------------------------------------------------


def pack_detector(det: BakedDetector, centre_distance=0.0) -> np.ndarray:
    """The detector record of K2 and K8 (csrc/trace_common.cuh DetectorP);
    K8 reads the plane and ``opl_ref`` only."""
    rec = np.zeros((), dtype=DETECTOR_T)
    rec["c"], rec["n"], rec["e1"], rec["e2"] = det.centre, det.normal, det.e1, det.e2
    rec["opl_ref"], rec["inv_dn_chief"] = det.opl_ref, det.inv_dn_chief
    rec["centre_distance"] = centre_distance
    return rec


def _grids_on(elements, device) -> list:
    """The plain versions' element records: grid maps as float32 tensors on
    the rays' ``device``, as the kernels read them (copied once per device,
    :func:`~.defects.grid_to`); everything else as it is."""
    return [el if isinstance(el, MaskElement) or not el.defects else el._replace(
        defects=tuple(grid_to(d, device, torch.float32) if isinstance(d, GridDefect) else d
                      for d in el.defects)) for el in elements]


def _synth_traced_state(table: ChainTable, spec: BakedSource, n_local, n_total, phase,
                        k_frac, *, device, want_incidence, ignore_defects=True):
    """The plain versions' shared body: synthesize ``n_local`` source rays
    and run the chained trace with dead rays not frozen at mirrors (the
    state stays patch-relative to the last element). Returns (state, rr)."""
    k = torch.arange(n_local, dtype=torch.int64, device=device)
    (px, py, pz), (dx, dy, dz), rr = synth_spec(spec, k, n_total, phase, k_frac)
    zeros = torch.zeros_like(px)
    s = TraceState(px, py, pz, dx, dy, dz, zeros, zeros, torch.ones_like(px, dtype=torch.bool), zeros)
    last = len(table.elements) - 1
    elements = _grids_on(table.elements, device)
    for i, (el, (M, b), pre) in enumerate(zip(elements, table.maps, table.premasks)):
        s = chained_step(el, M, b, s, want_incidence=want_incidence and i == last,
                         ignore_defects=ignore_defects, premasks=pre, freeze_dead=False)
    return s, rr


class TraceOutputs(NamedTuple):
    """K1's outputs: p, d (N,3) float32; opl, opl_c, incidence (N,) float32;
    alive (N,) bool. Dead rays hold unspecified values."""

    p: torch.Tensor
    d: torch.Tensor
    opl: torch.Tensor
    opl_c: torch.Tensor
    alive: torch.Tensor
    incidence: torch.Tensor


def _check_trace_args(n_rays):
    if not 0 < n_rays < MAX_RAYS_PER_CALL:
        raise ValueError(
            f"fused trace takes 0 < n_rays < 2^24 per call (float-exact ray "
            f"index), got {n_rays}")


def fused_source_trace_ref(table: ChainTable, spec: BakedSource, n_rays: int, *,
                           device, phase=0.0, k_frac=0.0, n_total=None,
                           ignore_defects=True) -> TraceOutputs:
    """Plain PyTorch version of K1: the same float32 source, the chained
    trace with dead rays not frozen at mirrors, the final to-lab map."""
    _check_trace_args(n_rays)
    s, _rr = _synth_traced_state(table, spec, n_rays, n_total or n_rays, phase, k_frac,
                                 device=device, want_incidence=True,
                                 ignore_defects=ignore_defects)
    s = to_lab_c(table.final, s)
    return TraceOutputs(
        p=torch.stack([s.px, s.py, s.pz], dim=-1),
        d=torch.stack([s.dx, s.dy, s.dz], dim=-1),
        opl=s.opl, opl_c=s.opl_c, alive=s.alive, incidence=s.incidence,
    )


def _check_out(name, x, dtype, device):
    if x.device != device or x.dtype != dtype or not x.is_contiguous():
        raise ValueError(
            f"{name}: kernel needs a contiguous {dtype} tensor on {device}, got "
            f"{x.dtype} on {x.device} (contiguous={x.is_contiguous()})")


def _cuda_device(device, name):
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {device}")
    return device


def prepare_fused_source_chunks(table: ChainTable, spec: BakedSource, chunk: int, n_total: int, *,
                                device, ignore_defects=True):
    """K1's host work for a loop of launches over one source on a CUDA
    ``device``: pack the records once (raising on what the kernel does not
    take; the source record for ``n_total`` rays) and allocate one set of
    outputs of ``chunk`` rays. Returns ``(outputs, launch)``; each
    ``launch(n_local, phase, k_frac)`` runs the kernel once over ``n_local
    <= chunk`` rays of the chunk ``(phase, k_frac)`` (:func:`source_chunks`)
    into the first ``n_local`` rows of the outputs and counts it in
    ``fused_source_trace.launches``. Nothing synchronizes."""
    _check_trace_args(chunk)
    device = _cuda_device(device, "fused_source_trace")
    chain_rec = pack_chain(table, ignore_defects, device)
    grids = launch_grids(table.elements, device)
    src_rec = pack_source(spec, n_total)
    f32 = torch.float32
    outs = TraceOutputs(
        p=torch.empty((chunk, 3), dtype=f32, device=device),
        d=torch.empty((chunk, 3), dtype=f32, device=device),
        opl=torch.empty((chunk,), dtype=f32, device=device),
        opl_c=torch.empty((chunk,), dtype=f32, device=device),
        alive=torch.empty((chunk,), dtype=torch.bool, device=device),
        incidence=torch.empty((chunk,), dtype=f32, device=device),
    )
    for name, x in outs._asdict().items():
        _check_out(name, x, torch.bool if name == "alive" else f32, outs.p.device)
    from . import _cuda

    def launch(n_local, phase, k_frac):
        if not 0 < n_local <= chunk:
            raise ValueError(f"a launch takes 0 < n_local <= {chunk} rays, got {n_local}")
        with torch.cuda.device(outs.p.device):
            stream = torch.cuda.current_stream(outs.p.device).cuda_stream
            _cuda.launch_fused_source_trace(
                chain_rec, src_rec, n_local, float(phase), float(k_frac),
                outs.p, outs.d, outs.opl, outs.opl_c, outs.alive, outs.incidence, stream, grids)
        fused_source_trace.launches += 1

    return outs, launch


def prepare_fused_source_trace(table: ChainTable, spec: BakedSource, n_rays: int, *,
                               device, phase=0.0, k_frac=0.0, n_total=None, ignore_defects=True):
    """K1's host work for one launch (:func:`prepare_fused_source_chunks`
    with one chunk of ``n_rays``). Returns ``(outputs, launch)``; each
    ``launch()`` runs the kernel once into the outputs and counts it in
    ``fused_source_trace.launches``."""
    outs, launch_chunk = prepare_fused_source_chunks(table, spec, n_rays, n_total or n_rays,
                                                     device=device, ignore_defects=ignore_defects)
    return outs, lambda: launch_chunk(n_rays, phase, k_frac)


def fused_source_trace(table: ChainTable, spec: BakedSource, n_rays: int, *,
                       device, phase=0.0, k_frac=0.0, n_total=None,
                       ignore_defects=True) -> TraceOutputs:
    """K1 (replaces ``ops/pallas_trace.py::_kernel_source`` of the JAX
    package): trace ``n_rays`` rays of the in-kernel source through the
    chain. The outputs are allocated on ``device``; CPU outputs come from
    :func:`fused_source_trace_ref`, CUDA outputs from the kernel.
    ``ignore_defects`` as in :func:`~.trace.trace`."""
    if torch.device(device).type == "cpu":
        return fused_source_trace_ref(table, spec, n_rays, device=device, phase=phase,
                                      k_frac=k_frac, n_total=n_total,
                                      ignore_defects=ignore_defects)
    outs, launch = prepare_fused_source_trace(table, spec, n_rays, device=device, phase=phase,
                                              k_frac=k_frac, n_total=n_total,
                                              ignore_defects=ignore_defects)
    launch()
    return outs


fused_source_trace.launches = 0


# ---------------------------------------------------------------------------
# K1i: a giga-ray image, traced and binned in one launch
# ---------------------------------------------------------------------------


class ImageDetector(NamedTuple):
    """The plane an image is binned on: its lab centre and normal, rows 0-1
    of its rotation (lab -> plane, ``Detector._plane_rotation``), and the
    chief ray's optical path to it [mm] (the delays' reference). Host
    float64 numbers, rounded to float32 once (:func:`pack_image`)."""

    centre: tuple
    normal: tuple
    rot: tuple
    opl_ref: float


class ImageRecord(NamedTuple):
    """K1i's optional per-ray record of the chunks ``first .. first +
    n_chunks - 1``: ray k of chunk ``first + c`` at ``c * chunk + k`` of
    ``flat`` (int32: its pixel, -1 dead or outside the window), ``w`` (its
    weight) and ``delay`` (float32 [fs]; 0 where ``flat`` is -1)."""

    first: int
    n_chunks: int
    flat: torch.Tensor
    w: torch.Tensor
    delay: torch.Tensor


def image_record(first: int, n_chunks: int, chunk: int, *, device) -> ImageRecord:
    """An empty :class:`ImageRecord` of ``n_chunks`` chunks of ``chunk`` rays."""
    n = n_chunks * chunk
    f32 = torch.float32
    return ImageRecord(first, n_chunks, torch.full((n,), -1, dtype=torch.int32, device=device),
                       torch.zeros((n,), dtype=f32, device=device),
                       torch.zeros((n,), dtype=f32, device=device))


def pack_image(det: ImageDetector, window, bins) -> np.ndarray:
    """K1i's image record (``ImageP`` in csrc/fused_trace.cu): the plane and
    the chief ray's path rounded to float32, fs per mm, and the window
    ``(lo, hi)`` as histogram._bin_indices forms it in float32: its origin
    and ``bins / (hi - lo)`` per axis, which PyTorch takes as the rounded
    reciprocal times ``bins``."""
    from .precision import LIGHT_SPEED_MM_S

    f32 = np.float32
    lo, hi = (np.asarray(v, np.float64).astype(f32) for v in window)
    rec = np.zeros((), dtype=IMAGE_T)
    rec["c"], rec["n"] = det.centre, det.normal
    rec["rot"] = np.asarray(det.rot, np.float64)[:2].reshape(6)
    rec["opl_ref"] = det.opl_ref
    rec["fs_per_mm"] = 1e15 / LIGHT_SPEED_MM_S
    rec["lo"] = lo
    rec["scale"] = [(f32(1.0) / (h - l)) * f32(int(n)) for n, l, h in zip(bins, lo, hi)]
    rec["nx"], rec["ny"] = int(bins[0]), int(bins[1])
    return rec


def source_weights(spec: BakedSource, n_local, n_total, phase, k_frac, gaussian_edge, device):
    """A chunk's Gaussian weights ``exp(ln(edge) rr)`` from the source's
    radial law in float32 (1.0 without an edge), as the kernels synthesize
    them."""
    if gaussian_edge is None:
        return torch.ones((n_local,), dtype=torch.float32, device=device)
    k = torch.arange(n_local, dtype=torch.int64, device=device)
    _p, _d, rr = synth_spec(spec, k, n_total, phase, k_frac)
    return torch.exp(float(np.log(gaussian_edge)) * rr)


def image_rays_ref(out: TraceOutputs, weights, image_rec):
    """K1i's per-ray epilogue in plain PyTorch: for K1's outputs ``out`` of a
    chunk and their ``weights``, each ray's ``(flat, w, delay)`` of
    :class:`ImageRecord`. The detector point and leg t
    (stats.detector_points_3d: its dot products summed left to right), the
    in-plane coordinates (stats.plane_coords), the delay [fs] against the
    record's chief-ray path after the Kahan step of t
    (``((s - opl_ref) - c) * fs_per_mm``) and the pixel
    (histogram._bin_indices: truncation, clamp, window ``0 <= f <= n``),
    every operation rounded on its own in float32, with the record's
    float32 constants. A ray counts where it is alive and in the window."""
    from .geometry import kahan_add

    c, n, R = (tuple(float(v) for v in image_rec[f]) for f in ("c", "n", "rot"))
    lo, scale = (tuple(float(v) for v in image_rec[f]) for f in ("lo", "scale"))
    nx, ny = int(image_rec["nx"]), int(image_rec["ny"])
    p, d = out.p, out.d
    num = n[0] * (c[0] - p[:, 0]) + n[1] * (c[1] - p[:, 1]) + n[2] * (c[2] - p[:, 2])
    den = d[:, 0] * n[0] + d[:, 1] * n[1] + d[:, 2] * n[2]
    t = num / torch.where(torch.abs(den) > 1e-30, den, float("inf"))
    r = [(p[:, j] + t * d[:, j]) - c[j] for j in range(3)]
    x = r[0] * R[0] + r[1] * R[1] + r[2] * R[2]
    y = r[0] * R[3] + r[1] * R[4] + r[2] * R[5]
    s, sc = kahan_add(out.opl, out.opl_c, t)
    delay = ((s - float(image_rec["opl_ref"])) - sc) * float(image_rec["fs_per_mm"])
    fx = (x - lo[0]) * scale[0]
    fy = (y - lo[1]) * scale[1]
    ix = torch.clamp(fx.to(torch.int32), 0, nx - 1)
    iy = torch.clamp(fy.to(torch.int32), 0, ny - 1)
    counted = out.alive & (fx >= 0) & (fx <= nx) & (fy >= 0) & (fy <= ny)
    flat = torch.where(counted, ix * ny + iy, -1).to(torch.int32)
    return flat, weights, torch.where(counted, delay, 0.0)


def bin_image_rays(images, flat, w, delay):
    """Add rays ``(flat, w, delay)`` (:func:`image_rays_ref`) into the flat
    float64 weight and weight x delay images, in place: ``w`` and the
    float32 product ``w * delay`` at each counted ray's pixel."""
    m = flat >= 0
    idx = flat[m].to(torch.int64)
    w = w[m]
    images[0].index_add_(0, idx, w.to(torch.float64))
    images[1].index_add_(0, idx, (w * delay[m]).to(torch.float64))


def _check_image_args(chunks, n_total, bins, covers_spiral=True):
    """The chunks' sizes; the chunks must cover the whole spiral of
    ``n_total`` rays, or with ``covers_spiral=False`` a part of it."""
    sizes = _check_chunks(chunks)
    covered = sum(sizes) == n_total if covers_spiral else 0 < sum(sizes) <= n_total
    if not (covered and 0 < n_total < 1 << 31):
        raise ValueError(f"an image takes {'all' if covers_spiral else 'at most'} the spiral's "
                         f"0 < n_total < 2^31 rays in its chunks, got {n_total} in chunks of {sizes}")
    if not all(0 < int(b) for b in bins) or int(bins[0]) * int(bins[1]) >= 1 << 31:
        raise ValueError(f"image bins must be positive with fewer than 2^31 pixels, got {bins}")
    return sizes


def fused_source_image_ref(table: ChainTable, spec: BakedSource, chunks, n_total: int,
                           det: ImageDetector, window, bins, images, *, device,
                           gaussian_edge=None, ignore_defects=True, record=None,
                           trace_chunk=None, covers_spiral=True):
    """Plain PyTorch version of K1i, the chunk loop: per chunk the plain
    trace (:func:`fused_source_trace_ref`; or ``trace_chunk(n_local,
    phase, k_frac)``, another chunk tracer's outputs: analysis/gigascan's
    K1 loop), its weights (:func:`source_weights`) and
    :func:`image_rays_ref`, added into ``images`` (:func:`bin_image_rays`)
    and, for the chunks of ``record``, written into it. ``covers_spiral=False``
    lets the chunks cover a part of the spiral (a shard's)."""
    _check_image_args(chunks, n_total, bins, covers_spiral)
    rec = pack_image(det, window, bins)
    chunk = chunks[0][0]
    for i, (n_local, phase, k_frac) in enumerate(chunks):
        if trace_chunk is None:
            out = fused_source_trace_ref(table, spec, n_local, device=device, phase=phase,
                                         k_frac=k_frac, n_total=n_total,
                                         ignore_defects=ignore_defects)
        else:
            out = trace_chunk(n_local, phase, k_frac)
        w = source_weights(spec, n_local, n_total, phase, k_frac, gaussian_edge, device)
        rays = image_rays_ref(out, w, rec)
        bin_image_rays(images, *rays)
        if record is not None and 0 <= i - record.first < record.n_chunks:
            at = (i - record.first) * chunk
            for dst, src in zip(record[2:], rays):
                dst[at:at + n_local] = src


def prepare_fused_source_image(table: ChainTable, spec: BakedSource, chunks, n_total: int,
                               det: ImageDetector, window, bins, *, device, gaussian_edge=None,
                               ignore_defects=True, record: ImageRecord | None = None,
                               covers_spiral=True):
    """K1i's host work for a CUDA ``device``: pack the chain, source and
    image records (raising on what the kernel does not take) and the chunk
    table; with ``covers_spiral=False`` the chunks may cover a part of the
    spiral of ``n_total`` rays (a shard's,
    ``parallel/mesh.source_images_sharded``). Returns
    ``launch(images)``: one launch over every chunk, adding
    into the flat float64 ``images`` (weight, weight x delay; ``bins[0] *
    bins[1]`` each, on the device) and writing ``record``'s chunks when one
    is given; it counts the launch in
    ``prepare_fused_source_image.launches``. The atomics' order varies, so
    the images are reproducible to float64 rounding, not bit for bit.
    Nothing synchronizes. The CPU's form is :func:`fused_source_image_ref`."""
    sizes = _check_image_args(chunks, n_total, bins, covers_spiral)
    device = _cuda_device(device, "fused_source_image")
    chain_rec = pack_chain(table, ignore_defects, device)
    grids = launch_grids(table.elements, device)
    src_rec = pack_source(spec, n_total, gaussian_edge)
    image_rec = pack_image(det, window, bins)
    from . import _cuda

    params = torch.tensor([[c[1], c[2]] for c in chunks], dtype=torch.float32, device=device)
    grid = ray_grid(sizes, _cuda.source_image_rays_per_block())
    n_pixels = int(bins[0]) * int(bins[1])
    if record is not None:
        for name, x, dtype in (("record flat", record.flat, torch.int32),
                               ("record w", record.w, torch.float32),
                               ("record delay", record.delay, torch.float32)):
            _check_out(name, x, dtype, params.device)
            if x.numel() != record.n_chunks * sizes[0]:
                raise ValueError(f"{name}: {record.n_chunks} chunks of {sizes[0]} rays, got {x.numel()}")

    def launch(images):
        for name, img in zip(("weight image", "delay image"), images):
            _check_out(name, img, torch.float64, params.device)
            if img.numel() != n_pixels:
                raise ValueError(f"{name}: {n_pixels} pixels, got {img.numel()}")
        with torch.cuda.device(params.device):
            stream = torch.cuda.current_stream(params.device).cuda_stream
            _cuda.launch_fused_source_image(chain_rec, src_rec, image_rec, sum(sizes), sizes[0], grid,
                                            params, images, record, stream, grids)
        prepare_fused_source_image.launches += 1

    return launch


prepare_fused_source_image.launches = 0


# ---------------------------------------------------------------------------
# K3 / K4: streamed trace of a bundle the user built
# ---------------------------------------------------------------------------


def _is_fresh(bundle: RayBundle) -> bool:
    """True if the bundle is straight out of a source factory: every ray
    alive, zero opl, compensation and incidence. The reductions run where
    the bundle lives; one bool crosses to the host."""
    fresh = (bundle.alive.all() & ~(bundle.opl != 0).any() & ~(bundle.opl_c != 0).any()
             & ~(bundle.incidence != 0).any())
    return bool(fresh)


def _check_streamed_args(n_rays):
    if not 0 < n_rays or 3 * n_rays >= 1 << 31:
        raise ValueError(f"streamed trace takes 0 < n_rays < 2^31 / 3 per call, got {n_rays}")


def streamed_trace_ref(table: ChainTable, bundle: RayBundle, *, fresh: bool,
                       device, ignore_defects=True) -> TraceOutputs:
    """Plain PyTorch version of K3 (``fresh=False``: every field of the
    bundle is read) and K4 (``fresh=True``: p and d only; opl, opl_c and
    incidence start at 0, every ray alive): the float32 chained trace of the
    lab-frame ``table`` (:func:`chain_table` with ``spec=None``) with dead
    rays not frozen at mirrors, and the final to-lab map."""
    _check_streamed_args(bundle.n_rays)
    f32 = torch.float32
    p = bundle.p.to(device=device, dtype=f32)
    d = bundle.d.to(device=device, dtype=f32)
    if fresh:
        zeros = torch.zeros((bundle.n_rays,), dtype=f32, device=p.device)
        opl, opl_c, inc = zeros, zeros, zeros
        alive = torch.ones((bundle.n_rays,), dtype=torch.bool, device=p.device)
    else:
        opl, opl_c, inc = (x.to(device=device, dtype=f32)
                           for x in (bundle.opl, bundle.opl_c, bundle.incidence))
        alive = bundle.alive.to(device=device)
    s = TraceState(p[:, 0], p[:, 1], p[:, 2], d[:, 0], d[:, 1], d[:, 2], opl, opl_c, alive, inc)
    s = run_chain_chained(s, _grids_on(table.elements, p.device), table.maps, table.final,
                          ignore_defects, table.premasks, freeze_dead=False)
    return TraceOutputs(
        p=torch.stack([s.px, s.py, s.pz], dim=-1),
        d=torch.stack([s.dx, s.dy, s.dz], dim=-1),
        opl=s.opl, opl_c=s.opl_c, alive=s.alive, incidence=s.incidence,
    )


def prepare_streamed_trace(table: ChainTable, bundle: RayBundle, *, fresh: bool, device,
                           ignore_defects=True):
    """K3/K4's host work for a CUDA ``device``: pack the chain record
    (raising on what the kernels do not take, before anything is copied or
    allocated), move the inputs the kernel reads to the device as contiguous
    float32 (alive as bytes), and allocate the outputs. Returns ``(outputs,
    launch)``; each ``launch()`` runs K4 (``fresh``) or K3 once and counts it
    in ``streamed_trace.fresh_launches`` or ``streamed_trace.launches``."""
    n_rays = bundle.n_rays
    _check_streamed_args(n_rays)
    device = _cuda_device(device, "streamed_trace")
    chain_rec = pack_chain(table, ignore_defects, device)
    grids = launch_grids(table.elements, device)
    f32 = torch.float32

    def move(x, dtype=f32):
        return x.to(device=device, dtype=dtype).contiguous()

    inputs = [move(bundle.p), move(bundle.d)]
    if fresh:
        inputs += [None] * 4
    else:
        inputs += [move(bundle.opl), move(bundle.opl_c), move(bundle.alive, torch.bool),
                   move(bundle.incidence)]
    device = inputs[0].device
    for name, x, shape, dtype in zip(("p", "d", "opl", "opl_c", "alive", "incidence"), inputs,
                                     ((n_rays, 3), (n_rays, 3)) + ((n_rays,),) * 4,
                                     (f32, f32, f32, f32, torch.bool, f32)):
        if x is not None:
            _check_out(name, x, dtype, device)
            if tuple(x.shape) != shape:
                raise ValueError(f"{name}: kernel needs shape {shape}, got {tuple(x.shape)}")
    outs = TraceOutputs(
        p=torch.empty((n_rays, 3), dtype=f32, device=device),
        d=torch.empty((n_rays, 3), dtype=f32, device=device),
        opl=torch.empty((n_rays,), dtype=f32, device=device),
        opl_c=torch.empty((n_rays,), dtype=f32, device=device),
        alive=torch.empty((n_rays,), dtype=torch.bool, device=device),
        incidence=torch.empty((n_rays,), dtype=f32, device=device),
    )
    from . import _cuda

    def launch():
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            _cuda.launch_streamed_trace(chain_rec, n_rays, fresh, inputs, outs, stream, grids)
        if fresh:
            streamed_trace.fresh_launches += 1
        else:
            streamed_trace.launches += 1

    return outs, launch


def streamed_trace(table: ChainTable, bundle: RayBundle, *, device,
                   fresh: bool | None = None, ignore_defects=True) -> TraceOutputs:
    """K3 and K4 (replace ``ops/pallas_trace.py::_kernel`` and
    ``_kernel_fresh`` of the JAX package): trace a bundle the user built
    through the lab-frame ``table``. ``fresh=None`` decides by
    :func:`_is_fresh`; a fresh bundle takes K4, which reads p and d only.
    The outputs are allocated on ``device``; CPU outputs come from
    :func:`streamed_trace_ref`, CUDA outputs from the kernels."""
    if fresh is None:
        fresh = _is_fresh(bundle)
    if torch.device(device).type == "cpu":
        return streamed_trace_ref(table, bundle, fresh=fresh, device=device,
                                  ignore_defects=ignore_defects)
    outs, launch = prepare_streamed_trace(table, bundle, fresh=fresh, device=device,
                                          ignore_defects=ignore_defects)
    launch()
    return outs


#: K3 launches
streamed_trace.launches = 0
#: K4 launches
streamed_trace.fresh_launches = 0


# ---------------------------------------------------------------------------
# detector baking and moments
# ---------------------------------------------------------------------------


class BakedDetector(NamedTuple):
    """Detector plane in the LAST element's patch-relative frame: ``centre``
    and ``normal`` the plane, ``e1``/``e2`` the in-plane axes, ``opl_ref`` a
    chief-ray reference path and ``inv_dn_chief`` the chief ray's 1/(d.n),
    both subtracted in-kernel so float32 delay moments stay fs-scale.
    ``distances`` (shifts along -normal, shiftByDistance convention) and
    their ``delay_offsets`` are the stats epilogue's (:func:`stats_rows`)."""

    centre: tuple
    normal: tuple
    e1: tuple
    e2: tuple
    opl_ref: float
    inv_dn_chief: float = 0.0
    distances: tuple = (0.0,)
    delay_offsets: tuple = (0.0,)


def bake_detector(elements, det_centre, det_normal, det_rot, opl_ref=0.0,
                  inv_dn_chief=0.0, distances=(0.0,), delay_offsets=None) -> BakedDetector:
    """Express a lab-frame detector plane in the final element's
    patch-relative frame (p_lab = R_K^T x_rel + pos_K). ``delay_offsets``
    default to 0 at every distance."""
    _, final = compose_chain(elements)
    R_K, pos_K = final
    c_rel = R_K @ (np.asarray(det_centre, np.float64) - pos_K)
    n_rel = R_K @ np.asarray(det_normal, np.float64)
    rot = np.asarray(det_rot, np.float64)
    if delay_offsets is None:
        delay_offsets = (0.0,) * len(distances)
    return BakedDetector(
        centre=bake(c_rel), normal=bake(n_rel), e1=bake(R_K @ rot[0]),
        e2=bake(R_K @ rot[1]), opl_ref=float(opl_ref),
        inv_dn_chief=float(inv_dn_chief),
        distances=tuple(float(d) for d in distances),
        delay_offsets=tuple(float(v) for v in delay_offsets),
    )


#: per-distance weighted sums of the stats epilogue, in output order
STATS_FIELDS = ("w", "wx", "wy", "wxx", "wyy", "wd", "wdd")


def stats_rows(s: TraceState, det: BakedDetector, weights):
    """(7, J) float64 sums of :data:`STATS_FIELDS` at each of the detector's
    J distances (the JAX package's ``stats_rows``): per ray in the state's
    dtype, dead rays selected out of every product (their values are
    unspecified, and a tangent of theirs may be infinite), summed in
    float64. Detector entries may be tensors, so tangents reach them."""
    c, n = det.centre, det.normal
    e1, e2 = det.e1, det.e2
    dn = s.dx * n[0] + s.dy * n[1] + s.dz * n[2]
    inv_dn = 1.0 / torch.where(torch.abs(dn) > 1e-30, dn, float("inf"))
    b0 = (c[0] - s.px) * n[0] + (c[1] - s.py) * n[1] + (c[2] - s.pz) * n[2]
    t0 = b0 * inv_dn
    a1 = (s.px - c[0]) * e1[0] + (s.py - c[1]) * e1[1] + (s.pz - c[2]) * e1[2]
    a2 = (s.px - c[0]) * e2[0] + (s.py - c[1]) * e2[1] + (s.pz - c[2]) * e2[2]
    g1 = s.dx * e1[0] + s.dy * e1[1] + s.dz * e1[2]
    g2 = s.dx * e2[0] + s.dy * e2[1] + s.dz * e2[2]
    # (opl - ref) is a same-magnitude subtraction (exact), then the Kahan
    # compensation applies at full significance
    dsmall = (s.opl - det.opl_ref) - s.opl_c
    w = torch.broadcast_to(weights, s.px.shape)
    cols = []
    for dist, offset in zip(det.distances, det.delay_offsets):
        tj = t0 - dist * inv_dn
        xj = a1 + tj * g1
        yj = a2 + tj * g2
        dj = (dsmall + tj) - offset
        vals = torch.stack([w, w * xj, w * yj, w * xj * xj, w * yj * yj, w * dj, w * dj * dj])
        cols.append(torch.where(s.alive, vals, 0.0).double().sum(dim=1))
    return torch.stack(cols, dim=1)


#: distance-independent weighted moments, in output order: per ray, with
#: x0/y0/d0 the impact coordinates and delay at the expansion point and
#: cx/cy/cd their distance-coefficients, every per-distance weighted sum the
#: statistics need is an exact quadratic in the scan distance
MOMENT_FIELDS = (
    "w", "x0", "y0", "d0", "cx", "cy", "cd",
    "x0x0", "y0y0", "d0d0", "x0cx", "y0cy", "d0cd",
    "cxcx", "cycy", "cdcd",
)


def moment_rows(s: TraceState, det: BakedDetector, weights, centre_distance):
    """(16, N) per-ray moment terms in the state's dtype, exactly 0 for dead
    rays (selected, not multiplied: dead-ray values are unspecified).
    ``centre_distance`` is a 0-dim tensor of the state's dtype (the kernel's
    runtime float32 scalar)."""
    c, n = det.centre, det.normal
    e1, e2 = det.e1, det.e2
    dn = s.dx * n[0] + s.dy * n[1] + s.dz * n[2]
    inv_dn = 1.0 / torch.where(torch.abs(dn) > 1e-30, dn, float("inf"))
    b0 = (c[0] - s.px) * n[0] + (c[1] - s.py) * n[1] + (c[2] - s.pz) * n[2]
    t0 = (b0 - centre_distance) * inv_dn
    a1 = (s.px - c[0]) * e1[0] + (s.py - c[1]) * e1[1] + (s.pz - c[2]) * e1[2]
    a2 = (s.px - c[0]) * e2[0] + (s.py - c[1]) * e2[1] + (s.pz - c[2]) * e2[2]
    g1 = s.dx * e1[0] + s.dy * e1[1] + s.dz * e1[2]
    g2 = s.dx * e2[0] + s.dy * e2[1] + s.dz * e2[2]
    x0 = a1 + t0 * g1
    y0 = a2 + t0 * g2
    cx = inv_dn * g1
    cy = inv_dn * g2
    cd = inv_dn - det.inv_dn_chief
    d0 = (s.opl - det.opl_ref) - s.opl_c + t0 + centre_distance * det.inv_dn_chief
    w = weights
    vals = torch.stack([
        w, w * x0, w * y0, w * d0, w * cx, w * cy, w * cd,
        w * x0 * x0, w * y0 * y0, w * d0 * d0, w * x0 * cx, w * y0 * cy, w * d0 * cd,
        w * cx * cx, w * cy * cy, w * cd * cd,
    ])
    return torch.where(s.alive, vals, 0.0)


def moments_to_distance_sums(moments, distances, centre_distance=0.0):
    """Per-distance weighted sums (w, wx, wy, wxx, wyy, wd, wdd) from the 16
    moment sums, in float64, for any number of distances (shifts along
    -normal, relative to the same expansion point the moments used)."""
    m = {name: np.float64(v) for name, v in zip(MOMENT_FIELDS, np.asarray(moments, np.float64))}
    d = np.asarray(distances, np.float64) - float(centre_distance)
    return {
        "w": np.broadcast_to(m["w"], d.shape).copy(),
        "wx": m["x0"] - d * m["cx"],
        "wy": m["y0"] - d * m["cy"],
        "wxx": m["x0x0"] - 2.0 * d * m["x0cx"] + d * d * m["cxcx"],
        "wyy": m["y0y0"] - 2.0 * d * m["y0cy"] + d * d * m["cycy"],
        "wd": m["d0"] - d * m["cd"],
        "wdd": m["d0d0"] - 2.0 * d * m["d0cd"] + d * d * m["cdcd"],
    }


def sums_to_stats(sums, opl_ref, distances):
    """Per-distance statistics from weighted sums: means, clamped variances,
    fs conversion."""
    from .precision import LIGHT_SPEED_MM_S

    w = np.maximum(sums["w"], 1e-30)
    mean_x, mean_y = sums["wx"] / w, sums["wy"] / w
    var_x = np.maximum(sums["wxx"] / w - mean_x**2, 0.0)
    var_y = np.maximum(sums["wyy"] / w - mean_y**2, 0.0)
    mean_d = sums["wd"] / w
    var_d = np.maximum(sums["wdd"] / w - mean_d**2, 0.0)
    to_fs = 1e15 / LIGHT_SPEED_MM_S
    return {
        "spot_sd": np.sqrt(var_x + var_y),
        "duration_sd": np.sqrt(var_d) * to_fs,
        "mean_x": mean_x,
        "mean_y": mean_y,
        "mean_delay": mean_d * to_fs,
        "sum_w": sums["w"],
        "opl_ref": opl_ref,
        "distances": np.asarray(distances, np.float64),
    }


def elements_to(elements, device, dtype):
    """Element records with their pose tensors (and grid defect maps, copied
    once per device and dtype: :func:`~.defects.grid_to`) on ``device`` in
    ``dtype``."""
    def move(x):
        return torch.as_tensor(x).to(device=device, dtype=dtype)

    def defect(d):
        return grid_to(d, device, dtype) if isinstance(d, GridDefect) else d

    out = []
    for el in elements:
        if isinstance(el, MaskElement):
            out.append(el._replace(rot=move(el.rot), position=move(el.position)))
        else:
            out.append(el._replace(rot=move(el.rot), position=move(el.position),
                                   centre=move(el.centre),
                                   defects=tuple(defect(d) for d in el.defects)))
    return out


def probe_trace(spec: BakedSource, elements, n_probe: int, *, device, dtype) -> RayBundle:
    """Trace ``n_probe`` rays of the fused source on the streamed plain
    trace in ``dtype`` (the chief-ray and optimizer probes)."""
    probe = source_bundle(spec, n_probe, device=device).to(dtype=dtype)
    return trace(probe, elements_to(elements, device, dtype), keep_history=False)


def chief_ray_refs(spec: BakedSource, elements, det_centre, det_normal,
                   opl_ref: float | None = None, *, device, dtype):
    """(opl_ref, inv_dn_chief): the optical path of a surviving probe ray to
    the detector plane and its 1/(d.n). Retries with more probe rays before
    failing loudly (no probe ray surviving means meaningless statistics)."""
    for n_probe in (8, 256, 8192):
        pout = probe_trace(spec, elements, n_probe, device=device, dtype=dtype)
        alive = pout.alive.cpu().numpy()
        if alive.any():
            break
    else:
        raise RuntimeError(
            "chief-ray probe: no ray survives the chain (tried up to 8192 probe "
            "rays) — the detector statistics would be meaningless. Check the "
            "chain alignment/supports.")
    k0 = int(np.argmax(alive))
    p = pout.p[k0].double().cpu().numpy()
    d = pout.d[k0].double().cpu().numpy()
    n = np.asarray(det_normal, np.float64)
    dn = float(d @ n)
    if abs(dn) < 1e-30:
        raise RuntimeError("chief-ray probe: surviving ray is parallel to the detector plane")
    if opl_ref is None:
        t_leg = float((np.asarray(det_centre, np.float64) - p) @ n) / dn
        opl_ref = float(pout.opl[k0].double() - pout.opl_c[k0].double()) + t_leg
    return float(opl_ref), float(1.0 / dn)


# ---------------------------------------------------------------------------
# K2: fused source moments
# ---------------------------------------------------------------------------


def fused_source_moments_ref(table: ChainTable, spec: BakedSource, det: BakedDetector,
                             chunks, n_total: int, *, device, gaussian_edge=None,
                             centre_distance=0.0, ignore_defects=True) -> np.ndarray:
    """Plain PyTorch version of K2: per chunk, the float32 source and chained
    trace (no incidence, dead rays not frozen at mirrors), the Gaussian
    weight and the 16 moment terms, summed in float64. Returns (16,)."""
    total = torch.zeros(len(MOMENT_FIELDS), dtype=torch.float64, device=device)
    cdist = _scalar32(centre_distance, device)
    for n_local, phase_i, k_frac_i in chunks:
        s, rr = _synth_traced_state(table, spec, n_local, n_total, phase_i, k_frac_i,
                                    device=device, want_incidence=False,
                                    ignore_defects=ignore_defects)
        if gaussian_edge is None:
            w = torch.ones_like(rr)
        else:
            w = torch.exp(float(np.log(gaussian_edge)) * rr)
        total += moment_rows(s, det, w, cdist).double().sum(dim=1)
    return total.cpu().numpy()


def _check_chunks(chunks):
    sizes = [c[0] for c in chunks]
    chunk = sizes[0]
    if any(n != chunk for n in sizes[:-1]) or sizes[-1] > chunk or chunk >= MAX_RAYS_PER_CALL:
        raise ValueError(f"chunks must be equal-sized below 2^24 except the last, got {sizes}")
    return sizes


def ray_grid(sizes, rays_per_block: int):
    """``(blocks_per_chunk, n_blocks)`` of a grid sized to the rays of the
    chunks ``sizes`` (all equal but the last, :func:`_check_chunks`): every
    full chunk takes ``blocks_per_chunk`` blocks of ``rays_per_block`` rays,
    the last chunk only as many as its rays fill, so no block starts
    without rays (K2 and K5-K8, each at its own rays per block; block b
    serves chunk b // blocks_per_chunk, csrc/trace_common.cuh
    ``block_rays``)."""
    bpc = -(-sizes[0] // rays_per_block)
    return bpc, (len(sizes) - 1) * bpc + -(-sizes[-1] // rays_per_block)


def prepare_fused_source_moments(table: ChainTable, spec: BakedSource, det: BakedDetector,
                                 chunks, n_total: int, *, device, gaussian_edge=None,
                                 centre_distance=0.0, ignore_defects=True):
    """K2's host work for a CUDA ``device``: pack the records (raising on
    what the kernel does not take) and allocate the per-block rows. Returns
    ``(rows, launch)``; each ``launch()`` runs the kernel once, writing one
    float64 row of the 16 moments per block into ``rows``, and counts it in
    ``fused_source_moments.launches``."""
    sizes = _check_chunks(chunks)
    device = _cuda_device(device, "fused_source_moments")
    chain_rec = pack_chain(table, ignore_defects, device)
    grids = launch_grids(table.elements, device)
    src_rec = pack_source(spec, n_total, gaussian_edge)
    det_rec = pack_detector(det, centre_distance)
    from . import _cuda

    params = torch.tensor([[c[1], c[2]] for c in chunks], dtype=torch.float32, device=device)
    n_rays, chunk = sum(sizes), sizes[0]
    grid = ray_grid(sizes, _cuda.source_moments_rays_per_block())
    rows = torch.empty((grid[1], len(MOMENT_FIELDS)), dtype=torch.float64, device=params.device)
    _check_out("chunk params", params, torch.float32, params.device)
    _check_out("moment rows", rows, torch.float64, params.device)

    def launch():
        with torch.cuda.device(params.device):
            stream = torch.cuda.current_stream(params.device).cuda_stream
            _cuda.launch_fused_source_moments(
                chain_rec, src_rec, det_rec, n_rays, chunk, grid, params, rows, stream, grids)
        fused_source_moments.launches += 1

    return rows, launch


def fused_source_moments(table: ChainTable, spec: BakedSource, det: BakedDetector,
                         chunks, n_total: int, *, device, gaussian_edge=None,
                         centre_distance=0.0, ignore_defects=True) -> np.ndarray:
    """K2 (replaces ``ops/pallas_trace.py::_kernel_source_moments`` of the
    JAX package): the 16 weighted detector moments of every chunk's rays,
    summed in float64. All chunks of equal nominal size go in one launch on
    a grid sized to the rays (:func:`ray_grid`). CPU runs
    :func:`fused_source_moments_ref`."""
    _check_chunks(chunks)
    if torch.device(device).type == "cpu":
        return fused_source_moments_ref(table, spec, det, chunks, n_total, device=device,
                                        gaussian_edge=gaussian_edge,
                                        centre_distance=centre_distance,
                                        ignore_defects=ignore_defects)
    rows, launch = prepare_fused_source_moments(
        table, spec, det, chunks, n_total, device=device, gaussian_edge=gaussian_edge,
        centre_distance=centre_distance, ignore_defects=ignore_defects)
    launch()
    return rows.sum(dim=0).cpu().numpy()


fused_source_moments.launches = 0


# ---------------------------------------------------------------------------
# K8: fused source stats (the per-distance baseline K2 replaced)
# ---------------------------------------------------------------------------

#: most distances one stats pass takes (one lane each in the JAX kernel)
MAX_STATS_DISTANCES = 128


def _check_stats_distances(det: BakedDetector):
    n = len(det.distances)
    if not 0 < n <= MAX_STATS_DISTANCES or len(det.delay_offsets) != n:
        raise ValueError(f"stats passes take 1..{MAX_STATS_DISTANCES} distances with one delay "
                         f"offset each, got {n} and {len(det.delay_offsets)}")
    return n


def fused_source_stats_ref(table: ChainTable, spec: BakedSource, det: BakedDetector,
                           chunks, n_total: int, *, device, gaussian_edge=None,
                           ignore_defects=True) -> np.ndarray:
    """Plain PyTorch version of K8, following the JAX package's
    ``_kernel_source_stats``: per chunk, K2's float32 source and chained
    trace (folded premasks, dead rays not frozen at mirrors), the Gaussian
    weight, and :func:`stats_rows` at every distance of ``det``, summed in
    float64. Returns (7, J) in :data:`STATS_FIELDS` order."""
    n_dist = _check_stats_distances(det)
    total = torch.zeros((len(STATS_FIELDS), n_dist), dtype=torch.float64, device=device)
    for n_local, phase_i, k_frac_i in chunks:
        s, rr = _synth_traced_state(table, spec, n_local, n_total, phase_i, k_frac_i,
                                    device=device, want_incidence=False,
                                    ignore_defects=ignore_defects)
        if gaussian_edge is None:
            w = torch.ones_like(rr)
        else:
            w = torch.exp(float(np.log(gaussian_edge)) * rr)
        total += stats_rows(s, det, w)
    return total.cpu().numpy()


def prepare_fused_source_stats(table: ChainTable, spec: BakedSource, det: BakedDetector,
                               chunks, n_total: int, *, device, gaussian_edge=None,
                               ignore_defects=True):
    """K8's host work for a CUDA ``device``: pack the records (raising on
    what the kernel does not take), copy the (distance, delay offset) pairs
    and the chunk offsets to the device, and allocate the per-block rows.
    Returns ``(rows, launch)``; each ``launch()`` runs the kernel once over
    every chunk, tracing each ray once for all J distances, writing per
    block one float64 row of 7 sums per distance into ``rows`` (blocks, J,
    7), and counts it in ``fused_source_stats.launches``."""
    sizes = _check_chunks(chunks)
    n_dist = _check_stats_distances(det)
    device = _cuda_device(device, "fused_source_stats")
    chain_rec = pack_chain(table, ignore_defects, device)
    grids = launch_grids(table.elements, device)
    src_rec = pack_source(spec, n_total, gaussian_edge)
    det_rec = pack_detector(det)
    from . import _cuda

    params = torch.tensor([[c[1], c[2]] for c in chunks], dtype=torch.float32, device=device)
    dists = torch.tensor(list(zip(det.distances, det.delay_offsets)), dtype=torch.float32,
                         device=params.device)
    n_rays, chunk = sum(sizes), sizes[0]
    grid = ray_grid(sizes, _cuda.source_stats_rays_per_block())
    rows = torch.empty((grid[1], n_dist, len(STATS_FIELDS)), dtype=torch.float64,
                       device=params.device)
    for name, x, dtype in (("chunk params", params, torch.float32),
                           ("distances", dists, torch.float32), ("stats rows", rows, torch.float64)):
        _check_out(name, x, dtype, params.device)

    def launch():
        with torch.cuda.device(params.device):
            stream = torch.cuda.current_stream(params.device).cuda_stream
            _cuda.launch_fused_source_stats(chain_rec, src_rec, det_rec, n_rays, chunk, grid,
                                            params, dists, n_dist, rows, stream, grids)
        fused_source_stats.launches += 1

    return rows, launch


def stats_from_rows(rows) -> np.ndarray:
    """(7, J) float64 sums from K8's per-block rows (blocks, J, 7)."""
    return rows.sum(dim=0).t().cpu().numpy()


def fused_source_stats(table: ChainTable, spec: BakedSource, det: BakedDetector, chunks,
                       n_total: int, *, device, gaussian_edge=None,
                       ignore_defects=True) -> np.ndarray:
    """K8 (replaces ``ops/pallas_trace.py::_kernel_source_stats`` of the
    JAX package): the 7 weighted sums of :data:`STATS_FIELDS` at each of the
    detector's J <= 128 distances over every chunk's rays, summed in
    float64; (7, J). All chunks of equal nominal size go in one launch on a
    grid sized to the rays (:func:`ray_grid`), and each ray is traced once
    whatever J is. CPU runs :func:`fused_source_stats_ref`."""
    _check_chunks(chunks)
    if torch.device(device).type == "cpu":
        return fused_source_stats_ref(table, spec, det, chunks, n_total, device=device,
                                      gaussian_edge=gaussian_edge,
                                      ignore_defects=ignore_defects)
    rows, launch = prepare_fused_source_stats(table, spec, det, chunks, n_total, device=device,
                                              gaussian_edge=gaussian_edge,
                                              ignore_defects=ignore_defects)
    launch()
    return stats_from_rows(rows)


fused_source_stats.launches = 0


def source_detector_moments(spec: BakedSource, elements, n_rays: int, det_centre,
                            det_normal, det_rot, *, device, dtype=None,
                            opl_ref: float | None = None, gaussian_edge=None,
                            phase=0.0, k_frac=0.0, n_total: int | None = None,
                            ignore_defects: bool = True, centre_distance: float = 0.0):
    """The 16 moments (:data:`MOMENT_FIELDS`, float64) of the traced source
    on the detector plane, about the expansion point ``centre_distance``
    [mm, shiftByDistance convention, quantized to float32 and returned].
    Chunked at :data:`CHUNK` rays. ``dtype`` is the probe traces' dtype
    (default: the trace dtype). Returns ``{"moments", "opl_ref",
    "inv_dn_chief", "centre_distance"}``."""
    from .precision import default_dtype

    dtype = dtype or default_dtype()
    centre_distance = float(np.float32(centre_distance))
    opl_ref, inv_dn_chief = chief_ray_refs(spec, elements, det_centre, det_normal,
                                           opl_ref, device=device, dtype=dtype)
    det = bake_detector(elements, det_centre, det_normal, det_rot,
                        opl_ref=opl_ref, inv_dn_chief=inv_dn_chief)
    n_total = n_total or n_rays
    if n_rays <= CHUNK:
        chunks = [(n_rays, phase, k_frac)]
    else:
        chunks = source_chunks(spec.kind, n_rays, n_total, CHUNK, phase, k_frac,
                               n_each=spec.n_each, n_sources=spec.n_sources)
    moments = fused_source_moments(chain_table(spec, elements), spec, det, chunks,
                                   n_total, device=device, gaussian_edge=gaussian_edge,
                                   centre_distance=centre_distance,
                                   ignore_defects=ignore_defects)
    return {"moments": moments, "opl_ref": opl_ref, "inv_dn_chief": inv_dn_chief,
            "centre_distance": centre_distance}
