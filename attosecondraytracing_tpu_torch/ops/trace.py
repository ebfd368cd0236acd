"""The ray-tracing engine in plain PyTorch (counterpart of the JAX
package's ``ops/trace.py``).

One batched step per optical element over the whole (N,)-ray bundle:
element frames as 3x3 rotations, rays that miss marked dead via ``alive``,
and the optical path accumulated with Kahan compensation.

Two forms:

* :func:`trace` — lab-frame steps (:func:`mirror_step_c`,
  :func:`mask_step_c`) with optional history; dead rays keep their state.
* :func:`run_chain_chained` — chained frames (:func:`compose_chain`: one
  composed affine per element, patch-relative handoff) with non-terminal
  masks folded into alive-predicates (:func:`fold_premasks`). This is the
  arithmetic of the fused CUDA kernels, and their plain version runs it.

Element poses are tensors on the trace's device and dtype; surface and
support parameters are python floats, so derived constants are formed in
float64 and rounded to the ray dtype once.

A mirror with surface defects (``MirrorElement.defects``: ``ops/defects``
records) is hit where its *deformed* surface lies: the base hit is shifted
along the ray by the local height error, and ``ignore_defects`` gates only
the defect slopes composed into the reflecting normal (the reference's
DeformedMirror, ART/ModuleMirror.py:925-981).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from . import supports as sup
from . import surfaces as srf
from .bundle import RayBundle
from .defects import defect_offset, defect_slopes
from .geometry import kahan_add
from .precision import T_EPS, rsqrt


class MirrorElement(NamedTuple):
    """One placed mirror: ``rot`` the lab->optic rotation (3,3), ``position``
    the element centre in the lab, ``centre`` the support-centre point on the
    surface in optic coordinates, ``defects`` a tuple of
    :class:`~.defects.ZernikeDefect` / :class:`~.defects.GridDefect` (grid
    maps on the trace's device), evaluated at support coordinates (the hit
    point minus ``centre``)."""

    rot: torch.Tensor
    position: torch.Tensor
    centre: torch.Tensor
    surface: NamedTuple
    support: NamedTuple
    defects: tuple = ()


class MaskElement(NamedTuple):
    """One placed mask (blocks rays on its support, transmits the rest)."""

    rot: torch.Tensor
    position: torch.Tensor
    support: NamedTuple


class TraceState(NamedTuple):
    """Component-form ray state: every field is an identically-shaped tensor."""

    px: torch.Tensor
    py: torch.Tensor
    pz: torch.Tensor
    dx: torch.Tensor
    dy: torch.Tensor
    dz: torch.Tensor
    opl: torch.Tensor
    opl_c: torch.Tensor
    alive: torch.Tensor  # bool
    incidence: torch.Tensor


def _acos(x):
    return torch.acos(torch.clamp(x, -1.0, 1.0))


def bundle_to_state(b: RayBundle) -> TraceState:
    return TraceState(b.p[..., 0], b.p[..., 1], b.p[..., 2],
                      b.d[..., 0], b.d[..., 1], b.d[..., 2],
                      b.opl, b.opl_c, b.alive, b.incidence)


def state_to_bundle(s: TraceState, template: RayBundle) -> RayBundle:
    return RayBundle(
        p=torch.stack([s.px, s.py, s.pz], dim=-1),
        d=torch.stack([s.dx, s.dy, s.dz], dim=-1),
        opl=s.opl,
        opl_c=s.opl_c,
        alive=s.alive,
        intensity=template.intensity,
        incidence=s.incidence,
        wavelength=template.wavelength,
    )


def _to_local_c(element, s: TraceState):
    R = element.rot
    pos = element.position
    rx, ry, rz = s.px - pos[0], s.py - pos[1], s.pz - pos[2]
    qx = R[0][0] * rx + R[0][1] * ry + R[0][2] * rz
    qy = R[1][0] * rx + R[1][1] * ry + R[1][2] * rz
    qz = R[2][0] * rx + R[2][1] * ry + R[2][2] * rz
    ux = R[0][0] * s.dx + R[0][1] * s.dy + R[0][2] * s.dz
    uy = R[1][0] * s.dx + R[1][1] * s.dy + R[1][2] * s.dz
    uz = R[2][0] * s.dx + R[2][1] * s.dy + R[2][2] * s.dz
    if isinstance(element, MirrorElement):
        cen = element.centre
        qx, qy, qz = qx + cen[0], qy + cen[1], qz + cen[2]
    return (qx, qy, qz), (ux, uy, uz)


def _to_lab_c(element, q, u):
    R = element.rot
    pos = element.position
    qx, qy, qz = q
    ux, uy, uz = u
    if isinstance(element, MirrorElement):
        cen = element.centre
        qx, qy, qz = qx - cen[0], qy - cen[1], qz - cen[2]
    px = R[0][0] * qx + R[1][0] * qy + R[2][0] * qz + pos[0]
    py = R[0][1] * qx + R[1][1] * qy + R[2][1] * qz + pos[1]
    pz = R[0][2] * qx + R[1][2] * qy + R[2][2] * qz + pos[2]
    dx = R[0][0] * ux + R[1][0] * uy + R[2][0] * uz
    dy = R[0][1] * ux + R[1][1] * uy + R[2][1] * uz
    dz = R[0][2] * ux + R[1][2] * uy + R[2][2] * uz
    return (px, py, pz), (dx, dy, dz)


def _deformed_hit(element, q, u, t, cen):
    """The hit on a deformed mirror: the base hit ``t`` shifted along the
    ray by the local height error h / clip(-u.n0, 1e-6) (n0 the base normal
    at the base hit), and the base surface's normal at the shifted point
    (ART/ModuleMirror.py:969-980). Returns ``(t, (x, y, z), (nx, ny, nz))``."""
    (qx, qy, qz), (ux, uy, uz) = q, u
    x0, y0, z0 = qx + t * ux, qy + t * uy, qz + t * uz
    n0x, n0y, n0z = srf.normal_c(element.surface, x0, y0, z0)
    h = torch.zeros_like(t)
    for defect in element.defects:
        h = h + defect_offset(defect, x0 - cen[0], y0 - cen[1])
    cos_alpha = torch.clamp(-(ux * n0x + uy * n0y + uz * n0z), min=1e-6)
    t = t - h / cos_alpha
    x, y, z = qx + t * ux, qy + t * uy, qz + t * uz
    return t, (x, y, z), srf.normal_c(element.surface, x, y, z)


def _defect_normal(element, x, y, n, cen):
    """The base normal ``n`` composed with every defect's slopes at (x, y)
    (ART/ModuleGeometry.py:394-407), renormalized."""
    nx, ny, nz = n
    gx = -nx / nz
    gy = -ny / nz
    for defect in element.defects:
        dgx, dgy = defect_slopes(defect, x - cen[0], y - cen[1])
        gx = gx + dgx
        gy = gy + dgy
    inv = rsqrt(gx * gx + gy * gy + 1.0)
    return -gx * inv, -gy * inv, inv


def mirror_step_c(element: MirrorElement, s: TraceState, ignore_defects: bool,
                  want_incidence: bool = True) -> TraceState:
    (qx, qy, qz), (ux, uy, uz) = _to_local_c(element, s)
    if element.defects:
        t, hit = srf.intersect_c(element.surface, element.support, (qx, qy, qz), (ux, uy, uz))
        t, (x, y, z), (nx, ny, nz) = _deformed_hit(element, (qx, qy, qz), (ux, uy, uz), t,
                                                   element.centre)
        if not ignore_defects:
            nx, ny, nz = _defect_normal(element, x, y, (nx, ny, nz), element.centre)
    else:
        t, hit, (nx, ny, nz), (x, y, z) = srf.intersect_with_normal_c(
            element.surface, element.support, (qx, qy, qz), (ux, uy, uz))
    dn = ux * nx + uy * ny + uz * nz
    rx, ry, rz = ux - 2.0 * dn * nx, uy - 2.0 * dn * ny, uz - 2.0 * dn * nz
    upd = s.alive & hit
    inc_out = torch.where(upd, _acos(-dn), s.incidence) if want_incidence else s.incidence
    (px, py, pz), (dx, dy, dz) = _to_lab_c(element, (x, y, z), (rx, ry, rz))
    opl, opl_c = kahan_add(s.opl, s.opl_c, torch.where(upd, t, 0.0))
    return TraceState(
        px=torch.where(upd, px, s.px),
        py=torch.where(upd, py, s.py),
        pz=torch.where(upd, pz, s.pz),
        dx=torch.where(upd, dx, s.dx),
        dy=torch.where(upd, dy, s.dy),
        dz=torch.where(upd, dz, s.dz),
        opl=opl,
        opl_c=opl_c,
        alive=upd,
        incidence=inc_out,
    )


def mask_step_c(element: MaskElement, s: TraceState, want_incidence: bool = True) -> TraceState:
    (qx, qy, qz), (ux, uy, uz) = _to_local_c(element, s)
    t = -qz / torch.where(torch.abs(uz) > 1e-30, uz, float("inf"))
    x, y, z = qx + t * ux, qy + t * uy, qz + t * uz
    on_support = sup.include(element.support, x, y)
    transmitted = (t > T_EPS) & ~on_support
    upd = s.alive & transmitted
    # mask incidence uses +u (not -u), as in the reference
    inc_out = torch.where(upd, _acos(uz), s.incidence) if want_incidence else s.incidence
    (px, py, pz), _ = _to_lab_c(element, (x, y, z), (ux, uy, uz))
    opl, opl_c = kahan_add(s.opl, s.opl_c, torch.where(upd, t, 0.0))
    return TraceState(
        px=torch.where(upd, px, s.px),
        py=torch.where(upd, py, s.py),
        pz=torch.where(upd, pz, s.pz),
        dx=s.dx,
        dy=s.dy,
        dz=s.dz,
        opl=opl,
        opl_c=opl_c,
        alive=upd,
        incidence=inc_out,
    )


def state_step(element, s: TraceState, ignore_defects: bool = True,
               want_incidence: bool = True) -> TraceState:
    if isinstance(element, MirrorElement):
        return mirror_step_c(element, s, ignore_defects, want_incidence=want_incidence)
    if isinstance(element, MaskElement):
        return mask_step_c(element, s, want_incidence=want_incidence)
    raise TypeError(f"unknown element type {type(element)}")


def trace_step(element, bundle: RayBundle, ignore_defects: bool = True) -> RayBundle:
    """Propagate a bundle through one element (mirror or mask)."""
    return state_to_bundle(state_step(element, bundle_to_state(bundle), ignore_defects), bundle)


def trace(source: RayBundle, elements: Sequence, ignore_defects: bool = True,
          keep_history: bool = True):
    """Trace a bundle through a chain of elements: the list of bundles after
    each element (``keep_history=True``) or only the final bundle. The
    bundle and the elements must share a device; the bundle's dtype is the
    trace dtype. ``ignore_defects`` (the reference's default True) reflects
    deformed mirrors off their base normal, at the deformed hit."""
    history = []
    s = bundle_to_state(source)
    last = len(elements) - 1
    for i, element in enumerate(elements):
        s = state_step(element, s, ignore_defects, want_incidence=keep_history or i == last)
        if keep_history:
            history.append(state_to_bundle(s, source))
    return history if keep_history else state_to_bundle(s, source)


# ---------------------------------------------------------------------------
# chained-frame trace: one composed affine per element
# ---------------------------------------------------------------------------


def compose_chain(elements):
    """Compose the per-element frame round-trips into one affine map per
    element plus a final to-lab map, in host float64.

    ``maps[k] = (M, b)`` takes the patch-relative frame k-1 state (frame -1 =
    lab absolute) to element k's surface frame; ``final = (R_K, pos_K)``
    takes the patch-relative frame K state back to the lab."""

    def rot(el):
        return _host64(el.rot)

    def cen(el):
        if isinstance(el, MirrorElement):
            return _host64(el.centre)
        return np.zeros(3)

    def pos(el):
        return _host64(el.position)

    maps = []
    prev = None
    for el in elements:
        R = rot(el)
        if prev is None:
            M = R
            b = -R @ pos(el) + cen(el)
        else:
            M = R @ rot(prev).T
            b = R @ (pos(prev) - pos(el)) + cen(el)
        maps.append((M, b))
        prev = el
    final = (rot(prev), pos(prev))
    return maps, final


def fold_source(maps, elements, source_rot, source_origin):
    """:func:`compose_chain`'s maps with the source frame folded into the
    first: it takes canonical source-frame coordinates (a source rotated by
    ``source_rot`` and placed at ``source_origin`` in the lab) straight into
    element 0's surface frame. Host float64."""
    el0 = elements[0]
    cen0 = _host64(el0.centre) if isinstance(el0, MirrorElement) else np.zeros(3)
    M0, _ = maps[0]
    M = M0 @ np.asarray(source_rot, np.float64)
    b = M0 @ (np.asarray(source_origin, np.float64) - _host64(el0.position)) + cen0
    return [(M, b)] + list(maps[1:])


def _host64(x):
    if torch.is_tensor(x):
        return x.detach().to("cpu", torch.float64).numpy()
    return np.asarray(x, dtype=np.float64)


def fold_premasks(elements, maps):
    """Fold every non-terminal mask into the following element's composed
    affine as a pure alive-predicate ("premask"). Returns
    ``(elements', maps', premasks)`` of equal length; ``premasks[k]`` is a
    tuple of ``(support, M, b)`` tests applied to element k's incoming
    state. The last element is never folded."""
    new_els, new_maps, new_pre = [], [], []
    pending = []
    carry = None
    for i, (el, (M, b)) in enumerate(zip(elements, maps)):
        M = np.asarray(M, dtype=np.float64)
        b = np.asarray(b, dtype=np.float64)
        if carry is not None:
            Mc, bc = carry
            M, b = M @ Mc, M @ bc + b
        if isinstance(el, MaskElement) and i < len(elements) - 1:
            pending.append((el.support, M, b))
            carry = (M, b)
        else:
            new_els.append(el)
            new_maps.append((M, b))
            new_pre.append(tuple(pending))
            pending, carry = [], None
    return new_els, new_maps, new_pre


def bake(x):
    """Nested python-float tuples from a host array or tensor: constants that
    round to the ray dtype at use, like the JAX package's baked constants."""
    arr = _host64(x)
    if arr.ndim == 0:
        return float(arr)
    if arr.ndim == 1:
        return tuple(float(v) for v in arr)
    return tuple(tuple(float(v) for v in row) for row in arr)


def _map_entries(x):
    """Entries of a map ``M`` (3x3) or ``b`` (3): host arrays are baked to
    python floats; tensors and tuples are indexed as they are, so a tangent
    or a gradient reaches the entries of a tensor map."""
    return bake(x) if isinstance(x, np.ndarray) else x


def _affine_c(M, b, px, py, pz, dx, dy, dz):
    M, b = _map_entries(M), _map_entries(b)
    qx = M[0][0] * px + M[0][1] * py + M[0][2] * pz + b[0]
    qy = M[1][0] * px + M[1][1] * py + M[1][2] * pz + b[1]
    qz = M[2][0] * px + M[2][1] * py + M[2][2] * pz + b[2]
    ux = M[0][0] * dx + M[0][1] * dy + M[0][2] * dz
    uy = M[1][0] * dx + M[1][1] * dy + M[1][2] * dz
    uz = M[2][0] * dx + M[2][1] * dy + M[2][2] * dz
    return (qx, qy, qz), (ux, uy, uz)


def premask_alive(premasks, s: TraceState):
    """(alive, t_floor) after the folded mask tests: each mask's crossing
    must lie beyond the previous one, and the furthest crossing becomes the
    next element's minimum ray parameter."""
    alive = s.alive
    t_floor = torch.zeros_like(s.px)
    for support, Mm, bm in premasks:
        (mx, my, mz), (mux, muy, muz) = _affine_c(
            Mm, bm, s.px, s.py, s.pz, s.dx, s.dy, s.dz)
        t = -mz / torch.where(torch.abs(muz) > 1e-30, muz, float("inf"))
        on_support = sup.include(support, mx + t * mux, my + t * muy)
        alive = alive & (t > t_floor + T_EPS) & ~on_support
        t_floor = torch.maximum(t_floor, t)
    return alive, t_floor


def chained_step(element, M, b, s: TraceState, want_incidence: bool,
                 ignore_defects: bool = True, premasks=(),
                 freeze_dead: bool = True) -> TraceState:
    """One element step in chained-frame mode: input patch-relative to the
    previous element (lab absolute for the first), output patch-relative to
    this element. A deformed mirror is hit where its deformed surface lies;
    ``ignore_defects`` gates only the slopes composed into its normal
    (:func:`mirror_step_c`).

    ``freeze_dead=False`` skips the dead-ray freeze at mirrors: dead rays
    advance along whatever bounded path the mirror gives them, which is
    legal wherever every consumer masks by ``alive``. Mask steps always
    freeze, because their plane leg is unbounded for near-parallel rays."""
    if premasks:
        alive, t_floor = premask_alive(premasks, s)
        s = s._replace(alive=alive)
        t_eps = t_floor + T_EPS
    else:
        t_eps = T_EPS
    (qx, qy, qz), (ux, uy, uz) = _affine_c(M, b, s.px, s.py, s.pz, s.dx, s.dy, s.dz)
    if isinstance(element, MaskElement):
        cen = (0.0, 0.0, 0.0)
        t = -qz / torch.where(torch.abs(uz) > 1e-30, uz, float("inf"))
        x, y, z = qx + t * ux, qy + t * uy, qz + t * uz
        on_support = sup.include(element.support, x, y)
        valid = (t > t_eps) & ~on_support
        rx, ry, rz = ux, uy, uz
        dn = -uz  # mask incidence uses +u: acos(uz)
    elif element.defects:
        cen = element.centre
        t, valid = srf.intersect_c(element.surface, element.support, (qx, qy, qz), (ux, uy, uz),
                                   t_eps=t_eps)
        t, (x, y, z), (nx, ny, nz) = _deformed_hit(element, (qx, qy, qz), (ux, uy, uz), t, cen)
        if not ignore_defects:
            nx, ny, nz = _defect_normal(element, x, y, (nx, ny, nz), cen)
        dn = ux * nx + uy * ny + uz * nz
        rx, ry, rz = ux - 2.0 * dn * nx, uy - 2.0 * dn * ny, uz - 2.0 * dn * nz
    else:
        cen = element.centre
        t, valid, (nx, ny, nz), (x, y, z) = srf.intersect_with_normal_c(
            element.surface, element.support, (qx, qy, qz), (ux, uy, uz), t_eps=t_eps)
        dn = ux * nx + uy * ny + uz * nz
        rx, ry, rz = ux - 2.0 * dn * nx, uy - 2.0 * dn * ny, uz - 2.0 * dn * nz
    upd = s.alive & valid
    if not freeze_dead and isinstance(element, MirrorElement):
        inc_out = _acos(-dn) if want_incidence else s.incidence
        opl, opl_c = kahan_add(s.opl, s.opl_c, t)
        return TraceState(
            px=x - cen[0], py=y - cen[1], pz=z - cen[2],
            dx=rx, dy=ry, dz=rz,
            opl=opl, opl_c=opl_c, alive=upd, incidence=inc_out,
        )
    inc_out = torch.where(upd, _acos(-dn), s.incidence) if want_incidence else s.incidence
    opl, opl_c = kahan_add(s.opl, s.opl_c, torch.where(upd, t, 0.0))
    return TraceState(
        px=torch.where(upd, x, qx) - cen[0],
        py=torch.where(upd, y, qy) - cen[1],
        pz=torch.where(upd, z, qz) - cen[2],
        dx=torch.where(upd, rx, ux),
        dy=torch.where(upd, ry, uy),
        dz=torch.where(upd, rz, uz),
        opl=opl,
        opl_c=opl_c,
        alive=upd,
        incidence=inc_out,
    )


def to_lab_c(final, s: TraceState) -> TraceState:
    """Patch-relative frame K state back to the lab: p = R_K^T x + pos_K."""
    R_K, pos_K = bake(final[0]), bake(final[1])
    x, y, z = s.px, s.py, s.pz
    px = R_K[0][0] * x + R_K[1][0] * y + R_K[2][0] * z + pos_K[0]
    py = R_K[0][1] * x + R_K[1][1] * y + R_K[2][1] * z + pos_K[1]
    pz = R_K[0][2] * x + R_K[1][2] * y + R_K[2][2] * z + pos_K[2]
    dx = R_K[0][0] * s.dx + R_K[1][0] * s.dy + R_K[2][0] * s.dz
    dy = R_K[0][1] * s.dx + R_K[1][1] * s.dy + R_K[2][1] * s.dz
    dz = R_K[0][2] * s.dx + R_K[1][2] * s.dy + R_K[2][2] * s.dz
    return s._replace(px=px, py=py, pz=pz, dx=dx, dy=dy, dz=dz)


def run_chain_chained(s: TraceState, elements, maps, final, ignore_defects: bool = True,
                      premasks=None, freeze_dead: bool = True) -> TraceState:
    """Run a whole chain in chained-frame mode and restore lab coordinates
    (incidence computed only at the last element). ``maps``/``final`` come
    from :func:`compose_chain` (host float64, or python-float tuples rounded
    to the state dtype at use); ``premasks`` from :func:`fold_premasks`."""
    last = len(elements) - 1
    if premasks is None:
        premasks = ((),) * len(elements)
    for i, (el, (M, b)) in enumerate(zip(elements, maps)):
        s = chained_step(el, M, b, s, want_incidence=(i == last), ignore_defects=ignore_defects,
                         premasks=premasks[i], freeze_dead=freeze_dead)
    return to_lab_c(final, s)
