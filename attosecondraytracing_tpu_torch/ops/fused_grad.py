"""The fused alignment-gradient engine: kernels K6 and K7, their plain
PyTorch version, and the host side (counterpart of the JAX package's
``ops/pallas_grad.py``).

The alignment loss (:func:`..analysis.alignment.focus_loss`) is a function
of 7 weighted detector sums (:data:`~.fused_trace.STATS_FIELDS`). The
runtime-pose kernels take every pose-dependent constant of a chain as one
vector ``svec`` (:func:`chain_scalars_np`): per element the composed
chained-frame affine ``(M_k, b_k)`` (the first with the source frame folded
in), then the detector plane in the final element's frame.

* **K6** (``csrc/fused_grad.cu``, ``stats_params_kernel<G>``) replaces
  ``_kernel_stats_jvp``: the 7 sums at one distance and their directional
  derivatives along all P tangent rows of ``svec`` (one row per pose
  parameter), in one launch per gradient step; each block traces its rays
  once on dual numbers for a group of G rows (the shared primal of
  ``jax.linearize``).
* **K7** (``stats_primal_kernel``) replaces ``_kernel_stats_primal``:
  the 7 sums alone, its pose written into its launch record
  (:func:`pack_primal_records`).

The tangent rows are the Jacobian of ``params -> svec``, written in closed
form in host float64 (:func:`scalar_jacobian`; the tests and
``chip_smoke.py`` hold it against ``torch.func.jacfwd`` of
:func:`chain_scalars_np` written in torch, ``tests/torch_pose_oracle.py``),
rounded to float32 once; the loss gradient is one host contraction. The primal
``svec`` is composed in host float64 and rounded to float32 once: the JAX
package records why (``pallas_grad.py:101-107``): a float32 (there:
bfloat16-pass) composition displaced the traced geometry by ~0.5 mm and
corrupted the moments by tens of percent.

:func:`fused_stats_params` takes the plain version :func:`stats_params_ref`
only for a CPU device; for a CUDA device it launches K6 or K7 or raises,
counting K6 launches in ``fused_stats_params.launches`` and K7 launches in
``fused_stats_params.primal_launches``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .trace import TraceState, _host64, chained_step, compose_chain, fold_source

#: scalars of the detector plane at the end of the vector: centre, normal,
#: e1, e2 in the final element's frame
N_DET_SCALARS = 12

#: per-call ray chunk: local float indices stay < 2^23 for exactness
GRAD_CHUNK = 1 << 23

def n_scalars(n_elements: int) -> int:
    """Length of the pose vector of a chain of ``n_elements`` elements."""
    return 12 * n_elements + N_DET_SCALARS


def n_params(n_elements: int) -> int:
    """Pose parameters of a chain (3 angles and 3 shifts per element): the
    most tangent rows one K6 launch takes."""
    return 6 * n_elements


def chain_scalars_np(elements, source_rot, source_origin, det_centre, det_normal,
                     det_rot) -> np.ndarray:
    """The (n_scalars,) float32 pose vector of a chain, composed in host
    float64: per element k the composed map ``M_k`` (9, row-major) then
    ``b_k`` (3), element 0's map taking canonical source-frame coordinates
    (``source_rot``, ``source_origin``) straight into its surface frame;
    then the detector centre, normal, e1 and e2 in the final element's
    frame. Element poses may be tensors on any device and dtype, or host
    arrays."""
    maps, (R_K, pos_K) = compose_chain(elements)
    maps = fold_source(maps, elements, source_rot, source_origin)
    parts = []
    for M, b in maps:
        parts.append(np.asarray(M).reshape(-1))
        parts.append(np.asarray(b))
    rot = np.asarray(det_rot, np.float64)
    parts += [R_K @ (np.asarray(det_centre, np.float64) - pos_K),
              R_K @ np.asarray(det_normal, np.float64), R_K @ rot[0], R_K @ rot[1]]
    return np.concatenate(parts).astype(np.float32)


def _unpack_scalars(scal, n_elements: int):
    """Inverse of :func:`chain_scalars_np`: per-element ``(M, b)`` as nested
    tuples of the vector's entries, and the detector ``(centre, normal, e1,
    e2)``. Entries of a tensor stay 0-d tensors, so tangents reach them."""
    maps = []
    i = 0
    for _ in range(n_elements):
        M = tuple(tuple(scal[i + 3 * r + c] for c in range(3)) for r in range(3))
        b = tuple(scal[i + 9 + c] for c in range(3))
        maps.append((M, b))
        i += 12
    det = tuple(tuple(scal[i + 3 * g + c] for c in range(3)) for g in range(4))
    return maps, det


def _perturbed_poses(elements, params):
    """Float64 host twin of :func:`..analysis.alignment.apply_params` (pose
    perturbation by AlignmentParams) with its forward-mode tangents: the
    perturbed rotations (K, 3, 3) and positions (K, 3), and their partials in
    the 6K flat parameters (angles row-major, then shifts: the JAX package's
    ``ravel_pytree`` order), ``d_rot`` (6K, K, 3, 3) and ``d_pos`` (6K, K, 3).

    Element k's pose is ``rot R_delta^T`` and ``position + s0 n + s1 m + s2
    c``, with ``R_delta = A_c(pitch) A_m(roll) A_n(yaw)`` Rodrigues rotations
    about its unperturbed axes (rows m, c, n of ``rot``, held constant as
    ``_perturb_one`` detaches them). So it moves with its own six parameters
    only: ``d A_u(a) / da = [u]x A_u(a)``, and a shift's partial is its
    axis."""
    angles = _host64(params.angles)
    shifts = _host64(params.shifts)
    K = len(elements)
    rot = np.stack([_host64(el.rot) for el in elements])
    u = rot[:, [1, 0, 2]]                       # the rotation axes c, m, n
    u = u / np.linalg.norm(u, axis=-1, keepdims=True)
    X = np.zeros((K, 3, 3, 3))                  # their cross-product matrices [u]x
    X[..., 0, 1], X[..., 0, 2], X[..., 1, 2] = -u[..., 2], u[..., 1], -u[..., 0]
    X[..., 1, 0], X[..., 2, 0], X[..., 2, 1] = u[..., 2], -u[..., 1], u[..., 0]
    sin, cos = np.sin(angles)[..., None, None], np.cos(angles)[..., None, None]
    A = np.eye(3) + sin * X + (1.0 - cos) * (X @ X)
    dA = X @ A
    Ac, Am, An = A[:, 0], A[:, 1], A[:, 2]
    d_delta = np.stack([dA[:, 0] @ Am @ An, Ac @ dA[:, 1] @ An, Ac @ Am @ dA[:, 2]], axis=1)
    shift_axes = rot[:, [2, 0, 1]]              # n, m, c
    rots = rot @ (Ac @ Am @ An).swapaxes(1, 2)
    pos = np.stack([_host64(el.position) for el in elements])
    poss = pos + np.einsum("kj,kji->ki", shifts, shift_axes)
    i = np.arange(3 * K)
    d_rot, d_pos = np.zeros((6 * K, K, 3, 3)), np.zeros((6 * K, K, 3))
    d_rot[i, i // 3] = (rot[:, None] @ d_delta.swapaxes(2, 3)).reshape(3 * K, 3, 3)
    d_pos[3 * K + i, i // 3] = shift_axes.reshape(3 * K, 3)
    return rots, poss, d_rot, d_pos


def _apply_params_np(elements, params):
    """Float64 host twin of :func:`..analysis.alignment.apply_params`:
    elements with host-array poses, for :func:`chain_scalars_np`."""
    rots, poss, _, _ = _perturbed_poses(elements, params)
    return [el._replace(rot=r, position=p) for el, r, p in zip(elements, rots, poss)]


# ---------------------------------------------------------------------------
# the loss description
# ---------------------------------------------------------------------------


class FusedLossSpec(NamedTuple):
    """The pose-independent description of a fused loss: source law, chain
    structure, the chief-ray reference path and the loss weights.
    ``elements`` are host float64 element records whose poses are unused
    (each evaluation's poses come from its ``svec``). ``ignore_defects``
    as in :func:`~.trace.trace`."""

    source_kind: str          # 'cone' | 'disk' | 'extended' | 'square'
    source_radius: float      # tan(divergence), disk radius or square side [mm]
    elements: tuple
    opl_ref: float
    gaussian_edge: float | None
    n_rays: int
    duration_weight: float
    survival_weight: float
    ignore_defects: bool = True
    pos_radius: float = 0.0   # source-disk radius [mm] ('extended')
    n_each: int = 0
    n_sources: int = 0


def make_loss_spec(source_spec, elements, det_centre, det_normal, duration_weight: float = 0.0,
                   survival_weight: float = 1.0, ignore_defects: bool = True, *, device,
                   dtype=None) -> FusedLossSpec:
    """The FusedLossSpec of a chain's ``FusedSourceInfo``
    (models/chain.py), its elements, and the fixed lab-frame detector
    plane; the chief-ray probe traces on ``device`` in ``dtype`` (default:
    the trace dtype)."""
    from . import fused_trace as ft
    from .precision import default_dtype

    baked = source_spec.baked()
    opl_ref, _ = ft.chief_ray_refs(baked, elements, det_centre, det_normal, device=device,
                                   dtype=dtype or default_dtype())
    return FusedLossSpec(
        source_kind=source_spec.kind, source_radius=float(baked.radius),
        elements=tuple(ft.elements_to(elements, "cpu", torch.float64)),
        opl_ref=float(opl_ref), gaussian_edge=source_spec.gaussian_edge,
        n_rays=int(source_spec.n_rays), duration_weight=float(duration_weight),
        survival_weight=float(survival_weight), ignore_defects=bool(ignore_defects),
        pos_radius=float(baked.pos_radius),
        n_each=int(baked.n_each), n_sources=int(baked.n_sources))


def _ray_chunks(spec: FusedLossSpec, chunk_size: int):
    """[(n_local, phase, k_frac)] covering the global source (kind-aware:
    extended sources chunk along sub-source boundaries)."""
    from .fused_trace import source_chunks

    return source_chunks(spec.source_kind, spec.n_rays, spec.n_rays, chunk_size,
                         n_each=spec.n_each, n_sources=spec.n_sources)


def _total_weight(spec: FusedLossSpec) -> float:
    """Total source weight of the survival term (closed form)."""
    from .fused_scan import total_source_weight

    return total_source_weight(spec.n_rays, spec.gaussian_edge, n_each=spec.n_each,
                               n_sources=spec.n_sources, kind=spec.source_kind)


# ---------------------------------------------------------------------------
# K6 / K7: plain version
# ---------------------------------------------------------------------------


def stats_of_scalars(scal, spec: FusedLossSpec, n_local: int, phase, k_frac, *, device):
    """(7,) float64 sums of :data:`~.fused_trace.STATS_FIELDS` at the
    detector plane as a function of the float32 pose vector ``scal`` (a
    tensor on ``device``): the function K6 differentiates. ``n_local`` rays
    of the global source from the chunk offsets (``phase``, ``k_frac``),
    weight ``exp(ln edge * rr)``, the chained trace with masks as their own
    steps and dead rays not frozen at mirrors, then the stats epilogue at
    distance 0. Every pose is an entry of ``scal``, so ``torch.func.jvp``
    reaches it; dead rays are selected out of every product."""
    from . import fused_trace as ft

    maps, det_rel = _unpack_scalars(scal, len(spec.elements))
    k = torch.arange(n_local, dtype=torch.int64, device=device)
    (px, py, pz), (dx, dy, dz), rr = ft.synth_source(
        spec.source_kind, k, spec.n_rays, spec.source_radius, phase, k_frac,
        pos_radius=spec.pos_radius, n_each=spec.n_each, n_sources=spec.n_sources)
    if spec.gaussian_edge is None:
        weights = torch.ones_like(rr)
    else:
        weights = torch.exp(float(np.log(spec.gaussian_edge)) * rr)
    zeros = torch.zeros_like(rr)
    s = TraceState(px, py, pz, dx, dy, dz, zeros, zeros, torch.ones_like(rr, dtype=torch.bool), zeros)
    for el, (M, b) in zip(ft.elements_to(spec.elements, device, torch.float64), maps):
        s = chained_step(el, M, b, s, want_incidence=False, ignore_defects=spec.ignore_defects,
                         freeze_dead=False)
    det = ft.BakedDetector(centre=det_rel[0], normal=det_rel[1], e1=det_rel[2], e2=det_rel[3],
                           opl_ref=spec.opl_ref)
    return ft.stats_rows(s, det, weights)[:, 0]


def _check_params_args(spec: FusedLossSpec, svec, stangents):
    n = n_scalars(len(spec.elements))
    svec = np.asarray(svec, np.float32)
    stangents = np.zeros((0, n), np.float32) if stangents is None else np.asarray(stangents, np.float32)
    P = n_params(len(spec.elements))
    if svec.shape != (n,) or stangents.ndim != 2 or stangents.shape[1] != n \
            or stangents.shape[0] > P:
        raise ValueError(f"a {len(spec.elements)}-element chain takes svec ({n},) and at most "
                         f"{P} tangent rows of {n}, got {svec.shape} and {stangents.shape}")
    return svec, stangents


def stats_params_ref(spec: FusedLossSpec, svec, stangents, chunks, *, device):
    """Plain PyTorch version of K6 (``stangents`` (P, n) float32, P up to
    the chain's :func:`n_params`) and K7 (P = 0 or ``stangents=None``),
    following the JAX package's ``_kernel_stats_jvp``: per chunk,
    :func:`stats_of_scalars` and its JVP along every tangent row with one
    shared primal (``torch.func.jvp`` batched over the rows by
    ``torch.func.vmap``), summed in float64. Returns ``(primal (7,),
    tangents (P, 7))``."""
    svec, stangents = _check_params_args(spec, svec, stangents)
    G = stangents.shape[0]
    p = torch.tensor(svec, device=device)
    tang = torch.tensor(stangents, device=device)
    primal = np.zeros(7, np.float64)
    tangents = np.zeros((G, 7), np.float64)
    for n_local, phase, k_frac in chunks:
        def f(scal):
            return stats_of_scalars(scal, spec, n_local, phase, k_frac, device=device)

        if G == 0:
            primal += f(p).cpu().numpy()
            continue
        outs, touts = torch.func.vmap(lambda t: torch.func.jvp(f, (p,), (t,)))(tang)
        primal += outs[0].cpu().numpy()
        tangents += touts.cpu().numpy()
    return primal, tangents


# ---------------------------------------------------------------------------
# K6 / K7: kernel wrapper
# ---------------------------------------------------------------------------


def _scan_spec(spec: FusedLossSpec):
    from .fused_scan import ScanSpec

    return ScanSpec(source_kind=spec.source_kind, elements=spec.elements, n_total=spec.n_rays,
                    ignore_defects=spec.ignore_defects, n_each=spec.n_each,
                    n_sources=spec.n_sources)


def loss_source(spec: FusedLossSpec):
    """The source law of a loss in its canonical frame (the pose vector's
    first map folds the source's rotation and origin in)."""
    from . import fused_trace as ft

    return ft.BakedSource(kind=spec.source_kind, rot=((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0)),
                          origin=(0.0, 0.0, 0.0), radius=spec.source_radius,
                          pos_radius=spec.pos_radius, n_each=spec.n_each, n_sources=spec.n_sources)


def pose_table(elements, svec):
    """The unfolded :class:`~.fused_trace.ChainTable` of ``elements`` whose
    maps are the pose vector ``svec``'s (its float32 entries as python
    floats): masks stay their own steps, as the runtime-pose kernels walk
    them. Its final frame is left zero."""
    from . import fused_trace as ft

    maps, _det = _unpack_scalars([float(v) for v in np.asarray(svec, np.float32)], len(elements))
    zero = (((0.0,) * 3,) * 3, (0.0,) * 3)
    return ft.ChainTable(elements=tuple(elements), maps=tuple(maps), final=zero,
                         premasks=((),) * len(elements))


def pack_stats_records(spec: FusedLossSpec, device=None):
    """K6's ``(chain, source)`` records: the pose-independent chain record
    (K5's, :func:`~.fused_scan.pack_scan_chain`, grid rows on ``device``)
    and the source law in its canonical frame (:func:`loss_source`). Raises
    NotImplementedError on what the kernels do not take."""
    from . import fused_scan as fs
    from . import fused_trace as ft

    return (fs.pack_scan_chain(_scan_spec(spec), device),
            ft.pack_source(loss_source(spec), spec.n_rays, spec.gaussian_edge))


def pack_primal_records(spec: FusedLossSpec, svec, device=None):
    """K7's ``(chain, source, detector)`` records for the pose vector
    ``svec``: the chain record of :func:`pose_table` (each element's map in
    ``el[i].M``, ``el[i].b``, masks unfolded; grid rows on ``device``), the
    source law in its canonical frame (:func:`loss_source`) and the
    detector plane (centre, normal, e1, e2 in the last element's frame, and
    the chief ray's ``opl_ref``) in a ``DetectorP``. Raises
    NotImplementedError on what the kernel does not take."""
    from . import fused_trace as ft

    chain_rec = ft.pack_chain(pose_table(spec.elements, svec), spec.ignore_defects, device)
    det = np.zeros((), dtype=ft.DETECTOR_T)
    c, n, e1, e2 = np.asarray(svec, np.float32)[-N_DET_SCALARS:].reshape(4, 3)
    det["c"], det["n"], det["e1"], det["e2"], det["opl_ref"] = c, n, e1, e2, spec.opl_ref
    return chain_rec, ft.pack_source(loss_source(spec), spec.n_rays, spec.gaussian_edge), det


def prepare_stats_params(spec: FusedLossSpec, svec, stangents, chunks, *, device):
    """K6/K7's host work for a CUDA ``device``: pack the records, copy the
    chunk offsets (K6: also ``svec`` and the P tangent rows) to the device,
    and allocate the per-block rows. Returns ``(rows, launch)``: each
    ``launch()`` runs K6 (P > 0) or K7 (P = 0) once over every chunk on a
    grid sized to the rays (:func:`~.fused_trace.ray_grid`, at the kernel's
    own rays per block), and counts it. K6 (:func:`pack_stats_records`)
    takes the P rows in ceil(P / G) groups of the kernel's G
    (``_cuda.tangent_batch``) and writes ``rows`` (groups, blocks, 7 (1 +
    G)): per group and block one float64 row of the 7 sums and their G
    tangents. K7 (:func:`pack_primal_records`: the pose in its launch
    record) writes (1, blocks, 7)."""
    from . import _cuda
    from . import fused_trace as ft

    sizes = ft._check_chunks(chunks)
    device = ft._cuda_device(device, "fused_stats_params")
    svec, stangents = _check_params_args(spec, svec, stangents)
    P = stangents.shape[0]
    # the records first: what the kernels do not take raises before any copy
    if P:
        chain_rec, src_rec = pack_stats_records(spec, device)
    else:
        chain_rec, src_rec, det_rec = pack_primal_records(spec, svec, device)
    grids = ft.launch_grids(spec.elements, device)
    params = torch.tensor([[c[1], c[2]] for c in chunks], dtype=torch.float32, device=device)
    n_rays, chunk = sum(sizes), sizes[0]
    checked = [("chunk params", params, torch.float32)]
    if P:
        G = _cuda.tangent_batch()
        svec_t = torch.tensor(svec, device=params.device)
        tang_t = torch.tensor(stangents, device=params.device)
        grid = ft.ray_grid(sizes, _cuda.moment_rays_per_block())
        checked += [("svec", svec_t, torch.float32), ("tangents", tang_t, torch.float32)]
    else:
        G = 0
        grid = ft.ray_grid(sizes, _cuda.stats_primal_rays_per_block())
    rows = torch.empty((-(-P // G) if P else 1, grid[1], 7 * (1 + G)), dtype=torch.float64,
                       device=params.device)
    for name, x, dtype in checked + [("stats rows", rows, torch.float64)]:
        ft._check_out(name, x, dtype, params.device)

    def launch():
        with torch.cuda.device(rows.device):
            stream = torch.cuda.current_stream(rows.device).cuda_stream
            if P:
                _cuda.launch_stats_params(chain_rec, src_rec, spec.opl_ref, n_rays, chunk, grid,
                                          svec.shape[0], svec_t, tang_t, params, rows, stream, grids)
            else:
                _cuda.launch_stats_primal(chain_rec, src_rec, det_rec, n_rays, chunk, grid, params,
                                          rows, stream, grids)
        if P:
            fused_stats_params.launches += 1
        else:
            fused_stats_params.primal_launches += 1

    return rows, launch


def params_from_rows(rows, n_tangents: int):
    """``(primal (7,), tangents (n_tangents, 7))`` float64 from K6/K7's rows
    ((groups, blocks, 7 (1 + G)), group-major as the kernel writes them; K7:
    one group, G = 0): the blocks are summed once, the primal is group 0's
    (every group retraces it), tangent row j sits in group j // G, slot
    j % G; rows past ``n_tangents`` pad the last group."""
    total = rows.sum(dim=1).cpu().numpy()
    return total[0, :7], total[:, 7:].reshape(-1, 7)[:n_tangents]


def fused_stats_params(spec: FusedLossSpec, svec, stangents, chunks, *, device):
    """K6 (``stangents`` (P, n), 0 < P <= the chain's :func:`n_params`;
    replaces ``ops/pallas_grad.py::_kernel_stats_jvp`` of the JAX package)
    and K7 (P = 0 or None; replaces ``_kernel_stats_primal``): the 7
    weighted sums at the detector plane over every chunk's rays and, for K6,
    their derivatives along each tangent row, summed in float64. One launch
    covers every chunk and every tangent row. CPU runs
    :func:`stats_params_ref`. Returns ``(primal (7,), tangents (P, 7))``."""
    from .fused_trace import _check_chunks

    _check_chunks(chunks)
    if torch.device(device).type == "cpu":
        return stats_params_ref(spec, svec, stangents, chunks, device=device)
    rows, launch = prepare_stats_params(spec, svec, stangents, chunks, device=device)
    launch()
    return params_from_rows(rows, 0 if stangents is None else len(stangents))


#: K6 launches
fused_stats_params.launches = 0
#: K7 launches
fused_stats_params.primal_launches = 0


# ---------------------------------------------------------------------------
# loss value and gradient
# ---------------------------------------------------------------------------


def _stats_and_jacobian(sprimal, stangents, spec: FusedLossSpec, chunk_size: int, *, device,
                        mesh=None):
    """``(p_stats (7,), t_stats (P, 7))`` float64 over every ray of the
    global source: all P tangent rows in one K6 launch over every chunk.

    ``mesh`` (``parallel/mesh.Mesh``): each shard runs the launch on its
    slice of the global spiral (its ``(phase, k_frac)`` offsets; at most
    ``chunk_size`` rays a shard) on its device, and only the float64 sums
    and their tangents leave it."""
    if mesh is None:
        return fused_stats_params(spec, sprimal, stangents, _ray_chunks(spec, chunk_size),
                                  device=device)
    from ..parallel.mesh import _refuse_unaligned, _sum_rows, shard_source_offsets

    _refuse_unaligned(spec.source_kind, "sharded fused gradients")
    if spec.n_rays % mesh.size:
        raise ValueError("sharded fused gradients need n_rays divisible by the mesh size")
    n_local, phases, k_fracs = shard_source_offsets(spec.n_rays, mesh.size)
    if n_local > chunk_size:
        raise ValueError(f"per-device ray count {n_local} exceeds the {chunk_size}-ray kernel "
                         "chunk; use more devices or chunk on one device")
    rows = []
    for shard, dev in mesh.local():
        p, t = fused_stats_params(spec, sprimal, stangents,
                                  [(n_local, float(phases[shard]), float(k_fracs[shard]))], device=dev)
        rows.append(np.concatenate([p, t.reshape(-1)]))
    total = _sum_rows(mesh, rows)
    return total[:7], total[7:].reshape(-1, 7)


def _loss_from_stats(stats, spec: FusedLossSpec, total_weight: float):
    """``(loss, dloss/dstats (7,))`` of the focus loss from the 7 weighted
    sums (analysis/alignment.focus_loss semantics): spot variance +
    duration_weight * delay variance [fs^2] + survival_weight * (1 -
    transmission). Evaluated in float64 through ``torch.autograd``. The
    JAX package evaluates it in float32 (``pallas_grad.py:571-575``), where
    ``wxx/w - (wx/w)^2`` cancels at float32 resolution; float64 keeps the
    sums' precision, so the two agree to that cancellation error."""
    from .precision import LIGHT_SPEED_MM_S

    st = torch.tensor(np.asarray(stats, np.float64), requires_grad=True)
    w, wx, wy, wxx, wyy, wd, wdd = st
    w = torch.clamp(w, min=1e-30)
    loss = wxx / w - (wx / w) ** 2 + wyy / w - (wy / w) ** 2
    if spec.duration_weight:
        to_fs = 1e15 / LIGHT_SPEED_MM_S
        loss = loss + spec.duration_weight * (wdd / w - (wd / w) ** 2) * to_fs**2
    if spec.survival_weight:
        loss = loss + spec.survival_weight * (1.0 - w / total_weight)
    loss.backward()
    return float(loss.detach()), st.grad.numpy()


def scalar_jacobian(elements, params, source_rot, source_origin, det_centre, det_normal,
                    det_rot) -> np.ndarray:
    """(6K, n_scalars) float64 Jacobian d svec / d param of
    ``params -> chain_scalars_np(apply_params(elements, params), ...)``
    before its float32 rounding, in closed form (forward mode on the host,
    batched over the parameters): :func:`_perturbed_poses`' tangents pushed
    through :func:`chain_scalars_np`' algebra. The element centres are
    constants and drop out."""
    R, pos, dR, dpos = _perturbed_poses(elements, params)
    P, K = dR.shape[:2]
    src_rot, src_origin, det_c, det_n, det_rot = (
        _host64(x) for x in (source_rot, source_origin, det_centre, det_normal, det_rot))
    dM, db = np.empty((P, K, 3, 3)), np.empty((P, K, 3))
    # element 0 with the source frame folded in: (R_0 src_rot, R_0 (src_origin - pos_0) + cen_0)
    dM[:, 0] = dR[:, 0] @ src_rot
    db[:, 0] = dR[:, 0] @ (src_origin - pos[0]) - dpos[:, 0] @ R[0].T
    # M_k = R_k R_{k-1}^T, b_k = R_k (pos_{k-1} - pos_k) + cen_k
    dM[:, 1:] = dR[:, 1:] @ R[:-1].swapaxes(1, 2) + R[1:] @ dR[:, :-1].swapaxes(2, 3)
    db[:, 1:] = (np.einsum("pkij,kj->pki", dR[:, 1:], pos[:-1] - pos[1:])
                 + np.einsum("kij,pkj->pki", R[1:], dpos[:, :-1] - dpos[:, 1:]))
    # the detector rows: R_K (det_centre - pos_K), R_K det_normal, R_K e1, R_K e2
    det_vecs = np.stack([det_c - pos[-1], det_n, det_rot[0], det_rot[1]])
    d_det = np.einsum("pij,gj->pgi", dR[:, -1], det_vecs)
    d_det[:, 0] -= dpos[:, -1] @ R[-1].T
    return np.concatenate([np.concatenate([dM.reshape(P, K, 9), db], axis=2).reshape(P, -1),
                           d_det.reshape(P, -1)], axis=1)


def scalar_tangents(elements, params, source_rot, source_origin, det_centre, det_normal,
                    det_rot) -> np.ndarray:
    """(P, n_scalars) float32 Jacobian rows d svec / d param: the closed
    form :func:`scalar_jacobian` (held against ``torch.func.jacfwd`` of
    ``tests/torch_pose_oracle.chain_scalars``), rounded to float32 once.
    Counted in ``scalar_tangents.calls``."""
    scalar_tangents.calls += 1
    return scalar_jacobian(elements, params, source_rot, source_origin, det_centre, det_normal,
                           det_rot).astype(np.float32)


#: closed-form Jacobian evaluations (one per fused gradient step)
scalar_tangents.calls = 0


def fused_focus_value_and_grad(params, spec: FusedLossSpec, elements, source_rot, source_origin,
                               det_centre, det_normal, det_rot, chunk_size: int = GRAD_CHUNK, *,
                               device, mesh=None):
    """``(loss, grads)`` of the focus loss w.r.t. the AlignmentParams
    ``params``, through K6 on a CUDA ``device`` (its plain version on the
    CPU). ``elements`` are the unperturbed elements; ``grads`` is an
    AlignmentParams of float32 CPU tensors. Cost: one K6 launch over every
    chunk of ``chunk_size`` rays and all 6K tangent rows, and O(1) gradient
    memory at any ray count. ``mesh`` shards the launch's rays over its
    shards' devices (:func:`_stats_and_jacobian`)."""
    from ..analysis.alignment import AlignmentParams

    sprimal = chain_scalars_np(_apply_params_np(elements, params), source_rot, source_origin,
                               det_centre, det_normal, det_rot)
    stangents = scalar_tangents(elements, params, source_rot, source_origin, det_centre,
                                det_normal, det_rot)
    p_stats, t_stats = _stats_and_jacobian(sprimal, stangents, spec, chunk_size, device=device,
                                           mesh=mesh)
    loss, dloss = _loss_from_stats(p_stats, spec, _total_weight(spec))
    grads = torch.as_tensor(t_stats @ dloss, dtype=torch.float32)
    K = len(elements)
    return loss, AlignmentParams(angles=grads[:3 * K].reshape(K, 3), shifts=grads[3 * K:].reshape(K, 3))


def fused_focus_loss(params, spec: FusedLossSpec, elements, source_rot, source_origin, det_centre,
                     det_normal, det_rot, chunk_size: int = GRAD_CHUNK, *, device) -> float:
    """The focus loss alone, through one K7 launch over every chunk (for
    line searches and evaluation)."""
    sprimal = chain_scalars_np(_apply_params_np(elements, params), source_rot, source_origin,
                               det_centre, det_normal, det_rot)
    stats, _ = fused_stats_params(spec, sprimal, None, _ray_chunks(spec, chunk_size), device=device)
    return _loss_from_stats(stats, spec, _total_weight(spec))[0]
