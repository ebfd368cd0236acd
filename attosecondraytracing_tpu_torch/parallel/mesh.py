"""Shard meshes, sharded kernel passes and batched parameter scans
(counterpart of the JAX package's ``parallel/mesh.py``).

The domain's two parallel axes:

* ``rays``: rays never interact; the only cross-ray operations are the
  detector reductions. A sharded pass traces each shard's slice of the
  global Vogel spiral (its ``(phase, k_frac)`` offsets,
  :func:`shard_source_offsets`) through the same kernel as an unsharded
  pass (K2, K5, K6, K1i; their plain versions on the CPU), and only float64
  partial rows leave a shard: 16 moments, 7 sums and their tangents, or two
  images.
* ``scan``: the chains of a parameter scan, stacked on a leading axis
  (:func:`stack_chains`) and traced by one plain trace (:func:`trace_scan`).

A :class:`Mesh` is a ``('scan', 'rays')`` grid of shards, each with a
global index and a device, in one of two modes behind one code path:

* one process, several shards (:func:`make_mesh` with its ``devices``,
  which may repeat: ``["cpu"] * 8`` and ``["cuda:0"] * 4`` are meshes): the
  process launches each shard's pass in turn;
* one shard per process under ``torch.distributed`` (:func:`make_mesh` with
  ``group=``, one process per card as ``torchrun`` starts them, or several
  on one card): each rank launches its own shard.

Either way the partial rows are gathered over the group (``all_gather``,
when there is one) and summed on the host in float64 in global shard order,
so every rank gets the same answer as a one-process mesh of as many shards.
"""

from __future__ import annotations

import sys
from typing import NamedTuple

import numpy as np
import torch

from ..ops import fused_trace as ft
from ..ops.bundle import RayBundle, pad_bundle
from ..ops.precision import default_dtype, resolve_device
from ..ops.trace import MirrorElement, trace

AXES = ("scan", "rays")


class Mesh:
    """A ``('scan', 'rays')`` grid of ``scan * rays`` shards (global index
    ``i`` at scan row ``i // rays``, ray column ``i % rays``). ``shards``
    and ``devices`` are this process's shards and their devices (every
    shard in one process; the rank's own under a process ``group``)."""

    axis_names = AXES

    def __init__(self, scan: int, rays: int, shards, devices, group=None):
        self.shape = {"scan": int(scan), "rays": int(rays)}
        self.size = int(scan) * int(rays)
        self.shards = tuple(int(i) for i in shards)
        self.devices = tuple(devices)
        self.group = group

    def local(self):
        """(global index, device) of each of this process's shards."""
        return zip(self.shards, self.devices)

    def coords(self, shard: int):
        """(scan row, ray column) of a shard."""
        return divmod(shard, self.shape["rays"])


def distributed_init(**kwargs):
    """``torch.distributed.init_process_group(**kwargs)``, NCCL where a
    card is present and gloo otherwise unless ``backend`` is given.

    A failure (no rendezvous configured, already initialized) is said on
    stderr, not swallowed: a multi-process job that went on single-process
    would trace one share of the rays and report wrong statistics. Returns
    True when the process group is up."""
    import torch.distributed as dist

    kwargs.setdefault("backend", "nccl" if torch.cuda.is_available() else "gloo")
    try:
        dist.init_process_group(**kwargs)
        return True
    except (ValueError, RuntimeError) as exc:
        print(
            f"[attosecondraytracing_tpu_torch] torch.distributed.init_process_group failed "
            f"({type(exc).__name__}: {exc}); continuing single-host. This is fine for "
            f"single-process runs, but a multi-process launch reaching this path would "
            f"compute on one process only.",
            file=sys.stderr,
            flush=True,
        )
        return False


def _cuda_devices():
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device; name the devices (e.g. devices=['cpu'] * 8)")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(rays: int | None = None, scan: int = 1, devices=None, *, group=None) -> Mesh:
    """A ``('scan', 'rays')`` mesh; ``rays=None`` puts every shard left on
    the ray axis.

    Without ``group`` the mesh is this process's ``devices`` (default: every
    CUDA card), one shard each. With a process ``group`` (e.g.
    ``torch.distributed.group.WORLD``) it has one shard per rank, this
    rank's on its one device (default: card ``rank % device_count``)."""
    if group is None:
        devices = _cuda_devices() if devices is None else [resolve_device(d) for d in devices]
        shards = range(len(devices))
        n = len(devices)
    else:
        import torch.distributed as dist

        n, rank = dist.get_world_size(group), dist.get_rank(group)
        if devices is None:
            devices = [_cuda_devices()[rank % torch.cuda.device_count()]]
        elif isinstance(devices, (str, torch.device)):
            devices = [resolve_device(devices)]
        else:
            devices = [resolve_device(d) for d in devices]
        if len(devices) != 1:
            raise ValueError(f"a rank of a process group holds one shard, got devices {devices}")
        shards = (rank,)
    if rays is None:
        rays = n // scan
    if scan * rays != n:
        raise ValueError(f"scan*rays = {scan}*{rays} != {n} devices")
    return Mesh(scan, rays, shards, devices, group)


def _default_mesh(device):
    """The mesh a pass on ``device`` shards over when asked to: the process
    group's (one shard per rank, on ``device``) when ``torch.distributed``
    is initialized, else every card of this process when ``device`` is a
    card; None for the CPU of a single process."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return make_mesh(devices=[device], group=dist.group.WORLD)
    if torch.device(device).type == "cuda":
        return make_mesh()
    return None


def _sum_rows(mesh: Mesh, rows) -> np.ndarray:
    """This process's float64 partial ``rows`` (one array per local shard,
    all of one shape), gathered over the mesh's group and summed on the host
    in global shard order."""
    local = torch.as_tensor(np.stack([np.asarray(r, np.float64) for r in rows]))
    if mesh.group is None:
        every = list(local)
    else:
        import torch.distributed as dist

        if dist.get_backend(mesh.group) == "nccl":
            local = local.to(mesh.devices[0])
        parts = [torch.empty_like(local) for _ in range(dist.get_world_size(mesh.group))]
        dist.all_gather(parts, local, group=mesh.group)
        every = [row for part in parts for row in part.cpu()]
    total = every[0].numpy().copy()
    for row in every[1:]:
        total += row.numpy()
    return total


# ---------------------------------------------------------------------------
# sharded bundles and the plain trace per shard
# ---------------------------------------------------------------------------


class ShardSlice(NamedTuple):
    """A local shard's part of a (stacked) bundle: its global index, its
    device, its chains of a stacked scan and its rays."""

    shard: int
    device: torch.device
    chains: slice
    rays: slice


def bundle_sharding(mesh: Mesh, n_rays: int, axis: str = "rays", n_chains: int | None = None):
    """Each local shard's :class:`ShardSlice` of a bundle of ``n_rays`` rays
    sharded along the mesh ``axis`` (replicated along the other), the ray
    count padded with dead rays to a multiple of the axis size. With
    ``n_chains`` (a stacked scan) the chains are sharded along 'scan' too,
    and must divide it."""
    n_ax = mesh.shape[axis]
    per = -(-n_rays // n_ax)
    if n_chains is not None and n_chains % mesh.shape["scan"]:
        raise ValueError(f"number of chains {n_chains} must divide the scan axis {mesh.shape['scan']}")
    out = []
    for shard, device in mesh.local():
        s, r = mesh.coords(shard)
        i = r if axis == "rays" else s
        chains = slice(None)
        if n_chains is not None:
            per_chain = n_chains // mesh.shape["scan"]
            chains = slice(s * per_chain, (s + 1) * per_chain)
        out.append(ShardSlice(shard, device, chains, slice(i * per, (i + 1) * per)))
    return out


def shard_bundle(bundle: RayBundle, mesh: Mesh, axis: str = "rays"):
    """``[(ShardSlice, piece)]``: the bundle padded with dead rays
    (``pad_bundle``) so its ray count divides the ``axis`` size, and each
    local shard's piece on its device."""
    slices = bundle_sharding(mesh, bundle.n_rays, axis)
    padded = pad_bundle(bundle, -(-bundle.n_rays // mesh.shape[axis]) * mesh.shape[axis])
    return [(sl, RayBundle(*(x[sl.rays] if x.ndim else x for x in padded)).to(sl.device))
            for sl in slices]


def _cat_rays(bundles, ray_dim, device) -> RayBundle:
    """Bundles joined along the ray axis ``ray_dim`` on ``device`` (leaves
    without that axis, the wavelength, from the first)."""
    return RayBundle(*(torch.cat([x.to(device) for x in leaves], dim=ray_dim)
                       if leaves[0].ndim > ray_dim else leaves[0].to(device)
                       for leaves in zip(*bundles)))


def _join(mesh: Mesh, slices, outs, ray_dim: int = 0):
    """The result of a per-shard trace: in one process the shards' pieces
    joined (rays along ``ray_dim`` within a scan row, then the rows of a
    stacked scan along axis 0) on the first shard's device; in a process
    group this rank's piece."""
    if mesh.group is not None:
        return outs[0]
    device = mesh.devices[0]
    rows = {}
    for sl, out in zip(slices, outs):
        s, r = mesh.coords(sl.shard)
        rows.setdefault(s, {})[r] = out
    if ray_dim == 0:  # an unstacked bundle: replicated along 'scan', take row 0
        row = rows[0]
        return _cat_rays([row[r] for r in sorted(row)], 0, device)
    joined = [_cat_rays([rows[s][r] for r in sorted(rows[s])], ray_dim, device) for s in sorted(rows)]
    return RayBundle(*(torch.cat(leaves, dim=0) for leaves in zip(*joined)))


def trace_sharded(source: RayBundle, elements, mesh: Mesh, ignore_defects: bool = True,
                  keep_history: bool = False):
    """The plain trace with the ray axis sharded over ``mesh``: each local
    shard traces its piece of ``source`` (padded with dead rays,
    :func:`shard_bundle`) on its device in the bundle's dtype, with no
    communication. Returns the padded result (one process) or this rank's
    piece (a process group); with ``keep_history`` the list after each
    element."""
    slices, outs = [], []
    for sl, piece in shard_bundle(source, mesh):
        slices.append(sl)
        outs.append(trace(piece, ft.elements_to(elements, sl.device, piece.p.dtype),
                          ignore_defects, keep_history))
    if keep_history:
        return [_join(mesh, slices, [o[k] for o in outs]) for k in range(len(elements))]
    return _join(mesh, slices, outs)


# ---------------------------------------------------------------------------
# batched parameter scans: chains stacked on a leading axis
# ---------------------------------------------------------------------------


def scan_unbatchable(chains) -> str | None:
    """Why the chains cannot be stacked on one scan axis (different source
    ray counts, or element structures that differ beyond the poses: kinds,
    surfaces, supports, support centres, defects), or None."""
    from ..ops.fused_scan import pose_independent_signature

    if len({c.source_rays.n_rays for c in chains}) != 1:
        return "chains have different source ray counts; cannot batch the scan"
    sigs = {pose_independent_signature([e.to_device("cpu", torch.float64) for e in c.optical_elements])
            for c in chains}
    if len(sigs) != 1:
        return "chains have different element structures; cannot batch the scan"
    return None


def stack_chains(chains):
    """``(stacked_elements, stacked_sources)``: the chains' element records
    with their poses stacked on a leading scan axis (rot (C, 3, 3),
    position and centre (C, 3); surfaces, supports and defects shared) and
    their source bundles stacked likewise ((C, N, ...), wavelength (C,)),
    on the first chain's device in the trace dtype. Raises ValueError on
    chains :func:`scan_unbatchable` refuses."""
    reason = scan_unbatchable(chains)
    if reason is not None:
        raise ValueError(reason)
    device = chains[0]._device()
    dtype = default_dtype()
    stacked_elements = []
    for els in zip(*(c.device_elements(dtype) for c in chains)):
        fields = {f: torch.stack([getattr(e, f).to(device) for e in els])
                  for f in ("rot", "position") + (("centre",) if isinstance(els[0], MirrorElement) else ())}
        stacked_elements.append(els[0]._replace(**fields))
    sources = [c.source_rays.to(device, dtype) for c in chains]
    stacked_sources = RayBundle(*(torch.stack(leaves) for leaves in zip(*sources)))
    return stacked_elements, stacked_sources


def _broadcast_layout(el):
    """A stacked element record laid out for the plain trace on (C, N)
    rays: rot (3, 3, C, 1), position and centre (3, C, 1), so each entry
    the trace reads broadcasts over the chain's rays."""
    fields = {"rot": el.rot.permute(1, 2, 0)[..., None], "position": el.position.t()[..., None]}
    if isinstance(el, MirrorElement):
        fields["centre"] = el.centre.t()[..., None]
    return el._replace(**fields)


def trace_scan(stacked_sources: RayBundle, stacked_elements, ignore_defects: bool = True) -> RayBundle:
    """The final bundles of every chain of a stacked scan
    (:func:`stack_chains`) as one (C, N, ...) bundle: the plain trace run
    once on the leading axis, each element step's pose broadcast over its
    chain's rays. Chain c's rays go through the same float operations as in
    ``trace`` of chain c alone."""
    return trace(stacked_sources, [_broadcast_layout(el) for el in stacked_elements],
                 ignore_defects, keep_history=False)


def trace_scan_sharded(chains, mesh: Mesh, ignore_defects: bool = True) -> RayBundle:
    """A stacked scan traced over the ``('scan', 'rays')`` mesh: the chains
    along 'scan' (their number must divide it) and the rays along 'rays'
    (their number must divide it); each local shard runs
    :func:`trace_scan` on its block on its device. Returns the (C, N, ...)
    result (one process) or this rank's block (a process group)."""
    stacked_elements, stacked_sources = stack_chains(chains)
    n_rays = stacked_sources.n_rays
    if n_rays % mesh.shape["rays"]:
        raise ValueError(f"ray count {n_rays} must divide the rays axis {mesh.shape['rays']}")
    slices = bundle_sharding(mesh, n_rays, n_chains=len(chains))
    outs = []
    for sl in slices:
        src = RayBundle(*(x[sl.chains][:, sl.rays] if x.ndim > 1 else x[sl.chains]
                          for x in stacked_sources)).to(sl.device)
        els = [el._replace(**{f: getattr(el, f)[sl.chains].to(sl.device)
                              for f in ("rot", "position", "centre") if hasattr(el, f)})
               for el in stacked_elements]
        outs.append(trace_scan(src, els, ignore_defects))
    return _join(mesh, slices, outs, ray_dim=1)


# ---------------------------------------------------------------------------
# sharded in-kernel sources: partial rows across the mesh
# ---------------------------------------------------------------------------

_PHI_FRAC = ft._PHI_FRAC


def shard_source_offsets(n_total: int, n_devices: int):
    """``(n_local, phases, k_fracs)`` of a Vogel source split over
    ``n_devices`` shards: shard i synthesizes global rays ``[i n_local,
    (i + 1) n_local)``. ``phases = frac(offset * phi)`` formed in float64
    (the global golden angle exact on every shard) and rounded to float32;
    ``k_fracs = offset / n_total`` (float32) feeds the global radius law."""
    if n_total % n_devices:
        raise ValueError("n_total must divide evenly over the devices")
    n_local = n_total // n_devices
    phases, k_fracs = _offset_law(np.arange(n_devices) * n_local, n_total)
    return n_local, phases.astype(np.float32), k_fracs.astype(np.float32)


def _offset_law(offsets, divisor):
    """float64 ``(phases, k_fracs)`` of spiral ``offsets``: ``phase =
    frac(offset * phi)`` and ``k_frac = offset / divisor`` (the radius
    law's global ray count)."""
    offsets = np.asarray(offsets, np.float64)
    return np.mod(offsets * _PHI_FRAC, 1.0), offsets / divisor


def _refuse_unaligned(kind: str, what: str):
    """Shard offsets split a spiral only: an extended source's sub-sources
    and a square source's rows would need aligned offsets."""
    if kind in ("extended", "square"):
        raise NotImplementedError(
            f"{what} for {kind} sources need sub-source/row-aligned shard offsets; "
            "use the single-device chunked path")


def _shard_chunks(kind: str, n_local: int, shard: int, spiral_total: int):
    """The chunks ``[(n_local, phase, k_frac)]`` of shard ``shard`` of a
    spiral of ``spiral_total`` rays (radius-law divisor), split at
    ``fused_trace.CHUNK`` rays: the shard's offset composed in float64."""
    phase, k_frac = _offset_law(shard * n_local, spiral_total)
    return ft.source_chunks(kind, n_local, spiral_total, ft.CHUNK, phase=float(phase),
                            k_frac=float(k_frac))


def source_stats_sharded(spec, elements, n_total: int, mesh: Mesh, det_centre, det_normal,
                         det_rot, distances=(0.0,), gaussian_edge: float | None = None,
                         centre_distance: float = 0.0):
    """Detector statistics of ``n_total`` rays of the in-kernel source
    ``spec`` (a ``BakedSource``) over every shard of ``mesh``: each shard
    runs kernel K2 (``fused_trace.fused_source_moments``; its plain version
    on the CPU) on its slice of the global spiral, and only the 16 float64
    moments leave it. Returns ``fused_trace.sums_to_stats`` at
    ``distances`` (chief-ray references from a probe on the first shard's
    device)."""
    _refuse_unaligned(spec.kind, "sharded stats")
    if n_total % mesh.size:
        raise ValueError("n_total must divide evenly over the devices")
    n_local = n_total // mesh.size
    opl_ref, inv_dn_chief = ft.chief_ray_refs(spec, elements, det_centre, det_normal,
                                              device=mesh.devices[0], dtype=default_dtype())
    centre_distance = float(np.float32(centre_distance))
    det = ft.bake_detector(elements, det_centre, det_normal, det_rot, opl_ref=opl_ref,
                           inv_dn_chief=inv_dn_chief)
    table = ft.chain_table(spec, elements)
    rows = [ft.fused_source_moments(table, spec, det, _shard_chunks(spec.kind, n_local, shard, n_total),
                                    n_total, device=device, gaussian_edge=gaussian_edge,
                                    centre_distance=centre_distance)
            for shard, device in mesh.local()]
    sums = ft.moments_to_distance_sums(_sum_rows(mesh, rows), distances, centre_distance)
    return ft.sums_to_stats(sums, opl_ref, distances)


def source_images_sharded(spec, elements, n_total: int, mesh: Mesh, centre, normal, rot, extent,
                          bins: tuple[int, int] = (256, 256), chunk: int = 1 << 23,
                          gaussian_edge: float | None = None, opl_ref: float = 0.0,
                          wavelength: float = 50e-6, ignore_defects: bool = True):
    """Giga-ray detector images over every shard of ``mesh``: each shard
    runs kernel K1i (``fused_trace.prepare_fused_source_image``; on the CPU
    its plain version, the chunk loop) over its chunks of the global spiral,
    ``(shard * n_chunks + c) * chunk_local``, into its own pair of float64
    images, and only the images leave it. ``extent = (lo, hi)`` must be
    fixed (per-shard fitted windows would disagree); ``rot`` rows 0-1 are
    the plane's axes; delays are taken against ``opl_ref``. Returns
    ``(w_img, wd_img)``, float64 host arrays of ``bins``. ``wavelength`` is
    the JAX signature's; the images do not depend on it."""
    del wavelength
    _refuse_unaligned(spec.kind, "sharded images")
    n_dev = mesh.size
    if n_total % n_dev:
        raise ValueError("n_total must divide evenly over the devices")
    n_local = n_total // n_dev
    n_chunks = -(-n_local // chunk)
    if n_local % n_chunks:
        raise ValueError(f"per-device ray count {n_local} must split into equal chunks "
                         f"(got {n_chunks} chunks); pick n_total accordingly")
    chunk_local = n_local // n_chunks
    if chunk_local >= 1 << 24:
        raise ValueError("per-chunk ray count must stay < 2^24")
    bins = tuple(int(b) for b in bins)
    det = ft.ImageDetector(tuple(np.asarray(centre, np.float64)), tuple(np.asarray(normal, np.float64)),
                           tuple(map(tuple, np.asarray(rot, np.float64)[:2])), float(opl_ref))
    window = (np.asarray(extent[0], np.float64), np.asarray(extent[1], np.float64))
    table = ft.chain_table(spec, elements)
    rows = []
    for shard, device in mesh.local():
        phases, k_fracs = _offset_law(shard * n_local + np.arange(n_chunks) * chunk_local, n_total)
        chunks = [(chunk_local, float(p), float(k)) for p, k in zip(phases, k_fracs)]
        images = tuple(torch.zeros(bins[0] * bins[1], dtype=torch.float64, device=device)
                       for _ in range(2))
        if device.type == "cpu":
            ft.fused_source_image_ref(table, spec, chunks, n_total, det, window, bins, images,
                                      device=device, gaussian_edge=gaussian_edge,
                                      ignore_defects=ignore_defects, covers_spiral=False)
        else:
            ft.prepare_fused_source_image(table, spec, chunks, n_total, det, window, bins,
                                          device=device, gaussian_edge=gaussian_edge,
                                          ignore_defects=ignore_defects,
                                          covers_spiral=False)(images)
        rows.append(torch.stack(images).reshape(2, *bins).cpu().numpy())
    total = _sum_rows(mesh, rows)
    return total[0], total[1]


def scan_moments_sharded(spec, svec, n_total: int, mesh: Mesh, opl_ref: float, inv_dn_chief: float,
                         centre_distance: float = 0.0, radius: float = 0.0,
                         gaussian_edge: float | None = None, pos_radius: float = 0.0) -> np.ndarray:
    """The scan kernel K5 (``fused_scan.fused_scan_moments``; its plain
    version on the CPU) of one chain's pose vector ``svec`` with the ray
    axis sharded over ``mesh``: each shard synthesizes its slice of the
    global spiral (the radius-law fraction divides by the spec's global
    ``spec.n_total``, which may exceed the traced ``n_total``, as
    ``fused_scan.scan_chunks`` does) and only its 16 float64 moments leave
    it. Returns the summed moments (``fused_trace.MOMENT_FIELDS`` order),
    the contract of ``fused_scan.scan_moments``."""
    from ..ops import fused_scan as fs

    _refuse_unaligned(spec.source_kind, "sharded scan moments")
    n_dev = mesh.size
    if n_total % n_dev:
        raise ValueError("n_total must divide evenly over the devices")
    n_local = n_total // n_dev
    if n_local >= ft.MAX_RAYS_PER_CALL:
        raise ValueError("per-device ray count must stay < 2^24 (float index exactness); "
                         "use more devices or chunk")
    centre_distance = float(np.float32(centre_distance))
    rows = []
    for shard, device in mesh.local():
        phase, k_frac = _offset_law(shard * n_local, spec.n_total)
        chunks = [(n_local, float(phase), float(k_frac))]
        aux = fs.scan_aux(chunks, opl_ref, inv_dn_chief, centre_distance, radius, gaussian_edge,
                          pos_radius)
        rows.append(fs.fused_scan_moments(spec, svec, aux, chunks, device=device))
    return _sum_rows(mesh, rows)
