"""What a design at a fixed detector should answer (ART's run_ART with
``AutoDetectorDistance`` False): the chain placed, the whole source traced
in blocks, the transmission of ART's Gaussian profile, the detector
autoplaced at the distance the request sets, and there the spot SD and the
duration SD of the surviving rays, unweighted (``get_result_summary`` ->
``Detector.get_SpotAndDuration``). The placement, quadratics and source
come from :mod:`.requests`; a defect backed by a map also gives the heights
of sampled nodes of its own synthesis, to hold the program's map."""

from __future__ import annotations

import torch

from .. import defects, sources
from . import optics as op
from . import requests

#: rays per block of the trace
CHUNK = 1 << 21


def map_defects(cfg) -> list:
    """(optic index, defect index, reference defect) of every defect whose
    kind synthesizes a map (its module has ``nodes``)."""
    out = []
    for i, optic in enumerate(op.optics_from_config(cfg)):
        for j, defect in enumerate(optic.defects):
            if hasattr(defects.kind(defect.kind), "nodes"):
                out.append((i, j, defect))
    return out


def design(cfg, request, sample, nodes, *, dtype=torch.float64, host_dtype=torch.float64,
           device="cuda", chunk=CHUNK):
    """One design at ``request["detector_distance_mm"]``. ``sample``: ray
    indices whose source and traced state are returned; ``nodes``: (iy, ix)
    node indices of each map defect (:func:`map_defects`) whose heights
    are returned, synthesized in the rays' ``dtype``: the program's maps are
    float32, as its rays are, so the control's come one step lower with its
    rays. ``plane``: the detector plane, on which the sampled rays are
    compared."""
    optics, placed = requests._setup(cfg, request["second_distance_mm"], dtype=host_dtype,
                                     host_dtype=host_dtype, device=device)
    poses = [op.Pose(*(t.to(dtype) for t in p)) for p in placed]
    n, source = requests._n_rays(cfg), sources.of(cfg)
    src = source.rays(0, n, n, dtype=dtype, device=device)
    w = source.bundle_weights(src)
    idx = torch.as_tensor(sample, device=device)
    sampled = source.sampled(src, w, idx)
    blocks = []
    for k0 in range(0, n, chunk):
        cut = slice(k0, k0 + chunk)
        part = op.Rays(tuple(c[cut] for c in src.p), tuple(c[cut] for c in src.d), src.opl[cut],
                       src.alive[cut])
        blocks.append(op.trace(part, optics, poses))
    del src
    out = op.Rays(tuple(torch.cat([b.p[i] for b in blocks]).to(host_dtype) for i in range(3)),
                  tuple(torch.cat([b.d[i] for b in blocks]).to(host_dtype) for i in range(3)),
                  torch.cat([b.opl for b in blocks]).to(host_dtype),
                  torch.cat([b.alive for b in blocks]))
    del blocks
    bundle = {"p": torch.stack([c[idx] for c in out.p], -1).double().cpu().numpy(),
              "d": torch.stack([c[idx] for c in out.d], -1).double().cpu().numpy(),
              "opl": out.opl[idx].double().cpu().numpy(),
              "alive": out.alive[idx].cpu().numpy()}
    alive_w = torch.where(out.alive, w, torch.zeros_like(w))
    transmission = 100.0 * float(alive_w.to(host_dtype).sum() / w.to(host_dtype).sum())
    distance = float(request["detector_distance_mm"])
    pl = op.autoplace(out, distance)
    keep = torch.nonzero(out.alive).reshape(-1)
    alive = op.Rays(tuple(c[keep] for c in out.p), tuple(c[keep] for c in out.d), out.opl[keep],
                    out.alive[keep])
    q = requests._quadratics(alive, torch.ones_like(alive.opl), pl, host_dtype)
    spot, duration = requests._spot_duration(q, 0.0)
    plane = {k: getattr(pl, k).double().cpu().numpy() for k in ("centre", "normal", "e1", "e2")}
    maps = [d for _i, _j, d in map_defects(cfg)]
    heights = [defects.kind(d.kind).nodes(d, iy, ix, dtype=dtype, device=device)
               for d, (iy, ix) in zip(maps, nodes)]
    scales = [d.params["RMS"] for d in maps]
    return {"poses": requests._pose_rows(placed), "source": sampled, "bundle": bundle,
            "transmission": transmission, "distance": distance, "spot": spot,
            "duration": duration, "plane": plane, "maps": heights, "map_scales": scales}
