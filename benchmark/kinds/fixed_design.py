"""A design at a fixed detector, as upstream ART runs a CONFIG whose
``AutoDetectorDistance`` is False: ``OEPlacement`` builds the chain and its
source, then ``main.main`` traces it, places the detector at the distance
the request sets (``setup_detector``) and reports transmission, spot SD and
duration SD there (``get_result_summary`` -> ``Detector.get_SpotAndDuration``
over every traced ray). The program's side is the design's
(:mod:`.design`) with the request's detector distance; the check holds the
design's numbers but the distance and the placement, and the program's
height map at sampled nodes against the reference's own synthesis.

Around each request the program's counters of grid maps put on a device
(``ops/fused_trace.grid_rows.packed_bytes``, ``ops/defects.grid_to.
copied_bytes``) are read into :data:`UPLOADS`, where the metric
``grid_upload_mb`` finds them; a program without those counters records
None."""

from __future__ import annotations

import time

import numpy as np

from .. import defects
from ..reference import compare as judge
from ..reference import fixed_design as ref_fixed
from . import alive_by_stage, design

#: (start, end, bytes of grid maps put on a device) of every request served,
#: the bytes None where the program has no such counters
UPLOADS: list = []
#: what the summary reads of each traced ray: point and direction (24), the
#: path pair (8), the alive flag (1)
SUMMARY_BYTES = 33
#: bytes of a grid map's packed node
NODE_BYTES = 16
#: nodes of a bilinear lookup
NODES_PER_LOOKUP = 4


def uploaded_bytes():
    """Bytes of grid maps the program has packed or copied onto a device so
    far, or None where it does not count them."""
    from attosecondraytracing_tpu_torch.ops import defects as port_defects
    from attosecondraytracing_tpu_torch.ops import fused_trace

    rows = getattr(fused_trace.grid_rows, "packed_bytes", None)
    maps = getattr(port_defects.grid_to, "copied_bytes", None)
    return None if rows is None or maps is None else rows + maps


def compare(got, ref) -> dict:
    """:func:`benchmark.reference.compare.design`'s numbers but
    ``distance`` (the detector is where the request put it) and
    ``placement`` (a chain of one mirror on the axis at incidence 0 is
    placed exactly in float32 too, so the number cannot tell the control
    from the program), and ``map``: the largest gap of a sampled node's
    height over its map's RMS."""
    out = judge.design(got, dict(ref, distance=got["distance"]))
    out.pop("distance")
    out.pop("placement")
    gaps = [0.0]
    for g, r, scale in zip(got["maps"], ref["maps"], ref["map_scales"]):
        g, r = np.asarray(g, np.float64), np.asarray(r, np.float64)
        gaps.append(float(np.max(np.abs(g - r))) / scale if g.shape == r.shape and g.size
                    else float("inf"))
    out["map"] = judge._finite(max(gaps))
    return out


class Kind(design.Kind):
    def __init__(self, cfg, traffic, *, device, rng):
        super().__init__(cfg, traffic, device=device, rng=rng)
        self.base_options = dict(self.detector_options)
        self.map_defects = ref_fixed.map_defects(cfg)
        self.nodes = []
        for _i, _j, d in self.map_defects:
            shape = defects.kind(d.kind).grid(d)
            total = shape["nx"] * shape["ny"]
            picked = np.sort(rng.choice(total, size=min(int(traffic["checked_nodes"]), total),
                                        replace=False))
            self.nodes.append(np.divmod(picked, shape["nx"]))

    def serve(self, request, spans):
        """The design's, at the request's detector distance, with the upload
        counters read around it."""
        self.detector_options = dict(self.base_options,
                                     DistanceDetector=float(request["detector_distance_mm"]))
        before, t0 = uploaded_bytes(), time.perf_counter()
        raw = super().serve(request, spans)
        after = uploaded_bytes()
        UPLOADS.append((t0, time.perf_counter(),
                        None if before is None or after is None else after - before))
        return raw

    def answer(self, request, kept) -> dict:
        """The design's answer and the heights of the program's maps at the
        sampled nodes (the maps the trace reads: ``device_defects``)."""
        chain = kept["chain"]
        out = super().answer(request, kept)
        out["maps"] = []
        for (i, j, _d), (iy, ix) in zip(self.map_defects, self.nodes):
            grid = chain.optical_elements[i].type.device_defects()[j]
            out["maps"].append(np.asarray(grid.height, np.float64)[ix, iy])
        return out

    def reference(self, request, answer, *, dtype, host_dtype, device):
        return ref_fixed.design(self.cfg, request, self.sample, self.nodes, dtype=dtype,
                                host_dtype=host_dtype, device=device)

    def least_seconds(self, request) -> float:
        """K1's trace of every ray with its outputs stored, the summary's one
        read of the bundle, and each map's nodes that the rays kept by its
        mirror touch (four a ray, at most the map's nodes) read once."""
        from ..work import model

        n = int(self.props["NumberRays"])
        source, optics, alive = alive_by_stage(self.cfg, request, n, self.device)
        ops = model.trace_ops(source, optics, alive, folded=True) + model.OPS["store"] * n
        n_bytes = (model.RAY_OUTPUT_BYTES + SUMMARY_BYTES) * n
        for i, _j, d in self.map_defects:
            total = defects.kind(d.kind).map_nodes(d)
            n_bytes += NODE_BYTES * min(NODES_PER_LOOKUP * alive[i + 1], total)
        return model.least_seconds(ops, n_bytes)
