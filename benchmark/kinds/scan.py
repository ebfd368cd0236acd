"""A distance scan, as the CLI runs ``examples/CONFIG_2toroidals_f-x-f.py``:
``OEPlacement`` with the last distance a list builds one chain per scanned
distance, and ``main.main`` takes the list through the scan engine (kernel
K5: per chain a probe trace places the detector, and the detector optimizer
runs on K5's moment passes), reporting each chain's transmission, optimal
distance, spot SD and duration SD."""

from __future__ import annotations

import contextlib
import sys

import numpy as np
import torch

from ..reference import compare as judge
from . import RequestKind, alive_by_stage, detector_options, host_span, place, port_optics

RESULTS = ("transmission", "distance", "spot", "duration")


def compare(got, ref) -> dict:
    """Each number of :func:`benchmark.reference.compare.design_results`,
    the largest over the checked chains (infinite where the program reports
    no such chain)."""
    out = dict.fromkeys(RESULTS, 0.0)
    for index, expected in ref["chains"].items():
        reported = got["chains"].get(index)
        numbers = (judge.design_results(reported, expected) if reported is not None
                   else dict.fromkeys(RESULTS, float("inf")))
        out = {k: max(out[k], numbers[k]) for k in RESULTS}
    return out


class Kind(RequestKind):
    span = "scan"

    def __init__(self, cfg, traffic, *, device, rng):
        from attosecondraytracing_tpu_torch import main as art

        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.main = art.main
        self.optics = port_optics(cfg)
        self.props = dict(cfg["source"])
        self.detector_options = detector_options(cfg)
        self.analysis_options = {"verbose": False, "save_results": False}
        self.n_checked = int(traffic["checked_chains"])

    def checked(self, request) -> list:
        """The chains a check holds: ``checked_chains`` of them, drawn by the
        request's ``chain_sample`` (so each request, and each seed of the
        control's readings, holds its own)."""
        n = int(request["scan_points"])
        rng = np.random.default_rng(int(request["chain_sample"]))
        return sorted(int(i) for i in rng.choice(n, size=min(self.n_checked, n), replace=False))

    def distances(self, request) -> list:
        """The scanned last distances [mm]: the configuration's range in
        ``scan_points`` even steps, shifted by the request's offset."""
        lo, hi = self.cfg["distances_mm"][-1]
        grid = np.linspace(float(lo), float(hi), int(request["scan_points"]))
        return [float(x) for x in grid + float(request["offset_mm"])]

    def serve(self, request, spans):
        """One scan; returns ``main.main``'s kept data and the chains."""
        with host_span(spans, "placement"):
            chains = place(self.cfg, self.optics, self.distances(request))
        with host_span(spans, "driver"), contextlib.redirect_stdout(sys.stderr):
            kept = self.main(chains, self.props, self.detector_options, self.analysis_options,
                             device=self.device)
            if self.device.type == "cuda":
                torch.cuda.synchronize()
        return {"chains": chains, "kept": kept}

    def units(self, raw) -> int:
        return 1

    def keep(self, request, raw) -> dict:
        kept = raw["kept"]
        chains = {i: {"transmission": float(kept["ETransmission"][i]),
                      "distance": float(kept["Detector"][i].get_distance()),
                      "spot": float(kept["SpotSizeSD"][i]),
                      "duration": float(kept["DurationSD"][i])}
                  for i in range(len(kept["Detector"]))}
        engines = sorted({c.last_trace_engine for c in raw["chains"]}, key=str)
        return {"chains": chains, "engine": "+".join(str(e) for e in engines)}

    def reference(self, request, answer, *, dtype, host_dtype, device):
        from ..reference import scan

        checked = self.checked(request)
        reported = None
        if answer is not None:
            reported = {i: answer["chains"][i]["distance"] for i in checked
                        if i in answer["chains"]}
        return scan.scan(self.cfg, self.distances(request), checked, reported, dtype=dtype,
                         host_dtype=host_dtype, device=device)

    def least_seconds(self, request) -> float:
        """Per chain one K5 pass: the source, the trace, the weight and the
        moments at one detector plane, counted where the rays die. The
        optimizer's further passes and the probe traces are the program's
        choice and are not charged."""
        from ..work import model

        n = int(self.props["NumberRays"])
        total = 0.0
        for distance in self.distances(request):
            source, optics, alive = alive_by_stage(self.cfg, {"second_distance_mm": distance},
                                                   n, self.device)
            ops = (model.trace_ops(source, optics, alive, folded=True)
                   + (model.OPS["weight"] + model.OPS["moments"]) * alive[-1])
            total += model.least_seconds(ops, 0.0)
        return total
