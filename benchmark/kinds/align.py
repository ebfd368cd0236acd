"""A beamline alignment: ``gradient_align`` descends the pose parameters of
a chain whose optic the request misaligned, onto a detector plane autoplaced
once on the aligned chain (host ``jacfwd`` of the pose scalars and one K6
launch per Adam step on the card)."""

from __future__ import annotations

import torch

from ..reference import compare as judge
from . import (RequestKind, alive_by_stage, autoplaced_detector, host_span, misalign, place,
               port_optics, save_poses)


def compare(got, ref) -> dict:
    return judge.align(got, ref)


class Kind(RequestKind):
    span = "align"

    def __init__(self, cfg, traffic, *, device, rng):
        from attosecondraytracing_tpu_torch.analysis import alignment

        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.alignment = alignment
        fixed = traffic["fixed"]
        self.chain = place(cfg, port_optics(cfg), fixed["second_distance_mm"]).to(device)
        self.detector = autoplaced_detector(self.chain, cfg["detector"]["DistanceDetector"])
        self.saved = save_poses(self.chain)

    def serve(self, request, spans):
        """One alignment; returns the parameters, the loss history and the
        engine that ran."""
        misalign(self.chain, self.saved, request)
        with host_span(spans, "gradient_align"):
            params, history = self.alignment.gradient_align(
                self.chain, self.detector, iters=int(request["iters"]), lr=float(request["lr"]),
                survival_weight=float(request["survival_weight"]), engine=request["engine"])
            if self.device.type == "cuda":
                torch.cuda.synchronize()
        return {"params": torch.cat([params.angles, params.shifts], dim=1), "history": history,
                "engine": self.alignment.gradient_align.last_engine}

    def units(self, raw) -> int:
        return len(raw["history"])

    def keep(self, request, raw) -> dict:
        return {"params": raw["params"].double().cpu().numpy(), "history": list(raw["history"]),
                "engine": raw["engine"]}

    def reference(self, request, answer, *, dtype, host_dtype, device):
        from ..reference import requests

        return requests.align(self.cfg, request, iters=int(request["iters"]),
                              lr=float(request["lr"]),
                              survival_weight=float(request["survival_weight"]),
                              dtype=dtype, host_dtype=host_dtype, device=device)

    def least_seconds(self, request) -> float:
        from ..work import model

        n = int(self.cfg["source"]["NumberRays"])
        source, optics, alive = alive_by_stage(self.cfg, request, n, self.device)
        step = model.align_step_seconds(source, optics, alive, n, model.tangent_rows(len(optics)))
        return int(request["iters"]) * step
