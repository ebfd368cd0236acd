"""A delay map: ``fused_source_images`` synthesizes, traces and bins a
giga-ray cone through the chain whose optic the request rolled (the chief
ray and the window's probe on the host's side, then one K1i launch on the
card)."""

from __future__ import annotations

import numpy as np
import torch

from ..reference import compare as judge
from . import (RequestKind, alive_by_stage, autoplaced_detector, host_span, misalign, place,
               port_optics, save_poses)


def compare(got, ref) -> dict:
    return judge.image(got, ref)


class Kind(RequestKind):
    span = "image"

    def __init__(self, cfg, traffic, *, device, rng):
        from attosecondraytracing_tpu_torch.analysis.gigascan import fused_source_images

        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.images = fused_source_images
        fixed = traffic["fixed"]
        self.chain = place(cfg, port_optics(cfg), fixed["second_distance_mm"]).to(device)
        self.detector = autoplaced_detector(self.chain, cfg["detector"]["DistanceDetector"])
        self.saved = save_poses(self.chain)

    def serve(self, request, spans):
        """One image; returns ``fused_source_images``' result."""
        misalign(self.chain, self.saved, request)
        with host_span(spans, "fused_source_images"):
            res = self.images(self.chain.source_spec, self.chain.device_elements(torch.float32),
                              self.detector, n_total=int(request["n_total"]),
                              bins=tuple(int(b) for b in request["bins"]))
            if self.device.type == "cuda":
                torch.cuda.synchronize()
        return res

    def units(self, raw) -> int:
        return 1

    def keep(self, request, raw) -> dict:
        lo, hi = raw["extent"]
        return {"image": np.asarray(raw["image"], np.float64),
                "mean_delay": np.asarray(raw["mean_delay"], np.float64),
                "sum_w": float(raw["sum_w"]),
                "extent": (np.asarray(lo, np.float64), np.asarray(hi, np.float64))}

    def reference(self, request, answer, *, dtype, host_dtype, device):
        from ..reference import requests

        if answer is not None:
            request = dict(request, window=answer["extent"])
        return requests.image(self.cfg, request, n_total=int(request["n_total"]),
                              bins=request["bins"], probe_rays=int(request["probe_rays"]),
                              dtype=dtype, host_dtype=host_dtype, device=device)

    def least_seconds(self, request) -> float:
        from ..work import model

        source, optics, alive = alive_by_stage(self.cfg, request, int(request["n_total"]),
                                               self.device)
        return model.image_seconds(source, optics, alive, int(np.prod(request["bins"])))
