"""A design evaluated from its placement to its results: ``OEPlacement``
builds the chain and its source, then ``main.main`` traces it, places and
optimizes the detector and reports transmission, spot SD and duration SD,
as the CLI does after loading a CONFIG."""

from __future__ import annotations

import contextlib
import sys

import numpy as np
import torch

from .. import sources
from ..reference import compare as judge
from . import (RequestKind, alive_by_stage, detector_options, place, port_optics, pose_rows,
               host_span)


def compare(got, ref) -> dict:
    return judge.design(got, ref)


class Kind(RequestKind):
    span = "design"

    def __init__(self, cfg, traffic, *, device, rng):
        from attosecondraytracing_tpu_torch import main as art

        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.main = art.main
        self.optics = port_optics(cfg)
        self.props = dict(cfg["source"])
        self.source = sources.of(cfg)
        self.detector_options = detector_options(cfg)
        self.analysis_options = {"verbose": False, "save_results": False}
        n = int(self.props["NumberRays"])
        sample = rng.choice(n, size=min(int(traffic["checked_rays"]), n), replace=False)
        self.sample = np.sort(sample)

    def serve(self, request, spans):
        """One design; returns what the program produced: the kept data and
        the bundle ``main.main`` traced, held by the one change to the timed
        path, a wrapper of ``trace_final`` that keeps a reference to it."""
        with host_span(spans, "placement"):
            chain = place(self.cfg, self.optics, request["second_distance_mm"])
        traced = []
        trace_final = chain.trace_final

        def keep(*args, **kwargs):
            out = trace_final(*args, **kwargs)
            traced.append(out)
            return out

        chain.trace_final = keep
        with host_span(spans, "driver"), contextlib.redirect_stdout(sys.stderr):
            kept = self.main(chain, self.props, self.detector_options, self.analysis_options,
                             device=self.device)
            if self.device.type == "cuda":
                torch.cuda.synchronize()
        # the wrapper refers to the chain's bundle: unhooked, the chain and
        # the bundle are freed as soon as the request is, not at a collection
        del chain.trace_final
        return {"chain": chain, "kept": kept, "bundle": traced[-1]}

    def units(self, raw) -> int:
        return 1

    def keep(self, request, raw) -> dict:
        """Inside the window: the sampled rays of the traced bundle, the
        results, the poses and the chain, whose source is read only after
        the window (a read builds the whole factory bundle)."""
        chain, kept = raw["chain"], raw["kept"]
        idx = torch.as_tensor(self.sample)
        out = raw["bundle"]
        p, d, opl, opl_c, alive = (x.index_select(0, idx.to(x.device)).cpu()
                                   for x in (out.p, out.d, out.opl, out.opl_c, out.alive))
        return {
            "chain": chain,
            "poses": pose_rows(chain),
            "bundle": {"p": p.double().numpy(), "d": d.double().numpy(),
                       "opl": (opl.double() - opl_c.double()).numpy(),
                       "alive": alive.numpy().astype(bool)},
            "transmission": float(kept["ETransmission"][0]),
            "distance": float(kept["Detector"][0].get_distance()),
            "spot": float(kept["SpotSizeSD"][0]),
            "duration": float(kept["DurationSD"][0]),
            "engine": chain.last_trace_engine,
        }

    def answer(self, request, kept) -> dict:
        """After the window: the sampled source read from the kept chain."""
        out = dict(kept)
        chain = out.pop("chain")
        out["source"] = self.source.program_sample(chain.source_rays, self.sample)
        return out

    def reference(self, request, answer, *, dtype, host_dtype, device):
        from ..reference import requests

        req = dict(request)
        if answer is not None:
            req["reported_distance_mm"] = answer["distance"]
        return requests.design(self.cfg, req, self.sample, dtype=dtype, host_dtype=host_dtype,
                               device=device)

    def least_seconds(self, request) -> float:
        from ..work import model

        n = int(self.props["NumberRays"])
        source, optics, alive = alive_by_stage(self.cfg, request, n, self.device)
        return model.design_seconds(source, optics, alive, n)
