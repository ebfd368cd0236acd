"""What a distance scan should answer: for each checked chain, the design
arithmetic of :func:`benchmark.reference.requests.design` (its placement,
whole-source trace, transmission, autoplaced detector, quadratics and
optimal shift) on the chain at its scanned distance, the rays weighted by
the law the scan engine sums (the source's kernel law, as the align and
image references weight theirs), not the bundle's."""

from __future__ import annotations

import numpy as np
import torch

from . import requests

NO_RAYS = np.zeros(0, np.int64)


def scan(cfg, distances, checked, reported=None, *, dtype=torch.float64,
         host_dtype=torch.float64, device="cuda") -> dict:
    """``{"chains": {index: {transmission, distance, spot, duration}}}`` of
    the chains ``checked`` (indices into ``distances``). ``reported``
    (index -> the program's optimal distance [mm]), where given, is where
    each chain's spot and duration are read, as the design reads them."""
    chains = {}
    for i in checked:
        req = {"second_distance_mm": float(distances[i])}
        if reported is not None and i in reported:
            req["reported_distance_mm"] = reported[i]
        got = requests.design(cfg, req, NO_RAYS, dtype=dtype, host_dtype=host_dtype,
                              device=device, weights="index")
        chains[i] = {k: got[k] for k in ("transmission", "distance", "spot", "duration")}
    return {"chains": chains}
