"""Kinds of source, one module each, found by the configuration's
``source.kind`` (default ``point_cone``). A module holds, for its kind,
functions of the configuration's ``source`` dict:

* ``rays_at(spec, k, n_total, *, dtype)``: the reference's rays of indices
  ``k`` (int64) of an ``n_total``-ray source;
* ``index_weights(spec, k, n_total, *, dtype)`` and
  ``index_weight_total(spec, n_total)``: the weight law the fused kernels
  give ray k, and its sum over the source;
* ``bundle_weights(spec, rays)``: the intensity ART's factory applies to a
  whole bundle (the design's source);
* ``OPS_PER_RAY``: the work model's operations to make one ray;
* ``sampled(spec, rays, weights, idx)`` and ``program_sample(spec, bundle,
  idx)``: the sampled source's fields the design check compares, from the
  reference's rays and from the port's bundle."""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import route

DEFAULT = "point_cone"


def kind(name: str):
    return route.module("sources", name)


class Source(NamedTuple):
    """A configuration's source: its dict and its kind's module."""

    spec: dict
    module: object

    def rays_at(self, k, n_total: int, *, dtype):
        return self.module.rays_at(self.spec, k, n_total, dtype=dtype)

    def rays(self, k0: int, n: int, n_total: int, *, dtype, device):
        """Rays ``k0 .. k0 + n - 1``."""
        k = torch.arange(k0, k0 + n, dtype=torch.int64, device=device)
        return self.rays_at(k, n_total, dtype=dtype)

    def index_weights(self, k0: int, n: int, n_total: int, *, dtype, device):
        """Weights of rays ``k0 .. k0 + n - 1`` by the kernels' law."""
        k = torch.arange(k0, k0 + n, dtype=torch.int64, device=device)
        return self.module.index_weights(self.spec, k, n_total, dtype=dtype)

    def index_weight_total(self, n_total: int) -> float:
        return self.module.index_weight_total(self.spec, n_total)

    def bundle_weights(self, rays):
        return self.module.bundle_weights(self.spec, rays)

    def ops_per_ray(self) -> float:
        return self.module.OPS_PER_RAY

    def sampled(self, rays, weights, idx) -> dict:
        return self.module.sampled(self.spec, rays, weights, idx)

    def program_sample(self, bundle, idx) -> dict:
        return self.module.program_sample(self.spec, bundle, idx)


def of(cfg: dict) -> Source:
    spec = cfg["source"]
    return Source(spec, kind(spec.get("kind", DEFAULT)))
