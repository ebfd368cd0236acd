"""The program's side of each kind of request: set-up, one request served
through the port's entry point, what the harness keeps of it inside the
window and the answer it judges after. A traffic file names its kind
(``"kind"``); the harness loads ``benchmark/kinds/<kind>.py``, whose ``Kind``
class (a :class:`RequestKind`) it drives and whose ``compare(got, ref)``
gives the numbers that decide ``correct``.

Shared here: the port's chain built from a configuration file (each optic
and defect by its kind's module), and its poses saved and restored between
requests."""

from __future__ import annotations

import contextlib

import numpy as np

from .. import defects, optics, route, sources


def kind(name: str):
    """``benchmark/kinds/<name>.py``."""
    return route.module("kinds", name)


class RequestKind:
    """What the harness calls on every kind: ``serve(request, spans)``
    inside the window, returning what the program produced; ``units(raw)``;
    ``keep(request, raw)`` for a request the check samples, still inside the
    window; ``answer(request, kept)`` once the window has closed and the
    memory peak is read, the answer ``compare`` judges; ``reference(request,
    answer, *, dtype, host_dtype, device)``; ``least_seconds(request)``. A
    kind with nothing to defer keeps its answer (these defaults)."""

    span = "request"

    def keep(self, request, raw):
        return raw

    def answer(self, request, kept):
        return kept


def host_span(spans, name):
    return spans.span(name) if spans is not None else contextlib.nullcontext()


def port_support(spec):
    from attosecondraytracing_tpu_torch.models import supports

    if spec["kind"] == "round_hole":
        return supports.SupportRoundHole(Radius=spec["Radius"], RadiusHole=spec["RadiusHole"],
                                         CenterHoleX=spec["CenterHoleX"],
                                         CenterHoleY=spec["CenterHoleY"])
    return supports.SupportRectangle(spec["dimX"], spec["dimY"])


def port_optics(cfg: dict) -> list:
    """The configuration's optics as the port's optic objects, each made by
    its kind's module, a mirror with defects wrapped in ``DeformedMirror``."""
    from attosecondraytracing_tpu_torch.models import mirrors

    out = []
    for spec in cfg["optics"]:
        optic = optics.kind(spec["kind"]).port(spec, port_support(spec["support"]))
        found = [defects.kind(d["kind"]).port(d, port_support(spec["support"]))
                 for d in defects.specs(spec)]
        out.append(mirrors.DeformedMirror(optic, found) if found else optic)
    return out


def place(cfg: dict, optics_list: list, second_distance):
    """The port's chain (``OEPlacement``) with the last distance given, or
    the list of chains of a scan where it is a list."""
    from attosecondraytracing_tpu_torch.models.placement import OEPlacement

    props = dict(cfg["source"])
    if isinstance(second_distance, (list, tuple)):
        last = [float(x) for x in second_distance]
    else:
        last = float(second_distance)
    distances = list(cfg["distances_mm"][:-1]) + [last]
    return OEPlacement(props, optics_list, distances, list(cfg["incidence_deg"]),
                       list(cfg["incidence_plane_deg"]), cfg["name"])


def detector_options(cfg: dict) -> dict:
    """``main.main``'s detector options from the configuration's detector."""
    det = cfg["detector"]
    return {k: det[k] for k in ("ReflectionNumber", "ManualDetector", "DistanceDetector",
                                "AutoDetectorDistance", "OptFor")}


def save_poses(chain) -> list:
    return [(e.position.copy(), e.normal.copy(), e.majoraxis.copy())
            for e in chain.optical_elements]


def restore_poses(chain, saved) -> None:
    for e, (p, n, m) in zip(chain.optical_elements, saved):
        e.position = p
        e.normal = n
        e.majoraxis = m


def misalign(chain, saved, request) -> None:
    """The chain's saved poses restored, then the request's optic rolled by
    ``roll_deg`` and, where the request gives one, pitched by
    ``pitch_deg``."""
    restore_poses(chain, saved)
    chain.rotate_OE(int(request["optic"]), "roll", float(request["roll_deg"]))
    if "pitch_deg" in request:
        chain.rotate_OE(int(request["optic"]), "pitch", float(request["pitch_deg"]))


def pose_rows(chain) -> np.ndarray:
    return np.stack([np.concatenate([e.position, e.normal, e.majoraxis])
                     for e in chain.optical_elements]).astype(np.float64)


def autoplaced_detector(chain, distance: float):
    """The port's detector autoplaced ``distance`` from the chain's traced
    bundle (``Detector.autoplace``)."""
    from attosecondraytracing_tpu_torch.models.detector import Detector

    det = Detector(chain.optical_elements[-1].position)
    det.autoplace(chain.trace_final(), float(distance))
    return det


def alive_by_stage(cfg: dict, request: dict, n_total: int, device):
    """(source, optics, rays alive per stage) of the request's chain for the
    work model: the reference optics placed with the request's second
    distance, its optic misaligned as the request says, an ``n_total``-ray
    source."""
    import torch

    from ..reference import optics as op
    from ..work import model

    source = sources.of(cfg)
    ref_optics = op.optics_from_config(cfg)
    distances = list(cfg["distances_mm"][:-1]) + [request["second_distance_mm"]]
    poses = op.place(ref_optics, distances, cfg["incidence_deg"], cfg["incidence_plane_deg"],
                     dtype=torch.float64, device=device)
    poses = op.misaligned(poses, request)
    return source, ref_optics, model.alive_by_stage(source, ref_optics, poses, n_total,
                                                    device=device)
