"""The program's side of each kind of request: set-up, one request served
through the port's entry point, and the answer in the form
``benchmark/reference/compare.py`` judges. A traffic file names its kind
(``"kind"``); the harness loads ``benchmark/kinds/<kind>.py``, whose
``Kind`` class it drives.

Shared here: the port's chain built from a configuration file, and its
poses saved and restored between requests."""

from __future__ import annotations

import numpy as np


def port_optics(cfg: dict) -> list:
    """The configuration's optics as the port's optic objects."""
    from attosecondraytracing_tpu_torch.models import defects, masks, mirrors, supports

    def support(spec):
        if spec["kind"] == "round_hole":
            return supports.SupportRoundHole(Radius=spec["Radius"], RadiusHole=spec["RadiusHole"],
                                             CenterHoleX=spec["CenterHoleX"],
                                             CenterHoleY=spec["CenterHoleY"])
        return supports.SupportRectangle(spec["dimX"], spec["dimY"])

    out = []
    for spec in cfg["optics"]:
        if spec["kind"] == "mask":
            out.append(masks.Mask(support(spec["support"])))
            continue
        radii = mirrors.ReturnOptimalToroidalRadii(spec["focal"], spec["incidence"])
        optic = mirrors.MirrorToroidal(*radii, support(spec["support"]))
        if spec.get("zernike"):
            terms = {(int(n), int(m)): float(c) for n, m, c in spec["zernike"]}
            zernike = defects.Zernike(support(spec["support"]), terms)
            optic = mirrors.DeformedMirror(optic, [zernike])
        out.append(optic)
    return out


def place(cfg: dict, optics: list, second_distance: float):
    """The port's chain (``OEPlacement``) with the last distance given."""
    from attosecondraytracing_tpu_torch.models.placement import OEPlacement

    props = dict(cfg["source"])
    distances = list(cfg["distances_mm"][:-1]) + [float(second_distance)]
    return OEPlacement(props, optics, distances, list(cfg["incidence_deg"]),
                       list(cfg["incidence_plane_deg"]), cfg["name"])


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
    """(optics, rays alive per stage) of the request's chain for the work
    model: the reference optics placed with the request's second distance,
    its optic misaligned as the request says, an ``n_total``-ray cone."""
    import torch

    from ..reference import optics as op
    from ..work import model

    optics = op.optics_from_config(cfg)
    distances = list(cfg["distances_mm"][:-1]) + [request["second_distance_mm"]]
    poses = op.place(optics, distances, cfg["incidence_deg"], cfg["incidence_plane_deg"],
                     dtype=torch.float64, device=device)
    poses = op.misaligned(poses, request)
    return optics, model.alive_by_stage(optics, poses, n_total, float(cfg["source"]["Divergence"]),
                                        device=device)
