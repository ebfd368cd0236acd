"""A/B of two builds of the kernel library in one process, on one card.

    python -m attosecondraytracing_tpu_torch.utils.kernel_ab OTHER_CSRC [--rays N] [--rounds R]

``OTHER_CSRC`` holds another version's ``csrc/`` sources (for example the
parent commit's, unpacked with ``git archive`` into a directory that
``.gitignore`` lists). They are compiled with this checkout's flags, one
``nvcc`` per source, into ``build/kernels_ab/`` and linked into a second
library beside this checkout's own. The launch-only times of K1-K5 on the
flagship at N rays (default 1e7) are then taken in turns, A B B A per
round: each window is 5 back-to-back launches between CUDA events, and the
prepared launches pick up whichever library ``ops/_cuda._lib`` holds. Prints
one line per kernel and a JSON line with each kernel's median per build and
the ratio B/A (A = this checkout, B = OTHER_CSRC) with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from ..ops import _cuda


def build_other(csrc: Path) -> Path:
    """Compile and link the ``.cu`` sources of ``csrc`` with this checkout's
    flags; returns the library's path."""
    out_dir = _cuda.BUILD_DIR.parent / "kernels_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _cuda._nvcc()
    jobs = []
    for unit in sorted(csrc.glob("*.cu")):
        obj = out_dir / f"{unit.stem}.o"
        cmd = [nvcc, *_cuda.NVCC_FLAGS, "-c", "-o", str(obj), str(unit)]
        jobs.append((obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                           text=True)))
    for obj, proc in jobs:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {obj.stem}.cu:\n{text}")
    lib = out_dir / "libkernels_other.so"
    subprocess.run([nvcc, *_cuda.ARCH, "-shared", "-o", str(lib), *(str(o) for o, _p in jobs)],
                   check=True, capture_output=True)
    return lib


def bind_k1_k5(path) -> ctypes.CDLL:
    """Load a library and bind the C interface of K1-K5 (the entry points
    every build since K5 was added has), with the record sizes checked."""
    from ..ops.fused_trace import CHAIN_T, DETECTOR_T, SOURCE_T

    lib = ctypes.CDLL(str(path))
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name, dt in (("art_chain_params_size", CHAIN_T), ("art_source_params_size", SOURCE_T),
                     ("art_detector_params_size", DETECTOR_T)):
        getattr(lib, name).restype = ctypes.c_size_t
        if getattr(lib, name)() != dt.itemsize:
            raise RuntimeError(f"{path}: {name} disagrees with this checkout's records")
    lib.art_moment_rays_per_block.restype = ci
    lib.art_error_string.argtypes = [ci]
    lib.art_error_string.restype = ctypes.c_char_p
    lib.art_launch_fused_source_trace.argtypes = [vp, vp, ci, cf, cf, vp, vp, vp, vp, vp, vp, vp]
    lib.art_launch_fused_source_moments.argtypes = [vp, vp, vp, ci, ci, ci, vp, vp, ci, vp]
    lib.art_launch_scan_moments.argtypes = [vp, vp, ci, ci, ci, vp, vp, vp, ci, vp]
    lib.art_launch_streamed_trace.argtypes = [vp, ci, ci] + [vp] * 13
    for name in ("art_launch_fused_source_trace", "art_launch_fused_source_moments",
                 "art_launch_scan_moments", "art_launch_streamed_trace"):
        getattr(lib, name).restype = ci
    return lib


def _launches(n_rays: int, device):
    """Prepared launches of K1-K5 on the flagship (round-hole mask and two
    grazing toroids in f-d-f, 25 mrad cone source) at ``n_rays`` rays."""
    from ..models import masks, mirrors, supports
    from ..models.detector import Detector
    from ..models.placement import OEPlacement
    from ..ops import fused_scan as fs
    from ..ops import fused_trace as ft

    R, r = mirrors.ReturnOptimalToroidalRadii(500.0, 80.0)
    tor = mirrors.MirrorToroidal(R, r, supports.SupportRectangle(150, 32))
    mask = masks.Mask(supports.SupportRoundHole(Radius=20, RadiusHole=7, CenterHoleX=0, CenterHoleY=0))
    props = {"Divergence": 25e-3, "SourceSize": 0, "Wavelength": 80e-6, "NumberRays": 16}
    chain = OEPlacement(props, [mask, tor, tor], [400.0, 100.0, 500.0], [0.0, 80.0, -80.0], [0.0, 0.0, 0.0])
    host = [e.to_device("cpu", torch.float64) for e in chain.optical_elements]
    spec = ft.make_source_spec("cone", np.zeros(3), np.array([1.0, 0.0, 0.0]), 25e-3, n_rays=n_rays)
    table = ft.chain_table(spec, host)
    outs, k1 = ft.prepare_fused_source_trace(table, spec, n_rays, device=device)
    k1()
    det = Detector(np.zeros(3))
    det.autoplace(ft.probe_trace(spec, host, 4096, device=device, dtype=torch.float32), 490.0)
    rot = det._plane_rotation()
    opl_ref, inv_dn = ft.chief_ray_refs(spec, host, det.centre, det.normal, device=device,
                                        dtype=torch.float32)
    bdet = ft.bake_detector(host, det.centre, det.normal, rot, opl_ref=opl_ref, inv_dn_chief=inv_dn)
    chunks = ft.source_chunks("cone", n_rays, n_rays)
    _, k2 = ft.prepare_fused_source_moments(table, spec, bdet, chunks, n_rays, device=device,
                                            gaussian_edge=float(np.exp(-2.0)))
    sspec = fs.make_scan_spec("cone", host, n_rays)
    svec = fs.scan_chain_scalars(host, spec.rot, spec.origin, det.centre, det.normal, rot)
    aux = fs.scan_aux(chunks, opl_ref, inv_dn, 0.0, spec.radius, float(np.exp(-2.0)))
    _, k5 = fs.prepare_scan_moments(sspec, svec, aux, chunks, device=device)
    bundle = ft.source_bundle(spec, n_rays, device=device)
    lab = ft.chain_table(None, host)
    _, k4 = ft.prepare_streamed_trace(lab, bundle, fresh=True, device=device)
    _, k3 = ft.prepare_streamed_trace(lab, bundle, fresh=False, device=device)
    return {"K1": k1, "K2": k2, "K3": k3, "K4": k4, "K5": k5}


def _window_ms(launch, inner=5) -> float:
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(inner):
        launch()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / inner


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("other_csrc", type=Path)
    parser.add_argument("--rays", type=float, default=1e7)
    parser.add_argument("--rounds", type=int, default=10)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab needs a CUDA card")
    device = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    libs = {"A": _cuda.library(), "B": bind_k1_k5(build_other(args.other_csrc))}
    print(f"{card}; both libraries ready in {time.perf_counter() - t0:.1f} s", flush=True)
    launches = _launches(int(args.rays), device)
    result = {}
    for key, launch in launches.items():
        times = {"A": [], "B": []}
        for lib in libs.values():
            _cuda._lib = lib
            launch()
        torch.cuda.synchronize()
        for _ in range(args.rounds):
            for name in ("A", "B", "B", "A"):
                _cuda._lib = libs[name]
                times[name].append(_window_ms(launch))
        a, b = float(np.median(times["A"])), float(np.median(times["B"]))
        result[key] = {"A_ms": a, "B_ms": b, "B_over_A": b / a}
        print(f"{key}: this build {a:.4f} ms, other build {b:.4f} ms (B/A {b / a:.4f}; "
              f"{2 * args.rounds} windows each of 5 launches at {int(args.rays)} rays)", flush=True)
    _cuda._lib = libs["A"]
    print(json.dumps({"card": card, "rays": int(args.rays), "kernels": result}), flush=True)


if __name__ == "__main__":
    main()
