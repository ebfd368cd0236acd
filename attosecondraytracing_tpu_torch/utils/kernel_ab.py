"""A/B of builds of the kernel library in one process, on one card.

    python -m attosecondraytracing_tpu_torch.utils.kernel_ab OTHER_CSRC [OTHER_CSRC ...]
        [--rays N] [--rounds R] [--kernels K1,K6,...]

Each ``OTHER_CSRC`` holds another version's ``csrc/`` sources: the parent
commit's (unpacked with ``git archive`` into a directory that ``.gitignore``
lists) or a design variant (:mod:`.kernel_variants`). Each is compiled with
this checkout's flags, one ``nvcc`` per source, into
``build/kernels_ab/<i>/`` and linked into a library beside this checkout's
own; the build's ptxas lines for the runtime-pose kernels (registers,
spills) are printed. The launch-only times on the flagship at N rays
(default 1e7) are then taken in turns against this checkout (A), A B B A
per round: each window is 5 back-to-back launches between CUDA events.

* K1-K4 and K8 (20 distances) have the same C interface in every build: one
  prepared launch serves each library, picked up through ``ops/_cuda._lib``.
* K5, K7 and K6 are prepared per library. K6 is one gradient step's work:
  all 18 tangent rows of the flagship's pose vector, which a build of this
  C interface (version 2, ``art_abi_version``) takes in one launch and a
  build of the interface before it (version 1: 6 tangent rows per
  launch, a (blocks per chunk, chunks) grid) in 3 launches, through the
  adapter below. Each build's sums are compared with A's.

Prints one line per kernel and build and a JSON line with each kernel's
median per build and the ratio B/A, with the card's name and power limit.
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

KERNELS = ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8")


def build_other(csrc: Path, out_dir: Path) -> tuple[Path, str]:
    """Compile and link the ``.cu`` sources of ``csrc`` with this checkout's
    flags into ``out_dir``; returns the library's path and the ptxas lines
    of its runtime-pose kernels."""
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _cuda._nvcc()
    jobs = []
    for unit in sorted(csrc.glob("*.cu")):
        obj = out_dir / f"{unit.stem}.o"
        cmd = [nvcc, *_cuda.NVCC_FLAGS, "-c", "-o", str(obj), str(unit)]
        jobs.append((obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                           text=True)))
    log = []
    for obj, proc in jobs:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {obj.stem}.cu:\n{text}")
        log.append(text)
    lib = out_dir / "libkernels_other.so"
    subprocess.run([nvcc, *_cuda.ARCH, "-shared", "-o", str(lib), *(str(o) for o, _p in jobs)],
                   check=True, capture_output=True)
    return lib, ptxas_summary("\n".join(log))


def ptxas_summary(log: str) -> str:
    """One line per runtime-pose kernel entry (K5-K7) of a ptxas ``-v`` log:
    registers, spill stores and loads, shared memory."""
    out, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and ("scan_moments" in name or "stats_params" in name):
            if "spill stores" in line:
                out.append(f"{name}: {line.strip()}")
            elif "Used" in line and "registers" in line:
                out.append(f"{name}: {line.split(':', 1)[1].strip()}")
    return "\n".join(out)


def bind(path):
    """``(library, version)``: a library of this C interface through
    ``_cuda.load`` (version 2), or one without ``art_abi_version``
    (version 1) through :func:`bind_v1`."""
    if hasattr(ctypes.CDLL(str(path)), "art_abi_version"):
        return _cuda.load(path), 2
    return bind_v1(path), 1


def bind_v1(path) -> ctypes.CDLL:
    """Bind a library of C interface version 1: K1-K4 and K8 as
    now, K5 and K6/K7 with their version-1 signatures (a (blocks per chunk,
    chunks) grid; K6 6 tangent rows per launch), record sizes checked."""
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
    lib.art_launch_streamed_trace.argtypes = [vp, ci, ci] + [vp] * 13
    lib.art_launch_fused_source_stats.argtypes = [vp, vp, vp, ci, ci, ci, vp, vp, ci, vp, ci, vp]
    lib.art_launch_scan_moments.argtypes = [vp, vp, ci, ci, ci, vp, vp, vp, ci, vp]
    lib.art_launch_stats_params.argtypes = [vp, vp, cf, ci, ci, ci, ci, vp, vp, vp, vp, ci, ci, vp]
    for name in ("art_launch_fused_source_trace", "art_launch_fused_source_moments",
                 "art_launch_streamed_trace", "art_launch_fused_source_stats",
                 "art_launch_scan_moments", "art_launch_stats_params"):
        getattr(lib, name).restype = ci
    return lib


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _v1_scan_moments(lib, sspec, svec, aux, chunks, device):
    """(launch, result) of K5 through C interface version 1."""
    from ..ops import fused_scan as fs
    from ..ops import fused_trace as ft

    chain_rec = fs.pack_scan_chain(sspec)
    src_rec = ft.pack_source(fs._source_record(sspec), sspec.n_total)
    sizes = [c[0] for c in chunks]
    bpc = -(-sizes[0] // lib.art_moment_rays_per_block())
    svec_t = torch.as_tensor(np.asarray(svec, np.float32)).to(device)
    aux_t = torch.as_tensor(np.asarray(aux, np.float32)).to(device)
    rows = torch.empty((len(chunks) * bpc, len(ft.MOMENT_FIELDS)), dtype=torch.float64, device=device)

    def launch():
        status = lib.art_launch_scan_moments(
            chain_rec.ctypes.data, src_rec.ctypes.data, sum(sizes), sizes[0], len(chunks),
            svec_t.data_ptr(), aux_t.data_ptr(), rows.data_ptr(), bpc, _stream(device))
        _cuda._check(lib, status, "version-1 scan_moments launch")

    return launch, lambda: rows.sum(dim=0).cpu().numpy()


def _v1_stats_params(lib, spec, svec, tang, chunks, device):
    """(launch, result) of one gradient step (K6: 6 tangent rows per launch,
    ceil(P / 6) launches) or of K7 (``tang`` None) through C interface
    version 1."""
    from ..ops import fused_grad as fg

    chain_rec, src_rec = fg.pack_stats_records(spec)
    sizes = [c[0] for c in chunks]
    bpc = -(-sizes[0] // lib.art_moment_rays_per_block())
    n = len(svec)
    svec_t = torch.as_tensor(np.asarray(svec, np.float32)).to(device)
    params = torch.tensor([[c[1], c[2]] for c in chunks], dtype=torch.float32, device=device)
    groups = []
    P = 0 if tang is None else len(tang)
    for g0 in range(0, P, 6) if P else (0,):
        t = None
        if P:
            padded = np.zeros((6, n), np.float32)
            padded[:min(6, P - g0)] = tang[g0:g0 + 6]
            t = torch.as_tensor(padded).to(device)
        rows = torch.empty((len(chunks) * bpc, 7 * (1 + (6 if P else 0))), dtype=torch.float64,
                           device=device)
        groups.append((t, rows))

    def launch():
        for t, rows in groups:
            status = lib.art_launch_stats_params(
                chain_rec.ctypes.data, src_rec.ctypes.data, float(spec.opl_ref), sum(sizes),
                sizes[0], len(chunks), n, svec_t.data_ptr(), None if t is None else t.data_ptr(),
                params.data_ptr(), rows.data_ptr(), bpc, 0 if t is None else 6, _stream(device))
            _cuda._check(lib, status, "version-1 stats_params launch")

    def result():
        sums = [rows.sum(dim=0).cpu().numpy() for _t, rows in groups]
        tangents = np.concatenate([s[7:].reshape(-1, 7) for s in sums])[:P]
        return np.concatenate([sums[0][:7], tangents.reshape(-1)])

    return launch, result


def _problems(n_rays: int, device):
    """The flagship (round-hole mask and two grazing toroids in f-d-f, 25
    mrad cone source) at ``n_rays`` rays: prepared launches of K1-K4 and K8
    (any build), and ``per_lib(lib, version)`` giving each library's
    ``{kernel: (launch, result)}`` of K5, K6 (the step's 18 tangent rows of
    scripts/bench_fused_grad.py's misalignment, Gaussian edge exp(-2)) and
    K7."""
    from ..analysis import alignment as al
    from ..models import masks, mirrors, supports
    from ..models.detector import Detector
    from ..models.placement import OEPlacement
    from ..ops import fused_grad as fg
    from ..ops import fused_scan as fs
    from ..ops import fused_trace as ft

    R, r = mirrors.ReturnOptimalToroidalRadii(500.0, 80.0)
    tor = mirrors.MirrorToroidal(R, r, supports.SupportRectangle(150, 32))
    mask = masks.Mask(supports.SupportRoundHole(Radius=20, RadiusHole=7, CenterHoleX=0, CenterHoleY=0))
    props = {"Divergence": 25e-3, "SourceSize": 0, "Wavelength": 80e-6, "NumberRays": 16}
    chain = OEPlacement(props, [mask, tor, tor], [400.0, 100.0, 500.0], [0.0, 80.0, -80.0], [0.0, 0.0, 0.0])
    host = [e.to_device("cpu", torch.float64) for e in chain.optical_elements]
    edge = float(np.exp(-2.0))
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
                                            gaussian_edge=edge)
    bundle = ft.source_bundle(spec, n_rays, device=device)
    lab = ft.chain_table(None, host)
    _, k4 = ft.prepare_streamed_trace(lab, bundle, fresh=True, device=device)
    _, k3 = ft.prepare_streamed_trace(lab, bundle, fresh=False, device=device)
    distances = tuple(float(d) for d in np.linspace(-10, 10, 20))
    det20 = ft.bake_detector(host, det.centre, det.normal, rot, opl_ref=opl_ref, inv_dn_chief=inv_dn,
                             distances=distances, delay_offsets=tuple(-d * inv_dn for d in distances))
    _, k8 = ft.prepare_fused_source_stats(table, spec, det20, chunks, n_rays, device=device,
                                          gaussian_edge=edge)

    sspec = fs.make_scan_spec("cone", host, n_rays)
    svec = fs.scan_chain_scalars(host, spec.rot, spec.origin, det.centre, det.normal, rot)
    aux = fs.scan_aux(chunks, opl_ref, inv_dn, 0.0, spec.radius, edge)

    params = al.zero_params(len(host))
    params.angles[1, 0] = 2e-4
    params.shifts[1, 0] = 0.05
    geo =(np.asarray(spec.rot, np.float64), np.asarray(spec.origin, np.float64), det.centre,
           det.normal, rot)
    lspec = fg.FusedLossSpec(source_kind="cone", source_radius=float(spec.radius),
                             elements=tuple(host), opl_ref=float(opl_ref), gaussian_edge=edge,
                             n_rays=n_rays, duration_weight=0.0, survival_weight=1.0)
    gsvec = fg.chain_scalars_np(fg._apply_params_np(host, params), *geo)
    tang = fg.scalar_tangents(host, params, *geo)
    gchunks = fg._ray_chunks(lspec, fg.GRAD_CHUNK)

    def per_lib(lib, version):
        if version == 1:
            return {"K5": _v1_scan_moments(lib, sspec, svec, aux, chunks, device),
                    "K6": _v1_stats_params(lib, lspec, gsvec, tang, gchunks, device),
                    "K7": _v1_stats_params(lib, lspec, gsvec, None, gchunks, device)}
        _cuda._lib = lib  # K6's rows follow this library's tangent batch
        rows5, k5 = fs.prepare_scan_moments(sspec, svec, aux, chunks, device=device)
        rows6, k6 = fg.prepare_stats_params(lspec, gsvec, tang, gchunks, device=device)
        rows7, k7 = fg.prepare_stats_params(lspec, gsvec, None, gchunks, device=device)

        def grad_result(rows, P):
            p, t = fg.params_from_rows(rows, P)
            return np.concatenate([p, t.reshape(-1)])

        return {"K5": (k5, lambda: rows5.sum(dim=0).cpu().numpy()),
                "K6": (k6, lambda: grad_result(rows6, len(tang))),
                "K7": (k7, lambda: grad_result(rows7, 0))}

    return {"K1": k1, "K2": k2, "K3": k3, "K4": k4, "K8": k8}, per_lib


def _window_ms(launch, inner=5) -> float:
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(inner):
        launch()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / inner


def _difference(key, a, b) -> str:
    """B's sums against A's: the largest difference relative to the largest
    entry of each statistic (K6: primal and tangent sums apart)."""
    if key == "K6":
        pa, ta = a[:7], a[7:].reshape(-1, 7)
        pb, tb = b[:7], b[7:].reshape(-1, 7)
        scale = np.maximum(np.abs(ta).max(axis=0), 1e-300)
        return (f"primal sums rel {np.max(np.abs(pb - pa) / np.abs(pa)):.3g}, tangents within "
                f"{np.max(np.abs(tb - ta) / scale):.3g} of each statistic's largest")
    return f"sums rel {np.max(np.abs(b - a) / np.maximum(np.abs(a), 1e-300)):.3g}"


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("other_csrc", type=Path, nargs="+")
    parser.add_argument("--rays", type=float, default=1e7)
    parser.add_argument("--rounds", type=int, default=10)
    parser.add_argument("--kernels", default=",".join(KERNELS))
    args = parser.parse_args(argv)
    keys = [k for k in args.kernels.split(",") if k]
    if not set(keys) <= set(KERNELS):
        raise SystemExit(f"--kernels takes {KERNELS}")
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab needs a CUDA card")
    device = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    lib_a = _cuda.library()
    print(ptxas_summary(_cuda.build_log_path().read_text()), flush=True)
    others = []
    for i, csrc in enumerate(args.other_csrc):
        path, regs = build_other(csrc, _cuda.BUILD_DIR.parent / "kernels_ab" / str(i))
        lib, version = bind(path)
        print(f"B{i} = {csrc} (C interface version {version})\n{regs}", flush=True)
        others.append((f"B{i}", str(csrc), lib, version))
    print(f"{card}; {1 + len(others)} libraries ready in {time.perf_counter() - t0:.1f} s", flush=True)
    shared, per_lib = _problems(int(args.rays), device)
    own = {"A": per_lib(lib_a, 2)}
    for name, _csrc, lib, version in others:
        own[name] = per_lib(lib, version)
    _cuda._lib = lib_a
    result = {}
    for key in keys:
        for name, csrc, lib, _version in others:
            libs = {"A": lib_a, "B": lib}
            if key in shared:
                launch = {"A": shared[key], "B": shared[key]}
                outcome = None
            else:
                launch = {"A": own["A"][key][0], "B": own[name][key][0]}
                outcome = {"A": own["A"][key][1], "B": own[name][key][1]}
            times = {"A": [], "B": []}
            for ab in ("A", "B"):
                _cuda._lib = libs[ab]
                launch[ab]()
            torch.cuda.synchronize()
            for _ in range(args.rounds):
                for ab in ("A", "B", "B", "A"):
                    _cuda._lib = libs[ab]
                    times[ab].append(_window_ms(launch[ab]))
            _cuda._lib = lib_a
            a, b = float(np.median(times["A"])), float(np.median(times["B"]))
            result.setdefault(key, {})[name] = {"other": csrc, "A_ms": a, "B_ms": b, "B_over_A": b / a}
            diff = f"; {_difference(key, outcome['A'](), outcome['B']())}" if outcome else ""
            print(f"{key} vs {name}: this build {a:.4f} ms, other build {b:.4f} ms (B/A {b / a:.4f}; "
                  f"{2 * args.rounds} windows each of 5 launches at {int(args.rays)} rays){diff}",
                  flush=True)
    print(json.dumps({"card": card, "rays": int(args.rays), "kernels": result}), flush=True)


if __name__ == "__main__":
    main()
