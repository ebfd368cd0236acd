#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the CUDA kernels from ``csrc/``,
holds each kernel against its plain PyTorch version on the card (every
surface and all four source kinds the fused engines synthesize), drives the
port's main path (``main.main`` on the flagship chain at 1e7 rays with the
detector-distance optimizer) and its CLI path (``run_config_file`` on
``examples/CONFIG_singleparabola.py``), and checks the results. It exits
nonzero, printing no result, when there is no CUDA card, when the package is
missing beside it, or when any phase fails.

Output: the card's name and power limit, per-phase lines, then one JSON line
with each kernel's launches on the main path, its error against the plain
version and both times, and as the last line ``{"ok": true, "device":
{...}}``. A kernel's ``ms`` is its launch alone (records packed and outputs
allocated beforehand), ``plain_ms`` the plain version's whole call; both are
medians of 5 CUDA-event windows of 5 back-to-back calls each.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N_CHECK = 1 << 20        # rays per kernel-vs-plain comparison
N_TIME = 10_000_000      # rays per timed call (the main path's size)
N_SLICE = 10_000_000     # rays of the main-path run
N_CLI = 1_000_000        # rays of the CLI run
K1_SOURCE = "attosecondraytracing_tpu_torch/csrc/fused_trace.cu"


def _fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def _check(cond, msg):
    if not cond:
        _fail(msg)


def _time_ms(fn, torch, reps=5, inner=5):
    """Per-call time [ms] of ``fn``, after a warm-up: the median over
    ``reps`` CUDA-event windows, each around ``inner`` back-to-back calls (so
    the card's queue stays full and a call's host latency hides behind the
    one before)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    return sorted(times)[len(times) // 2]


def _flagship(n_rays):
    """Round-hole mask + two grazing toroids in f-d-f (the JAX package's
    flagship, __graft_entry__._flagship_chain)."""
    from attosecondraytracing_tpu_torch.models import masks, mirrors, supports
    from attosecondraytracing_tpu_torch.models.placement import OEPlacement

    R, r = mirrors.ReturnOptimalToroidalRadii(500.0, 80.0)
    tor = mirrors.MirrorToroidal(R, r, supports.SupportRectangle(150, 32))
    mask = masks.Mask(supports.SupportRoundHole(Radius=20, RadiusHole=7, CenterHoleX=0, CenterHoleY=0))
    props = {"Divergence": 25e-3, "SourceSize": 0, "Wavelength": 80e-6, "DeltaFT": 0.5,
             "NumberRays": n_rays}
    chain = OEPlacement(props, [mask, tor, tor], [400.0, 100.0, 500.0], [0.0, 80.0, -80.0],
                        [0.0, 0.0, 0.0], "flagship: mask + 2 toroidals f-d-f")
    return chain, props


def _single_parabola(n_rays):
    """examples/CONFIG_singleparabola.py's chain (plane-wave disk source)."""
    import numpy as np

    from attosecondraytracing_tpu_torch.models import mirrors, supports
    from attosecondraytracing_tpu_torch.models.placement import OEPlacement

    par = mirrors.MirrorParabolic(100, 90, supports.SupportRoundHole(30, 5, 10, 5))
    props = {"Divergence": 0, "SourceSize": 50, "Wavelength": 800e-6, "DeltaFT": 2.7,
             "NumberRays": n_rays}
    chain = OEPlacement(props, [par], [200], [0.00])
    chain.optical_elements[0].rotate_roll_by(np.rad2deg(50e-6))
    return chain


def _extended(n_rays):
    """The flagship's optics behind an extended source: a Vogel grid of
    point sources over a 0.4 mm disk, each a 10 mrad cone."""
    from attosecondraytracing_tpu_torch.models import masks, mirrors, supports
    from attosecondraytracing_tpu_torch.models.placement import OEPlacement

    R, r = mirrors.ReturnOptimalToroidalRadii(500.0, 80.0)
    tor = mirrors.MirrorToroidal(R, r, supports.SupportRectangle(150, 32))
    mask = masks.Mask(supports.SupportRoundHole(Radius=20, RadiusHole=3, CenterHoleX=0, CenterHoleY=0))
    props = {"Divergence": 10e-3, "SourceSize": 0.4, "Wavelength": 80e-6, "NumberRays": n_rays}
    return OEPlacement(props, [mask, tor, tor], [400.0, 100.0, 500.0], [0.0, 80.0, -80.0], [0.0, 0.0, 0.0])


def _square(n_rays):
    """The single parabola lit by a collimated 40 mm square grid."""
    import numpy as np

    from attosecondraytracing_tpu_torch.models import sources
    from attosecondraytracing_tpu_torch.models.chain import OpticalChain

    bundle, spec = sources.PlaneWaveSquareFused(np.zeros(3), np.array([1.0, 0.0, 0.0]), 40.0, n_rays,
                                                Wavelength=800e-6, gaussian_edge=float(np.exp(-2.0)))
    return OpticalChain(bundle, _single_parabola(16).optical_elements, source_spec=spec)


def _quadrics(n_rays):
    """Convex sphere, holed cylinder and ellipsoid: the kernels' other
    quadric surfaces, with supports that clip."""
    from attosecondraytracing_tpu_torch.models import mirrors, supports
    from attosecondraytracing_tpu_torch.models.placement import OEPlacement

    ell = mirrors.MirrorEllipsoidal(supports.SupportRectangle(80, 30),
                                    *mirrors.ReturnOptimalEllipsoidalAxes(600, 75))
    sph = mirrors.MirrorSpherical(-2000, supports.SupportRound(25))
    cyl = mirrors.MirrorCylindrical(3000, supports.SupportRectangleHole(60, 30, 3, 10, 5))
    props = {"Divergence": 30e-3, "SourceSize": 0, "Wavelength": 50e-6, "NumberRays": n_rays}
    return OEPlacement(props, [sph, cyl, ell], [300, 200, 300], [5.0, 10.0, 75.0], [0, 90, 0])


def phase_k1(torch, dev):
    """K1 against its plain version on the card, on chains that take every
    surface and source kind of the kernels: alive masks and the
    tests/test_pallas.py envelopes on rays alive in both."""
    from attosecondraytracing_tpu_torch.ops import fused_trace as ft

    errs = {}
    for name, chain in (("flagship", _flagship(N_CHECK)[0]), ("singleparabola", _single_parabola(N_CHECK)),
                        ("quadrics", _quadrics(N_CHECK)), ("extended", _extended(N_CHECK)),
                        ("square", _square(N_CHECK))):
        chain.to(dev)
        spec = chain.source_spec.baked()
        n = chain.source_spec.n_rays
        table = ft.chain_table(spec, chain.device_elements(torch.float64))
        ker = ft.fused_source_trace(table, spec, n, device=dev)
        torch.cuda.synchronize()
        ref = ft.fused_source_trace_ref(table, spec, n, device=dev)
        mismatch = float((ker.alive != ref.alive).double().mean())
        both = ker.alive & ref.alive
        dp = (ker.p[both] - ref.p[both]).abs()
        dopl = ((ker.opl - ker.opl_c)[both] - (ref.opl - ref.opl_c)[both]).abs()
        dinc = (ker.incidence[both] - ref.incidence[both]).abs()
        med, mx = float(dp.median()), float(dp.max())
        print(f"K1 {name} ({spec.kind} source): {int(ker.alive.sum())}/{n} alive, alive mismatch {mismatch:.3g}, "
              f"|dp| median {med:.3g} max {mx:.3g} mm, |d opl| max {float(dopl.max()):.3g} mm, "
              f"|d incidence| max {float(dinc.max()):.3g} rad", flush=True)
        _check(int(both.sum()) > 0, f"K1 {name}: no ray alive")
        _check(mismatch <= 1e-4, f"K1 {name}: alive masks differ on {mismatch} of rays")
        _check(med <= 1e-3 and mx <= 5e-2, f"K1 {name}: position envelope {med}/{mx} mm")
        _check(float(dopl.max()) <= 0.1, f"K1 {name}: optical path differs by {float(dopl.max())} mm")
        _check(float(dinc.max()) <= 1e-4, f"K1 {name}: incidence differs by {float(dinc.max())} rad")
        errs[name] = mx
        if name == "flagship":
            flagship_table, flagship_spec = table, spec
    _, launch = ft.prepare_fused_source_trace(flagship_table, flagship_spec, N_TIME, device=dev)
    ms = _time_ms(launch, torch)
    wrapper_ms = _time_ms(lambda: ft.fused_source_trace(flagship_table, flagship_spec, N_TIME, device=dev),
                          torch)
    plain_ms = _time_ms(lambda: ft.fused_source_trace_ref(flagship_table, flagship_spec, N_TIME, device=dev),
                        torch)
    print(f"K1 flagship at {N_TIME} rays: kernel launch {ms:.4f} ms, whole wrapper {wrapper_ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms", flush=True)
    return {"max_abs_err": max(errs.values()), "ms": ms, "plain_ms": plain_ms}


def phase_k2(torch, dev):
    """K2 against its plain version on the card at 1e7 rays, on the flagship
    (cone source, 2 chunks of 2^23 rays) and on an extended source (chunks
    on whole sub-sources): sum of weights and the tests/test_stats_kernel.py
    tolerances on the statistics at 5 distances."""
    import numpy as np

    from attosecondraytracing_tpu_torch.models.detector import Detector
    from attosecondraytracing_tpu_torch.ops import fused_trace as ft

    spot_err = 0.0
    for name, chain in (("flagship", _flagship(N_CHECK)[0]), ("extended", _extended(N_CHECK))):
        chain.to(dev)
        info = chain.source_spec
        elements = chain.device_elements(torch.float64)
        out = chain.trace_final(engine="fused")
        det = Detector(np.zeros(3))
        det.autoplace(out, 490.0)
        # the same source at 1e7 rays, described without building its bundle
        spec = ft.make_source_spec(info.kind, info.origin, info.axis, info.param,
                                   diameter=info.diameter, n_rays=N_TIME)
        n = spec.n_sources * spec.n_each if info.kind == "extended" else N_TIME
        table = ft.chain_table(spec, elements)
        opl_ref, inv_dn = ft.chief_ray_refs(spec, elements, det.centre, det.normal,
                                            device=dev, dtype=torch.float32)
        bdet = ft.bake_detector(elements, det.centre, det.normal, det._plane_rotation(),
                                opl_ref=opl_ref, inv_dn_chief=inv_dn)
        chunks = ft.source_chunks(spec.kind, n, n, n_each=spec.n_each, n_sources=spec.n_sources)
        _check(len(chunks) == 2, f"K2 {name}: expected 2 chunks at {n} rays, got {len(chunks)}")
        kw = dict(device=dev, gaussian_edge=info.gaussian_edge, centre_distance=0.0)

        ker = ft.fused_source_moments(table, spec, bdet, chunks, n, **kw)
        ref = ft.fused_source_moments_ref(table, spec, bdet, chunks, n, **kw)
        rel_w = abs(ker[0] - ref[0]) / abs(ref[0])
        distances = (-20.0, -5.0, 0.0, 5.0, 20.0)
        sk = ft.sums_to_stats(ft.moments_to_distance_sums(ker, distances), opl_ref, distances)
        sr = ft.sums_to_stats(ft.moments_to_distance_sums(ref, distances), opl_ref, distances)
        print(f"K2 {name} ({spec.kind} source) {n} rays in chunks of {[c[0] for c in chunks]}: "
              f"sum w {ker[0]:.9g} vs {ref[0]:.9g} (rel {rel_w:.3g})", flush=True)
        _check(rel_w <= 1e-5, f"K2 {name}: sum of weights differs by {rel_w} (rel)")
        for j, dist in enumerate(distances):
            s_k, s_r = sk["spot_sd"][j], sr["spot_sd"][j]
            d_k, d_r = sk["duration_sd"][j], sr["duration_sd"][j]
            print(f"K2 {name} d={dist:+.0f} mm: spot {s_k:.6g} vs {s_r:.6g} mm, "
                  f"duration {d_k:.6g} vs {d_r:.6g} fs", flush=True)
            _check(abs(s_k - s_r) <= 2e-3 * abs(s_r) + 1e-6, f"K2 {name}: spot SD at {dist} mm: {s_k} vs {s_r}")
            _check(abs(d_k - d_r) <= 0.025 * d_r or abs(d_k**2 - d_r**2) ** 0.5 <= 0.8,
                   f"K2 {name}: duration SD at {dist} mm: {d_k} vs {d_r}")
            spot_err = max(spot_err, abs(s_k - s_r))
        if name == "flagship":
            _, launch = ft.prepare_fused_source_moments(table, spec, bdet, chunks, n, **kw)
            ms = _time_ms(launch, torch)
            wrapper_ms = _time_ms(lambda: ft.fused_source_moments(table, spec, bdet, chunks, n, **kw), torch)
            plain_ms = _time_ms(lambda: ft.fused_source_moments_ref(table, spec, bdet, chunks, n, **kw), torch)
            print(f"K2 flagship at {n} rays: kernel launch {ms:.4f} ms, whole wrapper {wrapper_ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms", flush=True)
    return {"max_abs_err": spot_err, "ms": ms, "plain_ms": plain_ms}


def phase_slice(torch, dev):
    """The main path: main.main on the flagship at 1e7 rays with the
    detector-distance optimizer; both kernels must launch."""
    from attosecondraytracing_tpu_torch import main as art
    from attosecondraytracing_tpu_torch.ops import fused_trace as ft

    chain, props = _flagship(N_SLICE)
    do = {"ReflectionNumber": -1, "DistanceDetector": 500.0, "AutoDetectorDistance": True,
          "OptFor": "intensity"}
    ao = {"verbose": True, "save_results": False}
    ft.fused_source_trace.launches = 0
    ft.fused_source_moments.launches = 0
    t0 = time.perf_counter()
    kept = art.main(chain, props, do, ao, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"K1": ft.fused_source_trace.launches, "K2": ft.fused_source_moments.launches}
    transmission = kept["ETransmission"][0]
    det = kept["Detector"][0]
    spot, duration = kept["SpotSizeSD"][0], kept["DurationSD"][0]
    print(f"slice: engine {chain.last_trace_engine}, launches {launches}, transmission "
          f"{transmission:.6g} %, distance {det.get_distance():.6g} mm, spot SD {spot:.6g} mm, "
          f"duration SD {duration:.6g} fs, main.main wall {wall:.3f} s", flush=True)
    _check(chain.last_trace_engine == "cuda-source", f"trace engine {chain.last_trace_engine}")
    _check(launches["K1"] >= 1 and launches["K2"] >= 1, f"kernels not launched on the main path: {launches}")
    _check(0 < transmission <= 100, f"transmission {transmission}")
    _check(abs(det.get_distance() - 500.0) <= 25.0, f"optimal distance {det.get_distance()}")
    _check(spot < 0.5, f"spot SD {spot} mm")

    # warm wall times of the two stages (outside the counted run)
    t0 = time.perf_counter()
    bundle = chain.trace_final()
    torch.cuda.synchronize()
    t_trace = time.perf_counter() - t0
    det0 = art.setup_detector(chain, art.complete_defaults({}, do, {})[1], bundle)
    t0 = time.perf_counter()
    art.optimize_detector_fused(chain, det0, art.complete_defaults({}, do, {})[1], verbose=False)
    torch.cuda.synchronize()
    t_opt = time.perf_counter() - t0
    print(f"slice warm wall: trace_final {t_trace * 1e3:.3f} ms, optimizer {t_opt * 1e3:.3f} ms",
          flush=True)
    return launches


def phase_cli(torch):
    """run_config_file on CONFIG_singleparabola.py at 1e6 rays, on the card
    and on the CPU (plain versions) in this process."""
    from attosecondraytracing_tpu_torch.main import run_config_file

    path = str(ROOT / "examples" / "CONFIG_singleparabola.py")
    res = {}
    for dev in ("cuda", "cpu"):
        kept = run_config_file(path, n_rays=N_CLI, device=dev)
        res[dev] = (kept["ETransmission"][0], kept["SpotSizeSD"][0], kept["DurationSD"][0])
    (tg, sg, dg), (tc, sc, dc) = res["cuda"], res["cpu"]
    print(f"CLI singleparabola {N_CLI} rays: cuda T {tg:.6g} % spot {sg:.6g} mm duration {dg:.6g} fs; "
          f"cpu T {tc:.6g} % spot {sc:.6g} mm duration {dc:.6g} fs", flush=True)
    _check(abs(tg - tc) <= 0.05, f"CLI transmission {tg} vs {tc}")
    _check(abs(sg - sc) <= 1e-3 * abs(sc), f"CLI spot SD {sg} vs {sc}")
    _check(abs(dg - dc) <= 1e-2 * abs(dc), f"CLI duration SD {dg} vs {dc}")


def main():
    try:
        import torch
    except ImportError:
        _fail("torch is not installed")
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False: this smoke run needs a CUDA card")
    if not (ROOT / "attosecondraytracing_tpu_torch").is_dir():
        _fail("attosecondraytracing_tpu_torch/ is missing beside chip_smoke.py; run from a checkout")
    sys.path.insert(0, str(ROOT))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}",
          flush=True)
    dev = torch.device("cuda", 0)

    from attosecondraytracing_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    _cuda.library()
    print(f"kernel library ready in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_cuda.build_seconds:.2f} s)", flush=True)
    for line in _cuda.build_log_path().read_text().splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print("ptxas:", line.strip(), flush=True)

    k1 = phase_k1(torch, dev)
    k2 = phase_k2(torch, dev)
    launches = phase_slice(torch, dev)
    phase_cli(torch)
    _check("jax" not in sys.modules, "jax was imported")

    kernels = [
        {"name": "K1 fused_source_trace", "route": "cuda", "source": K1_SOURCE,
         "replaces": "attosecondraytracing_tpu/ops/pallas_trace.py:476",
         "launches": launches["K1"], **k1},
        {"name": "K2 fused_source_moments", "route": "cuda", "source": K1_SOURCE,
         "replaces": "attosecondraytracing_tpu/ops/pallas_trace.py:979",
         "launches": launches["K2"], **k2},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
