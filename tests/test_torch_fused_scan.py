"""PyTorch port vs the JAX package: the scan engine. The pose vector
(``chain_scalars_np``), the plain version of kernel K5 (``scan_moments_ref``)
against the Pallas scan kernel in interpret mode, the chunk law, the
closed-form source weights, the detector optimizer fed by the scan kernel,
and the scan engine of ``main`` on a Monte-Carlo scan and on
examples/CONFIG_2toroidals_f-x-f.py.

Tolerances are those of tests/test_scan_kernel.py: sum of weights 2e-3
relative, spot SD 5e-3 relative, duration SD 3 % or 0.9 fs in quadrature
(float32 OPL noise) for moment passes (:49-55); for whole runs of ``main``, distance
within 1 mm, transmission 2 % and spot SD 10 % relative (:308-313), the
envelope within which the scan engine agrees with the serial path."""

import sys

# tests/reference_shims.py leaves stand-in modules (pyvista, colorcet, ...)
# in sys.modules whose every attribute is a stub object. Importing torch runs
# inspect.getmodule, which reads each module's __file__ and fails on them, so
# they are set aside while torch imports.
_stubs = {name: mod for name, mod in list(sys.modules.items())
          if not isinstance(getattr(mod, "__file__", None), (str, type(None)))}
for _name in _stubs:
    del sys.modules[_name]
import torch  # noqa: E402

sys.modules.update(_stubs)

import os  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import matplotlib  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

matplotlib.use("Agg", force=True)

from attosecondraytracing_tpu import main as jmain  # noqa: E402
from attosecondraytracing_tpu.analysis.optimizer import FindOptimalDistancePallas  # noqa: E402
from attosecondraytracing_tpu.models import chain as jchain  # noqa: E402
from attosecondraytracing_tpu.models.detector import Detector as JDetector  # noqa: E402
from attosecondraytracing_tpu.ops import pallas_grad as jpg  # noqa: E402
from attosecondraytracing_tpu.ops import pallas_scan as jps  # noqa: E402
from attosecondraytracing_tpu.ops import pallas_trace as jpt  # noqa: E402
from attosecondraytracing_tpu_torch import interop  # noqa: E402
from attosecondraytracing_tpu_torch import main as tmain  # noqa: E402
from attosecondraytracing_tpu_torch.analysis.optimizer import FindOptimalDistanceFused  # noqa: E402
from attosecondraytracing_tpu_torch.models import chain as tchain  # noqa: E402
from attosecondraytracing_tpu_torch.models.detector import Detector as TDetector  # noqa: E402
from attosecondraytracing_tpu_torch.ops import fused_grad as fg  # noqa: E402
from attosecondraytracing_tpu_torch.ops import fused_scan as fs  # noqa: E402
from attosecondraytracing_tpu_torch.ops import fused_trace as ft  # noqa: E402

torch.set_num_threads(1)

N = 16384
DISTANCES = (-10.0, 0.0, 10.0)
EDGE = float(np.exp(-2.0))
EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")


def _flagship(pkg, n_rays=16, divergence=25e-3, source_size=0.0, hole=7.0):
    from importlib import import_module

    mirrors = import_module(f"{pkg}.models.mirrors")
    masks = import_module(f"{pkg}.models.masks")
    supports = import_module(f"{pkg}.models.supports")
    placement = import_module(f"{pkg}.models.placement")
    R, r = mirrors.ReturnOptimalToroidalRadii(500.0, 80.0)
    tor = mirrors.MirrorToroidal(R, r, supports.SupportRectangle(150, 32))
    mask = masks.Mask(supports.SupportRoundHole(20, hole, 0, 0))
    props = {"Divergence": divergence, "SourceSize": source_size, "Wavelength": 80e-6,
             "DeltaFT": 0.5, "NumberRays": n_rays}
    return placement.OEPlacement(props, [mask, tor, tor], [400, 100, 500], [0, 80, -80], [0, 0, 0])


def _square_parabola():
    from attosecondraytracing_tpu.models import mirrors, sources, supports
    from attosecondraytracing_tpu.models.placement import OEPlacement

    par = mirrors.MirrorParabolic(100, 90, supports.SupportRoundHole(30, 5, 10, 5))
    props = {"Divergence": 0, "SourceSize": 50, "Wavelength": 800e-6, "NumberRays": 16}
    base = OEPlacement(props, [par], [200], [0.0])
    bundle, spec = sources.PlaneWaveSquareFused(np.zeros(3), np.array([1.0, 0.0, 0.0]), 40.0, N,
                                                Wavelength=800e-6, gaussian_edge=EDGE)
    return jchain.OpticalChain(bundle, base.optical_elements, source_spec=spec)


def _both(chain):
    """(JAX float32 elements, port float64 elements, JAX and port source info)."""
    jels = [e.to_device(dtype=jnp.float32) for e in chain.optical_elements]
    tels = interop.elements_from_numpy(jax.tree.map(np.asarray, jels), device="cpu",
                                       dtype=torch.float64)
    return jels, tels, chain.source_spec, interop.source_spec_from_numpy(chain.source_spec)


def _detector(chain, jels, distance=490.0):
    spec = chain.source_spec.baked()
    det = JDetector(np.zeros(3))
    det.autoplace(jpt.pallas_trace_source(spec, jels, N), distance)
    return det


def _stats(mom, distances=DISTANCES):
    sums = ft.moments_to_distance_sums(mom["moments"], distances, mom["centre_distance"])
    return ft.sums_to_stats(sums, mom["opl_ref"], distances)


def _assert_stats_close(a, b, w_rtol=2e-3):
    np.testing.assert_allclose(a["sum_w"], b["sum_w"], rtol=w_rtol)
    np.testing.assert_allclose(a["spot_sd"], b["spot_sd"], rtol=5e-3, atol=1e-6)
    for k, r in zip(a["duration_sd"], b["duration_sd"]):
        assert abs(k - r) <= 0.03 * r or abs(k * k - r * r) ** 0.5 <= 0.9, (k, r)


def test_chain_scalars_match_jax():
    """The pose vector of a perturbed flagship in both packages: float32
    roundings of the same float64 composition, within 1 ulp per entry."""
    chain = _flagship("attosecondraytracing_tpu")
    chain = chain.get_OE_loop_list(1, "roll", [0.3])[0]
    jels = chain.device_elements()
    tels = interop.elements_from_numpy(jax.tree.map(np.asarray, jels), device="cpu",
                                       dtype=torch.float64)
    spec = chain.source_spec.baked()
    det_c, det_n = np.array([900.0, 3.0, -1.0]), np.array([-1.0, 0.01, 0.0])
    det_n = det_n / np.linalg.norm(det_n)
    rot = JDetector(np.zeros(3), det_c, det_n)._plane_rotation()
    args = (np.asarray(spec.rot), np.asarray(spec.origin), det_c, det_n, rot)
    ref = jpg.chain_scalars_np(jels, *args)
    got = fg.chain_scalars_np(tels, *args)
    assert got.dtype == np.float32 and got.shape == (fg.n_scalars(3),) == ref.shape
    ulp = np.spacing(np.abs(ref).astype(np.float32))
    assert np.all(np.abs(got.astype(np.float64) - ref) <= ulp)
    maps, det = fg._unpack_scalars(list(got), 3)
    assert maps[2][1] == tuple(got[33:36]) and det[3] == tuple(got[-3:])


_CASES = {
    "flagship": lambda c: c,
    "pitch": lambda c: c.get_OE_loop_list(1, "pitch", [0.02])[0],
    "shift_normal": lambda c: c.get_OE_loop_list(2, "shift_normal", [0.5])[0],
    "roll": lambda c: c.get_OE_loop_list(1, "roll", [0.3])[0],
    "divergence": lambda c: c.get_source_loop_list("divergence", [32e-3])[0],
}


@pytest.mark.parametrize("case,edge", [("flagship", None), ("flagship", EDGE), ("pitch", None),
                                       ("shift_normal", None), ("roll", None),
                                       ("divergence", EDGE)])
def test_scan_plain_matches_pallas(case, edge):
    """K5's plain version against the Pallas scan kernel on the flagship
    and on chains perturbed in pose (the runtime poses and the runtime
    source radius), uniform and Gaussian weights: the same chief-ray
    references and the scan-kernel tolerances at 3 distances."""
    base = _flagship("attosecondraytracing_tpu")
    chain = _CASES[case](base)
    jels, tels, jinfo, tinfo = _both(chain)
    det = _detector(base, _both(base)[0])
    jspec = jps.make_scan_spec("cone", jels, N)
    tspec = fs.make_scan_spec("cone", tels, N)
    args = (det.centre, det.normal, det._plane_rotation())
    ref = jps.make_moments_fn(jspec, jels, jinfo, N)(*args, gaussian_edge=edge, centre_distance=3.0)
    got = fs.make_moments_fn(tspec, tels, tinfo, N, device="cpu")(*args, gaussian_edge=edge,
                                                                  centre_distance=3.0)
    assert got["opl_ref"] == pytest.approx(ref["opl_ref"], abs=1e-3)
    assert got["centre_distance"] == ref["centre_distance"]
    _assert_stats_close(_stats(got), _stats(ref))


@pytest.mark.parametrize("kind", ["extended", "square"])
def test_scan_plain_matches_pallas_other_sources(kind):
    """The source laws with runtime radius and source-disk radius: an
    extended source behind the flagship optics and a square grid on the
    single parabola, against the Pallas scan kernel."""
    if kind == "extended":
        chain = _flagship("attosecondraytracing_tpu", N, divergence=10e-3, source_size=0.4, hole=3.0)
        distance = 490.0
    else:
        chain = _square_parabola()
        distance = 90.0
    jels, tels, jinfo, tinfo = _both(chain)
    det = _detector(chain, jels, distance)
    baked = jinfo.baked()
    n = jinfo.n_rays
    jspec = jps.make_scan_spec(kind, jels, n, n_each=baked.n_each, n_sources=baked.n_sources)
    tspec = fs.make_scan_spec(kind, tels, n, n_each=baked.n_each, n_sources=baked.n_sources)
    args = (det.centre, det.normal, det._plane_rotation())
    ref = jps.make_moments_fn(jspec, jels, jinfo, n)(*args, gaussian_edge=EDGE)
    got = fs.make_moments_fn(tspec, tels, tinfo, n, device="cpu")(*args, gaussian_edge=EDGE)
    _assert_stats_close(_stats(got, (-5.0, 0.0, 5.0)), _stats(ref, (-5.0, 0.0, 5.0)))


def test_scan_chunk_law_splits_in_halves():
    """Two half-range passes with the (phase, k_frac) law sum to the full
    pass (tests/test_scan_kernel.py's check), and the chunk aux rows are the
    JAX package's."""
    chain = _flagship("attosecondraytracing_tpu")
    jels, tels, jinfo, tinfo = _both(chain)
    det = _detector(chain, jels)
    tspec = fs.make_scan_spec("cone", tels, N)
    baked = tinfo.baked()
    opl_ref, inv_dn = ft.chief_ray_refs(baked, tels, det.centre, det.normal, device="cpu",
                                        dtype=torch.float64)
    svec = fs.scan_chain_scalars(tels, np.asarray(baked.rot), np.asarray(baked.origin),
                                 det.centre, det.normal, det._plane_rotation())
    full = fs.scan_moments(tspec, svec, N, opl_ref, inv_dn, radius=baked.radius, device="cpu")
    half = N // 2
    parts = np.zeros(len(ft.MOMENT_FIELDS))
    for off in (0, half):
        parts += fs.scan_moments(tspec, svec, half, opl_ref, inv_dn, radius=baked.radius,
                                 phase=float(np.mod(off * ft._PHI_FRAC, 1.0)), k_frac=off / N,
                                 device="cpu")
    np.testing.assert_allclose(parts, full, rtol=1e-4, atol=1e-4)
    n_big = 3 * (1 << 23) + 5
    chunks = fs.scan_chunks(tspec._replace(n_total=n_big), n_big)
    ref = jpt.source_chunks("cone", n_big, n_big, 0, 0, 1 << 23)
    np.testing.assert_allclose(np.asarray(chunks), np.asarray(ref), rtol=0, atol=1e-15)
    aux = fs.scan_aux(chunks, opl_ref, inv_dn, 2.5, baked.radius, EDGE)
    assert aux.dtype == np.float32 and aux.shape == (4, fs.N_AUX)
    np.testing.assert_array_equal(aux[:, fs.AUX_PHASE], np.float32([c[1] for c in chunks]))
    assert aux[0, fs.AUX_WCOEF] == np.float32(np.log(EDGE)) and aux[0, fs.AUX_CENTRE_D] == 2.5


def _block_rays(sizes, rays_per_block):
    """(n_blocks, 2) ``[start, stop)`` global ray ranges of the blocks of
    ft.ray_grid, by the kernels' arithmetic (csrc/trace_common.cuh
    ``block_rays``): block b serves chunk c = b // blocks_per_chunk from
    local ray (b - c * blocks_per_chunk) * rays_per_block up to the chunk's
    end."""
    bpc, n_blocks = ft.ray_grid(sizes, rays_per_block)
    b = np.arange(n_blocks, dtype=np.int64)
    c = b // bpc
    first = (b - c * bpc) * rays_per_block
    offset = c * sizes[0]
    return np.stack([offset + first,
                     offset + np.minimum(first + rays_per_block, np.asarray(sizes, np.int64)[c])], axis=1)


@pytest.mark.parametrize("kind,extra", [("cone", {"n": 10_000_000}),
                                        ("extended", {"n_each": 333, "n_sources": 30011}),
                                        ("square", {"n_each": 3163})])
def test_ray_grid_covers_every_ray_once(kind, extra):
    """The grid sized to the rays (K5-K7: ray_grid, and the blocks' rays by
    the kernels' arithmetic) on each chunk law at ~1e7 rays, with the chunks of
    2^23 rays the kernels take and with small chunks (many of them, a ragged
    last one): every block starts with at least one ray, and the blocks in
    order cover every ray of every chunk exactly once. At 1e7 cone rays it
    launches 4883 blocks of 2048 rays where the (blocks per chunk, chunks)
    grid launched 2 x 4096, 3309 of them without a ray."""
    n_each, n_sources = extra.get("n_each", 0), extra.get("n_sources", 0)
    n = {"cone": extra.get("n"), "extended": n_each * n_sources, "square": n_each * n_each}[kind]
    for chunk in (ft.CHUNK, 5000):
        sizes = [c[0] for c in ft.source_chunks(kind, n, n, chunk, n_each=n_each, n_sources=n_sources)]
        assert sum(sizes) == n and sizes == ft._check_chunks([(s, 0.0, 0.0) for s in sizes])
        for rpb in (2048, 1000):
            bpc, n_blocks = ft.ray_grid(sizes, rpb)
            ranges = _block_rays(sizes, rpb)
            assert ranges.shape == (n_blocks, 2)
            assert n_blocks == sum(-(-s // rpb) for s in sizes) <= len(sizes) * bpc
            assert np.all(ranges[:, 1] > ranges[:, 0])  # no block starts without rays
            assert np.all(ranges[:, 1] - ranges[:, 0] <= rpb)
            assert ranges[0, 0] == 0 and ranges[-1, 1] == n
            np.testing.assert_array_equal(ranges[1:, 0], ranges[:-1, 1])  # contiguous, no overlap
    if kind == "cone":
        sizes = [c[0] for c in ft.source_chunks(kind, n, n)]
        assert sizes == [1 << 23, n - (1 << 23)] and ft.ray_grid(sizes, 2048) == (4096, 4883)


@pytest.mark.parametrize("kind,extra", [("cone", {}), ("disk", {}),
                                        ("extended", {"n_each": 333, "n_sources": 61}),
                                        ("square", {"n_each": 127})])
def test_total_source_weight(kind, extra):
    """The closed forms against the JAX package's and against the direct
    sum of exp(ln(edge) * rr) over the plain source law."""
    n = extra["n_each"] * extra["n_sources"] if kind == "extended" else (
        extra["n_each"] ** 2 if kind == "square" else 12345)
    got = fs.total_source_weight(n, EDGE, kind=kind, **extra)
    ref = jps.total_source_weight(n, EDGE, kind=kind, **extra)
    assert got == pytest.approx(ref, rel=1e-12)
    k = torch.arange(n, dtype=torch.int64)
    _, _, rr = ft.synth_source(kind, k, n, 0.5, 0.0, 0.0, pos_radius=1.0,
                               n_each=extra.get("n_each", 0), n_sources=extra.get("n_sources", 0))
    direct = float(np.exp(np.log(EDGE) * rr.double().numpy()).sum())
    assert got == pytest.approx(direct, rel=1e-5)
    assert fs.total_source_weight(n, None, kind=kind, **extra) == n


def test_optimizer_with_scan_moments_fn():
    """FindOptimalDistanceFused fed by the scan kernel's plain version lands
    where JAX's FindOptimalDistancePallas fed by the Pallas scan kernel
    lands; last_moments records the surviving weight."""
    chain = _flagship("attosecondraytracing_tpu")
    jels, tels, jinfo, tinfo = _both(chain)
    det = _detector(chain, jels)
    baked_j, baked_t = jinfo.baked(), tinfo.baked()
    jfn = jps.make_moments_fn(jps.make_scan_spec("cone", jels, N), jels, jinfo, N)
    tfn = fs.make_moments_fn(fs.make_scan_spec("cone", tels, N), tels, tinfo, N, device="cpu")
    d_ref, spot_ref, _ = FindOptimalDistancePallas(baked_j, jels, N, det, OptFor="spotsize",
                                                   Amplitude=30.0, Precision=3, moments_fn=jfn)
    rec = {}
    tdet = TDetector(det.refpoint, det.centre, det.normal)
    d_got, spot_got, _ = FindOptimalDistanceFused(baked_t, tels, N, tdet, OptFor="spotsize",
                                                  Amplitude=30.0, Precision=3, device="cpu",
                                                  moments_fn=tfn, last_moments=rec)
    assert d_got.get_distance() == pytest.approx(d_ref.get_distance(), abs=0.05)
    assert spot_got == pytest.approx(spot_ref, rel=5e-3, abs=1e-6)
    assert rec["moments"][0] > 0


def _patch_thresholds(monkeypatch):
    monkeypatch.setenv("ART_TPU_DTYPE", "float64")
    monkeypatch.setattr(jchain, "PALLAS_MIN_RAYS", 1024)
    monkeypatch.setattr(jchain.OpticalChain, "_pallas_eligible", lambda self, els: True)
    monkeypatch.setattr(tchain, "PALLAS_MIN_RAYS", 1024)


def _assert_runs_close(a, b):
    """Chain by chain, within tests/test_scan_kernel.py:308-313."""
    for d_a, d_b in zip(a["Detector"], b["Detector"]):
        assert d_a.get_distance() == pytest.approx(d_b.get_distance(), abs=1.0)
    np.testing.assert_allclose(a["ETransmission"], b["ETransmission"], rtol=0.02)
    np.testing.assert_allclose(a["SpotSizeSD"], b["SpotSizeSD"], rtol=0.1, atol=5e-4)


def test_main_scan_monte_carlo_matches_jax(monkeypatch):
    """Monte-Carlo tolerancing (every element, masks included, randomly
    rotated and shifted): both packages' main take their scan engines, agree
    chain by chain, and the port's scan engine agrees with its own serial
    path (scan_engine="off")."""
    _patch_thresholds(monkeypatch)
    monkeypatch.setattr(jmain, "_CLI_ACTIVE", True)
    sp = {"NumberRays": 4096}
    do = {"AutoDetectorDistance": True, "DistanceDetector": 500.0, "OptFor": "spotsize"}
    ao = {"verbose": False, "save_results": False}

    def chains(pkg):
        # rotate_random_by draws its axis from the global NumPy RNG
        np.random.seed(5)
        return _flagship(pkg, 4096).get_OE_random_loop_list(0.05, 0.2, 3, rng=np.random.default_rng(11))

    jc = chains("attosecondraytracing_tpu")
    jk = jmain.main(jc, sp, do, ao)
    assert all(c.last_trace_engine == "pallas-scan" for c in jc)
    tc = chains("attosecondraytracing_tpu_torch")
    fs.fused_scan_moments.launches = 0
    tk = tmain.main(tc, sp, do, ao, device="cpu")
    assert all(c.last_trace_engine == "torch-scan" for c in tc)
    assert fs.fused_scan_moments.launches == 0
    _assert_runs_close(tk, jk)
    off = tmain.main(tc, sp, do, ao, device="cpu", scan_engine="off")
    assert all(c.last_trace_engine == "torch-source" for c in tc)
    _assert_runs_close(tk, off)
    with pytest.raises(ValueError):
        tmain.main(tc, sp, do, ao, device="cpu", scan_engine="xla")


def test_scan_config_matches_jax(monkeypatch):
    """examples/CONFIG_2toroidals_f-x-f.py (11 chains of a detector-arm
    distance scan) at 4096 rays through both CLIs: every chain of both takes
    the scan engine, the two agree chain by chain, the port's scan agrees
    with its serial path, and the optimum sits near 500 mm mid-scan."""
    _patch_thresholds(monkeypatch)
    path = os.path.join(EXAMPLES, "CONFIG_2toroidals_f-x-f.py")
    jk = jmain.run_config_file(path, n_rays=4096)
    assert all(c.last_trace_engine == "pallas-scan" for c in jk["OpticalChain"])
    tk = tmain.run_config_file(path, n_rays=4096, device="cpu")
    assert len(tk["OpticalChain"]) == 11
    assert all(c.last_trace_engine == "torch-scan" for c in tk["OpticalChain"])
    _assert_runs_close(tk, jk)
    off = tmain.run_config_file(path, n_rays=4096, device="cpu", scan_engine="off")
    assert all(c.last_trace_engine == "torch-source" for c in off["OpticalChain"])
    _assert_runs_close(tk, off)
    assert tk["Detector"][5].get_distance() == pytest.approx(500.0, abs=10.0)


def test_scan_wrapper_cpu_and_refusals():
    """On the CPU the wrapper runs the plain version and counts no launch;
    ``main`` refuses mixed scans; a chain K5 does not take raises
    NotImplementedError when packed, before any copy or allocation."""
    chain = _flagship("attosecondraytracing_tpu")
    jels, tels, jinfo, tinfo = _both(chain)
    spec = fs.make_scan_spec("cone", tels, 4096)
    baked = tinfo.baked()
    svec = fs.scan_chain_scalars(tels, np.asarray(baked.rot), np.asarray(baked.origin),
                                 np.array([900.0, 0.0, 0.0]), np.array([-1.0, 0.0, 0.0]),
                                 np.eye(3)[[1, 2, 0]])
    chunks = [(4096, 0.0, 0.0)]
    aux = fs.scan_aux(chunks, 900.0, -1.0, 0.0, baked.radius)
    fs.fused_scan_moments.launches = 0
    a = fs.fused_scan_moments(spec, svec, aux, chunks, device="cpu")
    b = fs.scan_moments_ref(spec, svec, aux, chunks, device="cpu")
    np.testing.assert_array_equal(a, b)
    assert fs.fused_scan_moments.launches == 0
    assert fs.pack_scan_chain(spec)["n_premasks"] == 0  # masks stay unfolded
    with pytest.raises(ValueError):
        fs.scan_moments_ref(spec, svec[:-1], aux, chunks, device="cpu")
    long_spec = spec._replace(elements=spec.elements * 3)
    with pytest.raises(NotImplementedError):
        fs.fused_scan_moments(long_spec, np.zeros(fg.n_scalars(9), np.float32), aux, chunks,
                              device="cuda")
    tc = _flagship("attosecondraytracing_tpu_torch", 4096).get_OE_loop_list(1, "pitch", [0.0, 0.01])
    ao = {"plot_Render": False}
    sigs = {fs.pose_independent_signature([e.to_device("cpu") for e in c.optical_elements]) for c in tc}
    assert len(sigs) == 1
    assert tmain._prepare_fused_scan(tc, ao) is None  # below PALLAS_MIN_RAYS
    assert tmain._prepare_fused_scan(tc[:1], ao) is None
