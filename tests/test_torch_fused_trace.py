"""PyTorch port vs the JAX package: the fused engines' plain versions (K1
``fused_source_trace_ref``, K2 ``fused_source_moments_ref``) against the
Pallas kernels run in interpret mode, on the identical chain.

Tolerances: the two packages trace in float32 with independent arithmetic
(rsqrt, reciprocal and arccos differ by ulps), so per-ray results agree to
the float32 envelope of tests/test_pallas.py (positions 1e-3 mm median,
5e-2 mm max) and the statistics to those of tests/test_stats_kernel.py; the
source law and the moment epilogue are compared on identical inputs, where
only rounding order differs."""

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

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from attosecondraytracing_tpu.models import masks as jmask
from attosecondraytracing_tpu.models import mirrors as jmirror
from attosecondraytracing_tpu.models import supports as jsupp
from attosecondraytracing_tpu.models.detector import Detector as JDetector
from attosecondraytracing_tpu.models.placement import OEPlacement as JPlacement
from attosecondraytracing_tpu.ops import pallas_trace as jpt
from attosecondraytracing_tpu.ops import trace as jtr
from attosecondraytracing_tpu_torch import interop
from attosecondraytracing_tpu_torch.ops import fused_trace as ft
from attosecondraytracing_tpu_torch.ops import trace as ttr

torch.set_num_threads(1)

N = 8192
EDGE = float(np.exp(-2.0))


def _flagship():
    R, r = jmirror.ReturnOptimalToroidalRadii(500.0, 80.0)
    tor = jmirror.MirrorToroidal(R, r, jsupp.SupportRectangle(150, 32))
    mask = jmask.Mask(jsupp.SupportRoundHole(20, 7, 0, 0))
    props = {"Divergence": 25e-3, "SourceSize": 0, "Wavelength": 80e-6, "DeltaFT": 0.5, "NumberRays": 64}
    return JPlacement(props, [mask, tor, tor], [400, 100, 500], [0, 80, -80], [0, 0, 0])


def _parabola():
    par = jmirror.MirrorParabolic(100, 90, jsupp.SupportRoundHole(30, 5, 10, 5))
    props = {"Divergence": 0, "SourceSize": 50, "Wavelength": 800e-6, "DeltaFT": 2.7, "NumberRays": 64}
    chain = JPlacement(props, [par], [200], [0.0])
    chain.optical_elements[0].rotate_roll_by(np.rad2deg(50e-6))
    return chain


def _quadrics():
    """Convex sphere, holed cylinder and ellipsoid: the other three surfaces
    of the kernels' quadric path, with supports that clip."""
    ell = jmirror.MirrorEllipsoidal(jsupp.SupportRectangle(80, 30), *jmirror.ReturnOptimalEllipsoidalAxes(600, 75))
    sph = jmirror.MirrorSpherical(-2000, jsupp.SupportRound(25))
    cyl = jmirror.MirrorCylindrical(3000, jsupp.SupportRectangleHole(60, 30, 3, 10, 5))
    props = {"Divergence": 30e-3, "SourceSize": 0, "Wavelength": 50e-6, "NumberRays": 64}
    return JPlacement(props, [sph, cyl, ell], [300, 200, 300], [5.0, 10.0, 75.0], [0, 90, 0])


def _extended():
    """The flagship's optics behind an extended source (a Vogel grid of
    point sources over a 0.4 mm disk, each a 10 mrad cone)."""
    R, r = jmirror.ReturnOptimalToroidalRadii(500.0, 80.0)
    tor = jmirror.MirrorToroidal(R, r, jsupp.SupportRectangle(150, 32))
    mask = jmask.Mask(jsupp.SupportRoundHole(20, 3, 0, 0))
    props = {"Divergence": 10e-3, "SourceSize": 0.4, "Wavelength": 80e-6, "NumberRays": N}
    return JPlacement(props, [mask, tor, tor], [400, 100, 500], [0, 80, -80], [0, 0, 0])


def _square():
    """The single parabola lit by a collimated 40 mm square grid."""
    from attosecondraytracing_tpu.models import chain as jchain
    from attosecondraytracing_tpu.models import sources as jsource

    par = _parabola()
    bundle, spec = jsource.PlaneWaveSquareFused(np.zeros(3), np.array([1.0, 0.0, 0.0]), 40.0, N,
                                                Wavelength=800e-6, gaussian_edge=EDGE)
    return jchain.OpticalChain(bundle, par.optical_elements, source_spec=spec)


def _both(chain):
    """(JAX spec, JAX elements, port spec, port elements) of one chain."""
    jels = jax.tree.map(np.asarray, chain.device_elements())
    jspec = chain.source_spec.baked()
    return (jspec, jels, interop.source_spec_from_numpy(jspec),
            interop.elements_from_numpy(jels, device="cpu", dtype=torch.float64))


@pytest.mark.parametrize("build", [_flagship, _parabola, _quadrics, _extended, _square],
                         ids=["flagship", "parabola", "quadrics", "extended", "square"])
def test_k1_plain_matches_pallas(build):
    jspec, jels, tspec, tels = _both(build())
    table = ft.chain_table(tspec, tels)
    # the kernel takes every one of these chains
    assert ft.pack_chain(table)["n_elements"] == len(table.elements)
    assert ft.pack_source(tspec, N)["kind"] == ft._SRC_KIND[tspec.kind]
    ref = jpt.pallas_trace_source(jspec, jels, N)
    out = ft.fused_source_trace_ref(table, tspec, N, device="cpu")
    ja, ta = np.asarray(ref.alive), out.alive.numpy()
    assert N // 10 < ja.sum() < N
    assert (ja != ta).sum() <= 2  # edge rays may flip
    both = ja & ta
    dp = np.abs(out.p.numpy()[both] - np.asarray(ref.p)[both])
    assert np.median(dp) < 1e-3 and dp.max() < 5e-2
    dopl = (out.opl - out.opl_c).numpy()[both] - (np.asarray(ref.opl) - np.asarray(ref.opl_c))[both]
    assert np.abs(dopl).max() < 0.1
    assert np.abs(out.incidence.numpy()[both] - np.asarray(ref.incidence)[both]).max() < 1e-4


@pytest.mark.parametrize("kind,param,extra", [
    ("cone", 25e-3, {}), ("disk", 25.0, {}),
    ("extended", 10e-3, {"diameter": 0.4, "n_rays": 3 * N}), ("square", 40.0, {"n_rays": 3 * N}),
])
def test_source_matches_jax_source_bundle(kind, param, extra):
    """The source law ray for ray: base-256 golden angle and the law's
    sin/cos polynomials (the sub-source and cone spirals of an extended
    source, the rows and columns of a square grid), rotated into the lab
    (within 1e-5 mm)."""
    args = (kind, np.array([1.0, -2.0, 0.5]), np.array([1.0, 0.2, 0.0]), param)
    jspec = jpt.make_source_spec(*args, **extra)
    tspec = interop.source_spec_from_numpy(jspec)
    assert tspec == ft.make_source_spec(*args, **extra)
    for phase, k_frac in ((0.0, 0.0), (0.3125, 0.25)):
        ref = jpt.source_bundle(jspec, N, phase=phase, k_frac=k_frac, n_total=4 * N)
        out = ft.source_bundle(tspec, N, device="cpu", phase=phase, k_frac=k_frac, n_total=4 * N)
        np.testing.assert_allclose(out.p.numpy(), np.asarray(ref.p), rtol=0, atol=1e-5)
        np.testing.assert_allclose(out.d.numpy(), np.asarray(ref.d), rtol=0, atol=1e-6)


def test_source_chunks_match_jax():
    """The chunk law of every source kind: spirals at any offset, extended
    sources on whole sub-sources, square grids on whole rows."""
    for kind, n_each, n_sources in (("cone", 0, 0), ("extended", 333, 90000), ("square", 5477, 0)):
        for n, n_total in ((3 * (1 << 23) + 17, 3 * (1 << 23) + 17), (1 << 23, 1 << 25)):
            ref = jpt.source_chunks(kind, n, n_total, n_each, n_sources)
            got = ft.source_chunks(kind, n, n_total, n_each=n_each, n_sources=n_sources)
            assert [c[0] for c in got] == [c[0] for c in ref]
            assert all(c[0] % max(n_each, 1) == 0 for c in got[:-1])
            np.testing.assert_allclose(np.asarray(got)[:, 1:], np.asarray(ref)[:, 1:], rtol=0, atol=1e-15)


def test_moment_epilogue_matches_jax(rng):
    """moment_rows on one seeded float32 state in both packages: the 16
    sums agree within 1e-4 relative, or within the float32 summation error
    of the terms' magnitudes (the JAX block sum runs in float32)."""
    n = 128 * 8
    vals = {f: rng.normal(scale=s, size=n).astype(np.float32) for f, s in (
        ("px", 2.0), ("py", 2.0), ("pz", 2.0), ("opl", 1e-3), ("opl_c", 1e-7))}
    d = rng.normal(size=(3, n)) * np.array([[1e-2], [1e-2], [1.0]])
    d = (d / np.linalg.norm(d, axis=0)).astype(np.float32)
    vals["opl"] = vals["opl"] + np.float32(1500.0)
    alive = rng.uniform(size=n) < 0.7
    w = rng.uniform(0.1, 1.0, size=n).astype(np.float32)
    jdet = jpt.BakedDetector(centre=(0.1, -0.2, 480.0), normal=(0.01, 0.0, -1.0), e1=(1.0, 0.0, 0.01),
                             e2=(0.0, 1.0, 0.0), distances=(0.0,), opl_ref=1500.0 - 480.0,
                             inv_dn_chief=-1.0)
    tdet = ft.BakedDetector(centre=jdet.centre, normal=jdet.normal, e1=jdet.e1, e2=jdet.e2,
                            opl_ref=jdet.opl_ref, inv_dn_chief=jdet.inv_dn_chief)
    shape = (8, 128)
    js = jtr.TraceState(*(jnp.asarray(x.reshape(shape)) for x in (
        vals["px"], vals["py"], vals["pz"], d[0], d[1], d[2], vals["opl"], vals["opl_c"])),
        alive=jnp.asarray(alive.reshape(shape)), incidence=jnp.zeros(shape, jnp.float32))
    ref = np.asarray(jpt.moment_rows(js, jdet, jnp.asarray(w.reshape(shape)), jnp.float32(2.5)))[0, :16]
    ts = ttr.TraceState(*(torch.as_tensor(x) for x in (
        vals["px"], vals["py"], vals["pz"], d[0], d[1], d[2], vals["opl"], vals["opl_c"])),
        alive=torch.as_tensor(alive), incidence=torch.zeros(n))
    terms = ft.moment_rows(ts, tdet, torch.as_tensor(w), torch.tensor(2.5, dtype=torch.float32))
    got = terms.double().sum(dim=1).numpy()
    scale = terms.double().abs().sum(dim=1).numpy()
    assert np.all(np.abs(got - ref) <= 1e-4 * np.abs(ref) + 1e-6 * scale), (got, ref)


def test_distance_sums_and_stats_match_jax(rng):
    moments = rng.normal(size=16) + np.array([50.0] + [0.0] * 15)
    distances = np.linspace(-20.0, 20.0, 9)
    jsums = jpt.moments_to_distance_sums(moments, distances, 1.5)
    tsums = ft.moments_to_distance_sums(moments, distances, 1.5)
    jstats = jpt.sums_to_stats(jsums, 3.0, distances)
    tstats = ft.sums_to_stats(tsums, 3.0, distances)
    for key in jsums:
        np.testing.assert_allclose(tsums[key], jsums[key], rtol=1e-12)
    for key in ("spot_sd", "duration_sd", "mean_x", "mean_y", "mean_delay", "sum_w"):
        np.testing.assert_allclose(tstats[key], jstats[key], rtol=1e-12)


@pytest.fixture(scope="module")
def k2_setup():
    chain = _flagship()
    jspec, jels, tspec, tels = _both(chain)
    out = jpt.pallas_trace_source(jspec, jels, 16384)
    det = JDetector(np.zeros(3))
    det.autoplace(out, 490.0)
    return jspec, jels, tspec, tels, det


def test_k2_plain_matches_pallas(k2_setup):
    """The full moment pass: chief-ray references identical, sum of weights
    within 1e-4, and the tests/test_stats_kernel.py tolerances on the
    statistics at 5 distances."""
    jspec, jels, tspec, tels, det = k2_setup
    n = 16384
    args = (det.centre, det.normal, det._plane_rotation())
    ref = jpt.pallas_source_detector_moments(jspec, jels, n, *args, gaussian_edge=EDGE, centre_distance=3.0)
    got = ft.source_detector_moments(tspec, tels, n, *args, device="cpu", dtype=torch.float64,
                                     gaussian_edge=EDGE, centre_distance=3.0)
    assert got["opl_ref"] == pytest.approx(ref["opl_ref"], abs=1e-9)
    assert got["inv_dn_chief"] == pytest.approx(ref["inv_dn_chief"], rel=1e-12)
    assert got["centre_distance"] == ref["centre_distance"]
    assert got["moments"][0] == pytest.approx(ref["moments"][0], rel=1e-4)
    distances = (-20.0, -5.0, 0.0, 5.0, 20.0)
    js = jpt.sums_to_stats(jpt.moments_to_distance_sums(ref["moments"], distances, 3.0), 0.0, distances)
    ts = ft.sums_to_stats(ft.moments_to_distance_sums(got["moments"], distances, 3.0), 0.0, distances)
    np.testing.assert_allclose(ts["spot_sd"], js["spot_sd"], rtol=2e-3, atol=1e-6)
    k, r = ts["duration_sd"], js["duration_sd"]
    assert np.all((np.abs(k - r) <= 0.025 * r) | (np.abs(k * k - r * r) ** 0.5 <= 0.8)), (k, r)


@pytest.mark.parametrize("build,distance", [(_extended, 490.0), (_square, 90.0)],
                         ids=["extended", "square"])
def test_k2_plain_matches_pallas_other_sources(build, distance):
    """K2's plain version on the extended and square sources against the
    Pallas moment pass: the sum of weights within 1e-4 and the statistics
    within the tests/test_stats_kernel.py tolerances at 3 distances."""
    jspec, jels, tspec, tels = _both(build())
    det = JDetector(np.zeros(3))
    det.autoplace(jpt.pallas_trace_source(jspec, jels, N), distance)
    args = (det.centre, det.normal, det._plane_rotation())
    ref = jpt.pallas_source_detector_moments(jspec, jels, N, *args, gaussian_edge=EDGE)
    got = ft.source_detector_moments(tspec, tels, N, *args, device="cpu", dtype=torch.float64,
                                     gaussian_edge=EDGE)
    assert got["opl_ref"] == pytest.approx(ref["opl_ref"], abs=1e-9)
    assert got["moments"][0] == pytest.approx(ref["moments"][0], rel=1e-4)
    distances = (-5.0, 0.0, 5.0)
    js = jpt.sums_to_stats(jpt.moments_to_distance_sums(ref["moments"], distances), 0.0, distances)
    ts = ft.sums_to_stats(ft.moments_to_distance_sums(got["moments"], distances), 0.0, distances)
    np.testing.assert_allclose(ts["spot_sd"], js["spot_sd"], rtol=2e-3, atol=1e-6)
    k, r = ts["duration_sd"], js["duration_sd"]
    assert np.all((np.abs(k - r) <= 0.025 * r) | (np.abs(k * k - r * r) ** 0.5 <= 0.8)), (k, r)


def test_k2_chunk_law_is_seamless(k2_setup):
    """Chunked passes (phase = frac(off*phi), k_frac = off/n) reproduce the
    one-pass moments: the same rays up to the float32 rounding of the
    per-chunk phase."""
    _, _, tspec, tels, det = k2_setup
    n = 16384
    table = ft.chain_table(tspec, tels)
    opl_ref, inv = ft.chief_ray_refs(tspec, tels, det.centre, det.normal, device="cpu", dtype=torch.float64)
    bdet = ft.bake_detector(tels, det.centre, det.normal, det._plane_rotation(), opl_ref, inv)
    one = ft.fused_source_moments(table, tspec, bdet, [(n, 0.0, 0.0)], n, device="cpu", gaussian_edge=EDGE)
    many = ft.fused_source_moments(table, tspec, bdet, ft.source_chunks("cone", n, n, 4096), n,
                                   device="cpu", gaussian_edge=EDGE)
    assert many[0] == pytest.approx(one[0], rel=1e-6)
    d = (-20.0, 0.0, 20.0)
    s1 = ft.sums_to_stats(ft.moments_to_distance_sums(one, d), opl_ref, d)
    s2 = ft.sums_to_stats(ft.moments_to_distance_sums(many, d), opl_ref, d)
    np.testing.assert_allclose(s2["spot_sd"], s1["spot_sd"], rtol=2e-3)
    assert np.all(np.abs(s2["duration_sd"] ** 2 - s1["duration_sd"] ** 2) ** 0.5 <= 0.8)


def test_cpu_wrappers_take_the_plain_versions():
    """On CPU tensors the wrappers run the plain versions (bit-identical
    results) and never count a kernel launch."""
    _, _, tspec, tels = _both(_parabola())
    table = ft.chain_table(tspec, tels)
    ft.fused_source_trace.launches = ft.fused_source_moments.launches = 0
    a = ft.fused_source_trace(table, tspec, 4096, device="cpu")
    b = ft.fused_source_trace_ref(table, tspec, 4096, device="cpu")
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    bdet = ft.BakedDetector((0.0, 0.0, -100.0), (0.0, 0.0, 1.0), (1.0, 0.0, 0.0), (0.0, 1.0, 0.0), 0.0, 1.0)
    m1 = ft.fused_source_moments(table, tspec, bdet, [(4096, 0.0, 0.0)], 4096, device="cpu")
    m2 = ft.fused_source_moments_ref(table, tspec, bdet, [(4096, 0.0, 0.0)], 4096, device="cpu")
    np.testing.assert_array_equal(m1, m2)
    assert ft.fused_source_trace.launches == 0 and ft.fused_source_moments.launches == 0


def test_kernel_table_rejects_what_the_kernels_lack():
    """The kernel records take the four factory source kinds, masks and the
    six surfaces without defects, up to the table's size; anything else
    raises NotImplementedError instead of falling back."""
    _, _, tspec, tels = _both(_flagship())
    for kind, param in (("cone", 1e-3), ("disk", 5.0), ("extended", 1e-3), ("square", 5.0)):
        spec = ft.make_source_spec(kind, np.zeros(3), np.array([1.0, 0.0, 0.0]), param,
                                   diameter=0.2, n_rays=4000)
        assert ft.pack_source(spec, 4000)["kind"] == ft._SRC_KIND[kind]
    with pytest.raises(NotImplementedError):
        ft.pack_source(tspec._replace(kind="gaussian-beam"), 4000)
    table = ft.chain_table(tspec, tels)
    deformed = table._replace(elements=(table.elements[0]._replace(defects=("zernike",)),) + table.elements[1:])
    with pytest.raises(NotImplementedError):
        ft.pack_chain(deformed)
    long_chain = table._replace(elements=table.elements * 5, maps=table.maps * 5,
                                premasks=table.premasks * 5)
    with pytest.raises(NotImplementedError):
        ft.pack_chain(long_chain)
    # on a CUDA device the wrappers pack before they allocate, so what the
    # kernels lack raises here even without a card
    with pytest.raises(NotImplementedError):
        ft.fused_source_trace(long_chain, tspec, 4096, device="cuda")
    bdet = ft.BakedDetector((0.0, 0.0, -100.0), (0.0, 0.0, 1.0), (1.0, 0.0, 0.0), (0.0, 1.0, 0.0), 0.0, 1.0)
    with pytest.raises(NotImplementedError):
        ft.fused_source_moments(long_chain, tspec, bdet, [(4096, 0.0, 0.0)], 4096, device="cuda")
    assert ft.pack_chain(table)["n_elements"] == 2 and ft.pack_chain(table)["n_premasks"] == 1
