"""PyTorch port vs the JAX package on chains with surface defects: the plain
trace's defect branch (``mirror_step_c`` / ``chained_step``) and the plain
versions of kernels K1-K8 on a Zernike-deformed chain against the JAX
kernels run in interpret mode, as tests/test_pallas.py:77-120 runs them,
and the slice end to end (``main.main``) on the deformed flagship.

Inputs: the JAX package's chains, carried across by ``interop`` and built
from a seed. Tolerances:

* the plain traces in float64 (tests/conftest.py runs JAX in float64):
  1e-9 mm on positions and optical paths, 1e-12 on directions (the same
  operations; only contraction and rounding order differ), 5e-8 rad on
  incidence angles (the JAX package's polynomial arccos);
* K1, K3, K4 (float32, independent arithmetic): the envelopes of
  tests/test_pallas.py, positions atol 2e-3 mm at normal incidence
  (:115-119) and median 1e-3 / max 5e-2 mm on the grazing flagship (:40-43),
  directions atol 2e-5 on alive rays, with the same alive mask (at most 2
  edge rays flip);
* K2, K5, K8 statistics: tests/test_stats_kernel.py's envelopes, as
  tests/test_torch_fused_stats.py holds them (sum of weights rel 1e-5, spot
  SD rel 2e-3, duration SD 2.5 % or 0.8 fs in quadrature; K5 against the
  scan kernel with tests/test_torch_fused_scan.py's);
* K6/K7: tests/test_torch_fused_grad.py's (spatial sums within 1e-4 of
  their scales, tangents within 2e-3 of their statistic's largest);
* main.main: test_run_art_flagship_matches_jax's."""

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

import jax  # noqa: E402
import jax.flatten_util  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import matplotlib  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

matplotlib.use("Agg", force=True)

from attosecondraytracing_tpu import main as jmain  # noqa: E402
from attosecondraytracing_tpu.models import chain as jchain  # noqa: E402
from attosecondraytracing_tpu.models.detector import Detector as JDetector  # noqa: E402
from attosecondraytracing_tpu.ops import pallas_grad as jpg  # noqa: E402
from attosecondraytracing_tpu.ops import pallas_scan as jps  # noqa: E402
from attosecondraytracing_tpu.ops import pallas_trace as jpt  # noqa: E402
from attosecondraytracing_tpu.ops import trace as jtr  # noqa: E402
from attosecondraytracing_tpu_torch import interop  # noqa: E402
from attosecondraytracing_tpu_torch import main as tmain  # noqa: E402
from attosecondraytracing_tpu_torch.models import chain as tchain  # noqa: E402
from attosecondraytracing_tpu_torch.ops import fused_grad as fg  # noqa: E402
from attosecondraytracing_tpu_torch.ops import fused_scan as fs  # noqa: E402
from attosecondraytracing_tpu_torch.ops import fused_trace as ft  # noqa: E402
from attosecondraytracing_tpu_torch.ops import trace as ttr  # noqa: E402

torch.set_num_threads(1)

N = 4096
EDGE = float(np.exp(-2.0))
#: the deformed flagship's Zernike terms (chip_smoke.py's phase zernike)
FLAGSHIP_ZERNIKE = {(2, 0): 2e-4, (3, 1): -1e-4, (4, 2): 5e-5, (6, 3): 2e-5}


@pytest.fixture(autouse=True, scope="module")
def _no_stub_modules():
    """Set tests/reference_shims.py's stub modules aside while this module's
    tests run: torch.func (K6's plain version) looks modules up through
    inspect, which fails on them (see the top of this file)."""
    with pytest.MonkeyPatch.context() as mp:
        for name, mod in list(sys.modules.items()):
            if not isinstance(getattr(mod, "__file__", None), (str, type(None))):
                mp.delitem(sys.modules, name)
        yield


def _flagship(pkg, n_rays=16, distance=500.0):
    """The flagship with its first toroid Zernike-deformed (FLAGSHIP_ZERNIKE),
    in package ``pkg``."""
    from importlib import import_module

    mirrors = import_module(f"{pkg}.models.mirrors")
    masks = import_module(f"{pkg}.models.masks")
    supports = import_module(f"{pkg}.models.supports")
    defects = import_module(f"{pkg}.models.defects")
    placement = import_module(f"{pkg}.models.placement")
    R, r = mirrors.ReturnOptimalToroidalRadii(500.0, 80.0)
    tor = mirrors.MirrorToroidal(R, r, supports.SupportRectangle(150, 32))
    deformed = mirrors.DeformedMirror(tor, [defects.Zernike(supports.SupportRectangle(150, 32),
                                                            FLAGSHIP_ZERNIKE)])
    mask = masks.Mask(supports.SupportRoundHole(Radius=20, RadiusHole=7, CenterHoleX=0, CenterHoleY=0))
    props = {"Divergence": 25e-3, "SourceSize": 0, "Wavelength": 80e-6, "DeltaFT": 0.5,
             "NumberRays": n_rays}
    return placement.OEPlacement(props, [mask, deformed, tor], [400.0, 100.0, distance],
                                 [0.0, 80.0, -80.0], [0.0, 0.0, 0.0], "deformed flagship"), props


def _parabola(kind="zernike", n_rays=16):
    """tests/test_pallas.py:77-120's chain: a parabola at normal incidence
    with Zernike defects over a 20 mm disk (or a Fourrier map), lit by a
    30 mm plane wave."""
    from attosecondraytracing_tpu.models import defects, mirrors, supports
    from attosecondraytracing_tpu.models.placement import OEPlacement

    support = supports.SupportRound(20)
    base = mirrors.MirrorParabolic(100, 90, support)
    if kind == "zernike":
        defect = defects.Zernike(support, {(2, 0): 2e-4, (3, 1): -1e-4, (4, 2): 5e-5})
    else:
        defect = defects.Fourrier(supports.SupportRectangle(40, 40), RMS=1e-3, smallest=1.0, seed=11)
    props = {"Divergence": 0, "SourceSize": 30, "Wavelength": 50e-6, "DeltaFT": 1.0, "NumberRays": n_rays}
    return OEPlacement(props, [mirrors.DeformedMirror(base, [defect])], [200.0], [0.0])


def _both(chain, dtype=jnp.float32):
    """(JAX elements, port float64 elements, JAX and port source info)."""
    jels = [e.to_device(dtype=dtype) for e in chain.optical_elements]
    tels = interop.elements_from_numpy(jax.tree.map(np.asarray, jels), device="cpu",
                                       dtype=torch.float64)
    info = chain.source_spec
    return jels, tels, info, interop.source_spec_from_numpy(info)


def _f32(bundle):
    return jax.tree.map(lambda x: np.asarray(x).astype(np.float32)
                        if np.issubdtype(np.asarray(x).dtype, np.floating) else np.asarray(x), bundle)


def _assert_rays_close(got, ref, grazing):
    """Float32 envelopes on alive rays: tests/test_pallas.py:115-119's for
    the parabola at normal incidence (positions atol 2e-3 mm), :40-43's for
    the grazing flagship, whose hits ~1 m from the origin move by a few ulps
    of t (positions median 1e-3 mm, max 5e-2 mm); directions atol 2e-5."""
    ja, ta = np.asarray(ref.alive), got.alive.numpy()
    assert (ja != ta).sum() <= 2  # edge rays may flip
    both = ja & ta
    assert both.sum() > 500
    dp = np.abs(got.p.numpy()[both] - np.asarray(ref.p)[both])
    if grazing:
        assert np.median(dp) < 1e-3 and dp.max() < 5e-2
    else:
        assert dp.max() < 2e-3
    np.testing.assert_allclose(got.d.numpy()[both], np.asarray(ref.d)[both], rtol=0, atol=2e-5)


@pytest.mark.parametrize("kind", ["zernike", "fourrier"])
@pytest.mark.parametrize("ignore", [True, False])
def test_plain_trace_matches_jax(kind, ignore):
    """The lab-frame trace (history of every element) and the chained
    trace through a deformed parabola, float64, against the JAX package's;
    with ignore_defects False the defect slopes turn directions by more than
    1e-5 (tests/test_pallas.py:115-119)."""
    chain = _parabola(kind, n_rays=2000)
    jels, tels, *_ = _both(chain, jnp.float64)
    src = interop.bundle_from_numpy(jax.tree.map(np.asarray, chain.source_rays), device="cpu",
                                    dtype=torch.float64)
    ref = jtr.trace(chain.source_rays, jels, ignore_defects=ignore, keep_history=True)
    got = ttr.trace(src, tels, ignore_defects=ignore, keep_history=True)
    for r, g in zip(ref, got):
        alive = np.asarray(r.alive)
        np.testing.assert_array_equal(g.alive.numpy(), alive)
        assert alive.sum() > 1000
        np.testing.assert_allclose(g.p.numpy()[alive], np.asarray(r.p)[alive], rtol=0, atol=1e-9)
        np.testing.assert_allclose(g.d.numpy()[alive], np.asarray(r.d)[alive], rtol=0, atol=1e-12)
        np.testing.assert_allclose(g.opl.numpy()[alive], np.asarray(r.opl)[alive], rtol=0, atol=1e-9)
        # the JAX package's arccos is the Abramowitz & Stegun 4.4.45
        # polynomial (|error| < 2e-8 rad; tests/test_torch_trace.py)
        np.testing.assert_allclose(g.incidence.numpy()[alive], np.asarray(r.incidence)[alive],
                                   rtol=0, atol=5e-8)
    (step,) = [ttr.trace_step(tels[0], src, ignore)]
    np.testing.assert_array_equal(step.p.numpy(), got[0].p.numpy())
    for freeze in (True, False):
        maps, final = ttr.compose_chain(tels)
        s = ttr.run_chain_chained(ttr.bundle_to_state(src), tels, maps, final, ignore,
                                  freeze_dead=freeze)
        jmaps, jfinal = jtr.compose_chain(jels)
        js = jtr.run_chain_chained(jtr.bundle_to_state(chain.source_rays), jels, jmaps, jfinal,
                                   ignore_defects=ignore, freeze_dead=freeze)
        alive = np.asarray(js.alive)
        np.testing.assert_array_equal(s.alive.numpy(), alive)
        for leaf in ("px", "py", "pz", "opl"):
            np.testing.assert_allclose(getattr(s, leaf).numpy()[alive], np.asarray(getattr(js, leaf))[alive],
                                       rtol=0, atol=1e-9, err_msg=leaf)
    if kind == "zernike" and not ignore:
        base = ttr.trace(src, tels, ignore_defects=True, keep_history=False)
        a = base.alive & got[-1].alive
        assert float((base.d[a] - got[-1].d[a]).abs().max()) > 1e-5


@pytest.mark.parametrize("ignore", [True, False])
@pytest.mark.parametrize("build", ["flagship", "parabola"])
def test_k1_plain_matches_pallas(build, ignore):
    """K1's plain version against _kernel_source (interpret mode) on a
    deformed chain, both ignore_defects; the kernel record takes the chain
    and its Zernike table."""
    chain = _flagship("attosecondraytracing_tpu")[0] if build == "flagship" else _parabola()
    jels, tels, jinfo, tinfo = _both(chain)
    jspec, tspec = jinfo.baked(), tinfo.baked()
    table = ft.chain_table(tspec, tels)
    rec = ft.pack_chain(table, ignore)
    assert rec["n_zernike"] == 1 and rec["ignore_defects"] == ignore
    ref = jpt.pallas_trace_source(jspec, jels, N, ignore_defects=ignore)
    got = ft.fused_source_trace_ref(table, tspec, N, device="cpu", ignore_defects=ignore)
    _assert_rays_close(got, ref, grazing=build == "flagship")
    ft.fused_source_trace.launches = 0
    again = ft.fused_source_trace(table, tspec, N, device="cpu", ignore_defects=ignore)
    assert torch.equal(again.p, got.p) and ft.fused_source_trace.launches == 0


@pytest.mark.parametrize("fresh", [True, False])
def test_k34_plain_matches_pallas(fresh):
    """K4 (fresh) and K3's plain versions against _kernel_fresh / _kernel on
    a bundle through the deformed flagship, ignore_defects False."""
    chain = _flagship("attosecondraytracing_tpu", n_rays=N)[0]
    jels, tels, *_ = _both(chain)
    src = _f32(chain.source_rays)
    ref = jpt.pallas_trace(src, jels, fresh=fresh, ignore_defects=False)
    bundle = interop.bundle_from_numpy(src, device="cpu", dtype=torch.float32)
    got = ft.streamed_trace(ft.chain_table(None, tels), bundle, device="cpu", fresh=fresh,
                            ignore_defects=False)
    _assert_rays_close(got, ref, grazing=True)


def _stats_close(got, ref, w_rtol=1e-5, spot_rtol=2e-3, dur=(0.025, 0.8)):
    np.testing.assert_allclose(got["sum_w"], np.asarray(ref["sum_w"]), rtol=w_rtol)
    np.testing.assert_allclose(got["spot_sd"], np.asarray(ref["spot_sd"]), rtol=spot_rtol, atol=1e-6)
    for k, r in zip(got["duration_sd"], np.asarray(ref["duration_sd"], np.float64)):
        assert abs(k - r) <= dur[0] * r or abs(k * k - r * r) ** 0.5 <= dur[1], (k, r)


@pytest.fixture(scope="module")
def deformed():
    """The deformed flagship in both packages with its detector 10 mm short
    of the focus, and the JAX chief-ray references at 3 distances."""
    chain = _flagship("attosecondraytracing_tpu")[0]
    jels, tels, jinfo, tinfo = _both(chain)
    spec = jinfo.baked()
    det = JDetector(np.zeros(3))
    det.autoplace(jpt.pallas_trace_source(spec, jels, N), 490.0)
    distances = (-5.0, 0.0, 5.0)
    opl_ref, offsets, inv_dn = jpt.chief_ray_refs(spec, jels, det.centre, det.normal, distances)
    return {"chain": chain, "jels": jels, "tels": tels, "jinfo": jinfo, "tinfo": tinfo, "spec": spec,
            "tspec": tinfo.baked(), "det": det, "distances": distances, "opl_ref": opl_ref,
            "offsets": offsets, "inv_dn": inv_dn}


@pytest.mark.parametrize("ignore", [True, False])
def test_k2_plain_matches_pallas(deformed, ignore):
    """K2's plain version against _kernel_source_moments on the deformed
    flagship, Gaussian weights, statistics at 3 distances."""
    d = deformed
    det, dist = d["det"], d["distances"]
    ref = jpt.pallas_source_detector_moments(d["spec"], d["jels"], N, det.centre, det.normal,
                                             det._plane_rotation(), opl_ref=d["opl_ref"],
                                             gaussian_edge=EDGE, ignore_defects=ignore)
    got = ft.source_detector_moments(d["tspec"], d["tels"], N, det.centre, det.normal,
                                     det._plane_rotation(), device="cpu", dtype=torch.float32,
                                     opl_ref=d["opl_ref"], gaussian_edge=EDGE, ignore_defects=ignore)
    assert got["inv_dn_chief"] == pytest.approx(ref["inv_dn_chief"], rel=1e-6)
    stats = [ft.sums_to_stats(ft.moments_to_distance_sums(m["moments"], dist, m["centre_distance"]),
                              m["opl_ref"], dist) for m in (got, ref)]
    _stats_close(*stats)


def test_k8_plain_matches_pallas(deformed):
    """K8's plain version against _kernel_source_stats (interpret mode) on
    the deformed flagship at 3 distances with per-distance delay offsets,
    ignore_defects False."""
    d = deformed
    det, dist = d["det"], d["distances"]
    jdet = jpt.bake_detector(d["jels"], det.centre, det.normal, det._plane_rotation(), dist,
                             opl_ref=d["opl_ref"], delay_offsets=d["offsets"], inv_dn_chief=d["inv_dn"])
    baked, maps, final, premasks = jpt._source_maps(d["spec"], d["jels"])
    tile = jpt.BLOCK_ROWS * jpt.LANES
    rows = -(-N // tile) * tile // jpt.LANES
    outs = jpt._pallas_source_stats_padded(0.0, 0.0, d["spec"], baked, maps, final, premasks, jdet,
                                           jpt.BLOCK_ROWS, True, N, N, rows, EDGE, False)
    ref = np.stack([np.asarray(o, np.float64).sum(axis=0)[:len(dist)] for o in outs])
    tdet = ft.bake_detector(d["tels"], det.centre, det.normal, det._plane_rotation(), opl_ref=d["opl_ref"],
                            inv_dn_chief=d["inv_dn"], distances=dist, delay_offsets=d["offsets"])
    got = ft.fused_source_stats(ft.chain_table(d["tspec"], d["tels"]), d["tspec"], tdet, [(N, 0.0, 0.0)],
                                N, device="cpu", gaussian_edge=EDGE, ignore_defects=False)
    _stats_close(*(ft.sums_to_stats(dict(zip(ft.STATS_FIELDS, s)), d["opl_ref"], dist) for s in (got, ref)))


def test_k5_plain_matches_pallas(deformed):
    """K5's plain version against _kernel_scan_moments on the deformed
    flagship with its second toroid moved (a scan chain), both scan specs
    built with ignore_defects False; the scan tests' tolerances."""
    d = deformed
    chain = _flagship("attosecondraytracing_tpu", distance=505.0)[0]
    jels, tels, jinfo, tinfo = _both(chain)
    jspec = jps.make_scan_spec("cone", jels, N, False)
    tspec = fs.make_scan_spec("cone", tels, N, False)
    assert tspec.ignore_defects is False and fs.pack_scan_chain(tspec)["ignore_defects"] == 0
    args = (d["det"].centre, d["det"].normal, d["det"]._plane_rotation())
    ref = jps.make_moments_fn(jspec, jels, jinfo, N)(*args, gaussian_edge=EDGE, centre_distance=3.0)
    got = fs.make_moments_fn(tspec, tels, tinfo, N, device="cpu")(*args, gaussian_edge=EDGE,
                                                                  centre_distance=3.0)
    dist = (-10.0, 0.0, 10.0)
    stats = [ft.sums_to_stats(ft.moments_to_distance_sums(m["moments"], dist, m["centre_distance"]),
                              m["opl_ref"], dist) for m in (got, ref)]
    _stats_close(*stats, w_rtol=2e-3, spot_rtol=5e-3, dur=(0.03, 0.9))


@pytest.fixture(scope="module")
def grad_problem():
    """The deformed flagship's fused loss in both packages (tests/
    test_gradients.py's _grad_setup on the deformed chain, ignore_defects
    False), JAX's _stats_and_jacobian of its 18 tangent rows and its primal
    pass."""
    from attosecondraytracing_tpu.analysis import alignment as al
    from attosecondraytracing_tpu.ops.trace import trace_jit

    chain = _flagship("attosecondraytracing_tpu", n_rays=N)[0]
    elements = [e.to_device(dtype=jnp.float32) for e in chain.optical_elements]
    info = chain.source_spec
    baked = info.baked()
    det = JDetector(chain.optical_elements[-1].position)
    det.autoplace(trace_jit(jpt.source_bundle(baked, 256, wavelength=80e-6), elements,
                            keep_history=False), 495.0)
    spec = jpg.make_loss_spec(info._replace(gaussian_edge=EDGE, n_rays=N), elements, det.centre,
                              det.normal, ignore_defects=False)
    params = al.zero_params(len(elements), dtype=jnp.float32)
    params = params._replace(angles=params.angles.at[1, 0].set(2e-4).at[2, 2].set(-1e-4),
                             shifts=params.shifts.at[1, 0].set(0.05))
    geo = (np.asarray(baked.rot), np.asarray(info.origin), det.centre, det.normal, det._plane_rotation())
    sprimal = jpg.chain_scalars_np(jpg._apply_params_np(elements, params), *geo)
    flat, unravel = jax.flatten_util.ravel_pytree(params)
    stangents = np.asarray(jax.jacfwd(lambda fp: jpg.chain_scalars(
        al.apply_params(elements, unravel(fp)), *geo))(flat)).T.astype(np.float32)
    p_ref, t_ref = jpg._stats_and_jacobian(sprimal, stangents, spec, jpt.BLOCK_ROWS, 1 << 23)
    tels = interop.elements_from_numpy(jax.tree.map(np.asarray, elements), device="cpu",
                                       dtype=torch.float64)
    tspec = fg.FusedLossSpec(
        source_kind=spec.source_kind, source_radius=spec.source_radius, elements=tuple(tels),
        opl_ref=spec.opl_ref, gaussian_edge=spec.gaussian_edge, n_rays=spec.n_rays,
        duration_weight=spec.duration_weight, survival_weight=spec.survival_weight,
        ignore_defects=spec.ignore_defects)
    return {"sprimal": np.asarray(sprimal, np.float32), "stangents": stangents, "p": np.asarray(p_ref),
            "t": np.asarray(t_ref), "tspec": tspec}


def _assert_sums_close(got, ref, opl_ref):
    """tests/test_torch_fused_grad.py's envelope of the 7 sums."""
    w, _, _, wxx, wyy, _, _ = ref
    assert abs(got[0] - w) <= 1e-5 * w
    scale = np.array([np.sqrt(w * wxx), np.sqrt(w * wyy), wxx, wyy])
    assert np.all(np.abs(got[1:5] - ref[1:5]) <= 1e-4 * scale), (got, ref)
    durs = [ft.sums_to_stats(dict(zip(ft.STATS_FIELDS, s[:, None])), opl_ref, (0.0,))["duration_sd"][0]
            for s in (got, ref)]
    assert abs(durs[0] - durs[1]) <= 0.025 * durs[1] or abs(durs[0] ** 2 - durs[1] ** 2) ** 0.5 <= 0.8


def test_k67_plain_matches_pallas(grad_problem):
    """K6's plain version (all 18 tangent rows in one call, as one K6 launch
    takes them on the card) against JAX's _stats_and_jacobian (interpret
    mode, groups of 6) on the deformed flagship, ignore_defects False; K7's
    plain version equals K6's primal."""
    g = grad_problem
    tspec = g["tspec"]
    assert g["stangents"].shape == (18, fg.n_scalars(3)) and tspec.ignore_defects is False
    chunks = fg._ray_chunks(tspec, fg.GRAD_CHUNK)
    p, t = fg.fused_stats_params(tspec, g["sprimal"], g["stangents"], chunks, device="cpu")
    _assert_sums_close(p, g["p"], tspec.opl_ref)
    scale = np.maximum(np.abs(g["t"]).max(axis=0), 1e-12)
    assert np.all(np.abs(t - g["t"]) <= 2e-3 * scale), (t, g["t"])
    p7, t7 = fg.fused_stats_params(tspec, g["sprimal"], None, chunks, device="cpu")
    assert t7.shape == (0, 7)
    np.testing.assert_allclose(p7, p, rtol=1e-12, atol=0)
    # the slopes enter the loss: the gradient differs from ignore_defects True
    p_ig, t_ig = fg.fused_stats_params(tspec._replace(ignore_defects=True), g["sprimal"], g["stangents"],
                                       chunks, device="cpu")
    assert np.abs(p_ig[3] - p[3]) > 1e-6 * p[3] and np.abs(t_ig - t).max() > 0


def test_main_deformed_flagship_matches_jax(monkeypatch):
    """main.main on the deformed flagship at 1e4 rays with the detector
    optimizer, both packages on their fused engines (the JAX Pallas kernels
    in interpret mode, the port's K1/K2 plain versions), as
    tests/test_torch_slice.py's flagship test runs them."""
    monkeypatch.setenv("ART_TPU_DTYPE", "float64")
    monkeypatch.setattr(jchain, "PALLAS_MIN_RAYS", 1024)
    monkeypatch.setattr(jchain.OpticalChain, "_pallas_eligible", lambda self, els: True)
    monkeypatch.setattr(tchain, "PALLAS_MIN_RAYS", 1024)
    do = {"AutoDetectorDistance": True, "DistanceDetector": 500.0, "OptFor": "intensity"}
    ao = {"verbose": False, "save_results": False}
    jc, props = _flagship("attosecondraytracing_tpu", 10_000)
    jk = jmain.main(jc, props, do, ao)
    assert jc.last_trace_engine == "pallas-source"
    tc, _ = _flagship("attosecondraytracing_tpu_torch", 10_000)
    tk = tmain.main(tc, props, do, ao, device="cpu")
    assert tc.last_trace_engine == "torch-source"
    (jT,), (tT,) = jk["ETransmission"], tk["ETransmission"]
    assert 0 < tT <= 100 and tT == pytest.approx(jT, abs=0.1)
    assert tk["Detector"][0].get_distance() == pytest.approx(jk["Detector"][0].get_distance(), abs=0.05)
    assert tk["SpotSizeSD"][0] == pytest.approx(jk["SpotSizeSD"][0], rel=5e-3)
    tdur, jdur = tk["DurationSD"][0], jk["DurationSD"][0]
    assert abs(tdur - jdur) <= 0.025 * jdur or abs(tdur**2 - jdur**2) ** 0.5 <= 0.8, (tdur, jdur)
