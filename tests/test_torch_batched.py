"""PyTorch port vs the JAX package: the small API names of the ported
modules and the batched parameter scan.

* ``ops/bundle.total_path`` / ``to_host``: float64 optical paths within
  1e-9 mm of the JAX package's on the stigmatic off-axis parabola, and
  Fermat's equal paths to its focus (tests/test_physics.py:20,73);
* ``ops/surfaces.intersect`` / ``normal_at`` on the six surfaces: hit masks
  equal, t within 1e-9 mm, normals within 1e-12 of the JAX package's and
  1e-10 of the host normal (tests/test_surfaces.py:48,71);
* ``analysis/optimizer._scan_fitness``, ``optimal_shift_closed_form`` and
  ``delay_stats_for_shift`` on the same float64 bundle as the JAX
  functions, within 1e-9 relative, and the closed form at the minimum of the
  dense scan (tests/test_sources_chain.py:132-223);
* ``parallel/mesh.stack_chains`` / ``trace_scan``: float64, atol 1e-12
  against the port's serial trace and 1e-9 against the JAX batched trace
  (tests/test_parallel.py::test_scan_batching_matches_serial), and the
  refusal of scans that do not stack;
* ``main.run_ART(precomputed_bundle=)``, ``main._batched_final_bundles``
  with its memory guard, and ``main``'s batched path feeding the fused
  optimizer against the JAX package's, within tests/test_scan_kernel.py's
  run envelope (tests/test_engine_integration.py:282-328)."""

import inspect
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
import jax.numpy as jnp  # noqa: E402
import matplotlib  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

matplotlib.use("Agg", force=True)

from attosecondraytracing_tpu import main as jmain  # noqa: E402
from attosecondraytracing_tpu.analysis import optimizer as jopt  # noqa: E402
from attosecondraytracing_tpu.models import chain as jchain  # noqa: E402
from attosecondraytracing_tpu.models.detector import Detector as JDetector  # noqa: E402
from attosecondraytracing_tpu.ops import bundle as jbundle  # noqa: E402
from attosecondraytracing_tpu.ops import surfaces as jsrf  # noqa: E402
from attosecondraytracing_tpu.parallel import mesh as jmesh  # noqa: E402
from attosecondraytracing_tpu_torch import interop  # noqa: E402
from attosecondraytracing_tpu_torch import main as tmain  # noqa: E402
from attosecondraytracing_tpu_torch.analysis import optimizer as topt  # noqa: E402
from attosecondraytracing_tpu_torch.models import chain as tchain  # noqa: E402
from attosecondraytracing_tpu_torch.ops import bundle as tbundle  # noqa: E402
from attosecondraytracing_tpu_torch.ops import surfaces as tsrf  # noqa: E402
from attosecondraytracing_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from test_torch_fused_scan import _assert_runs_close, _flagship, _patch_thresholds  # noqa: E402
from test_torch_surfaces import IDS, _pair, _rays_towards  # noqa: E402

torch.set_num_threads(1)

JAX, PORT = "attosecondraytracing_tpu", "attosecondraytracing_tpu_torch"


def _models(pkg):
    from importlib import import_module

    return (import_module(f"{pkg}.models.mirrors"), import_module(f"{pkg}.models.supports"),
            import_module(f"{pkg}.models.masks"), import_module(f"{pkg}.models.placement"))


def _parallel_chain(pkg, n_rays, distance=1000.0):
    """tests/test_parallel.py's chain: one 80 deg toroid, f = 500 mm."""
    mirrors, supports, _masks, placement = _models(pkg)
    R, r = mirrors.ReturnOptimalToroidalRadii(500.0, 80.0)
    mirror = mirrors.MirrorToroidal(R, r, supports.SupportRectangle(300, 50))
    props = {"Divergence": 15e-3, "SourceSize": 0, "Wavelength": 50e-6, "DeltaFT": 1,
             "NumberRays": n_rays}
    return placement.OEPlacement(props, [mirror], [distance], [80.0])


def test_total_path_and_to_host_match_jax(monkeypatch):
    """The optical path after a stigmatic off-axis parabola in float64: the
    port's ``total_path`` within 1e-9 mm of the JAX package's, and equal to
    1e-9 mm for every ray to the parabola's focus (Fermat); ``to_host``
    hands back NumPy arrays of the same values."""
    monkeypatch.setenv("ART_TPU_DTYPE", "float64")

    def oap(pkg):
        mirrors, supports, _masks, placement = _models(pkg)
        parabola = mirrors.MirrorParabolic(100.0, 90, supports.SupportRound(12))
        props = {"Divergence": 0, "SourceSize": 20, "Wavelength": 50e-6, "DeltaFT": 1,
                 "NumberRays": 500}
        return placement.OEPlacement(props, [parabola], [200], [0.0]), parabola

    jc, jpar = oap(JAX)
    tc, _ = oap(PORT)
    jout = jc.get_output_rays()[-1]
    tout = tc.to("cpu").get_output_rays()[-1]
    tp = tbundle.total_path(tout)
    assert torch.is_tensor(tp) and tp.dtype == torch.float64
    np.testing.assert_allclose(tp.numpy(), np.asarray(jbundle.total_path(jout)), rtol=0, atol=1e-9)
    host = tbundle.to_host(tout)
    assert type(host) is tbundle.RayBundle and all(isinstance(x, np.ndarray) for x in host)
    np.testing.assert_array_equal(host.opl, tout.opl.numpy())
    np.testing.assert_array_equal(host.alive, tout.alive.numpy())
    el = jc.optical_elements[0]
    focus = el.frame_rotation().T @ (np.array([0.0, 0.0, jpar.p / 2]) - el.type.get_centre()) + el.position
    t_to_focus = np.sum((focus - host.p) * host.d, axis=-1)
    assert host.alive.all()
    assert np.ptp(host.opl - host.opl_c + t_to_focus) < 1e-9


@pytest.mark.parametrize("i", range(7), ids=IDS)
def test_intersect_and_normal_at_match_jax(i, rng):
    """``intersect`` on (N, 3) rays and ``normal_at`` at the hit points,
    against the JAX package's on the same float64 rays."""
    jm, jsurface, tm, tsurface = _pair(i)
    origins, dirs = _rays_towards(jm, rng, 200)
    jt, jhit = jsrf.intersect(jsurface, jm.support, jnp.asarray(origins), jnp.asarray(dirs))
    tt, thit = tsrf.intersect(tsurface, tm.support, torch.as_tensor(origins), torch.as_tensor(dirs))
    hit = np.asarray(jhit)
    np.testing.assert_array_equal(thit.numpy(), hit)
    assert hit.sum() > 50
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=0, atol=1e-9)
    q = origins + tt.numpy()[:, None] * dirs
    tn = tsrf.normal_at(tsurface, torch.as_tensor(q)).numpy()
    jn = np.asarray(jsrf.normal_at(jsurface, jnp.asarray(q)))
    np.testing.assert_allclose(tn[hit], jn[hit], rtol=0, atol=1e-12)
    for k in np.nonzero(hit)[0][:25]:
        np.testing.assert_allclose(tn[k], jm.get_normal(q[k]), atol=1e-10)
        assert tn[k][2] > 0  # 'up' convention


@pytest.fixture(scope="module")
def asymmetric():
    """tests/test_sources_chain.py's asymmetric weighted bundle (an
    off-centre hole mask and a toroid, non-uniform intensities), float64,
    in both packages, and a detector 40 mm short of the focus."""
    mirrors, supports, masks, placement = _models(JAX)
    R, r = mirrors.ReturnOptimalToroidalRadii(500.0, 80.0)
    tor = mirrors.MirrorToroidal(R, r, supports.SupportRectangle(150, 32))
    mask = masks.Mask(supports.SupportRoundHole(20, 7, 3.0, 1.0))
    props = {"Divergence": 20e-3, "SourceSize": 0, "Wavelength": 50e-6, "DeltaFT": 1,
             "NumberRays": 600}
    chain = placement.OEPlacement(props, [mask, tor], [300, 200], [0, 80.0], [0, 0])
    out = chain.get_output_rays()[-1]
    out = out._replace(intensity=np.random.default_rng(3).uniform(0.1, 1.0, out.n_rays))
    det = JDetector(chain.optical_elements[-1].position)
    det.autoplace(out, 960.0)
    tout = interop.bundle_from_numpy(jax.tree.map(np.asarray, out), device="cpu", dtype=torch.float64)
    return out, tout, np.asarray(det.centre), np.asarray(det.normal), np.asarray(det._plane_rotation())


@pytest.mark.parametrize("weighted", [False, True])
def test_closed_form_shift_matches_jax_and_scan_minimum(asymmetric, weighted):
    """``optimal_shift_closed_form`` against the JAX function (1e-9
    relative), and at the minimum of the port's dense ``_scan_fitness`` scan
    around it: within one step, and no scan point below it."""
    jout, tout, centre, normal, rot = asymmetric
    js, jspot = jopt.optimal_shift_closed_form(jout, jnp.asarray(centre), jnp.asarray(normal),
                                               jnp.asarray(rot), intensity_weighted=weighted)
    ts, tspot = topt.optimal_shift_closed_form(tout, centre, normal, rot, intensity_weighted=weighted)
    assert ts.dtype == torch.float64
    assert float(ts) == pytest.approx(float(js), rel=1e-9)
    assert float(tspot) == pytest.approx(float(jspot), rel=1e-9)
    step = 1e-3
    shifts = float(ts) + np.arange(-200, 201) * step
    _, spots, _ = topt._scan_fitness(tout, centre, normal, rot, shifts, "spotsize", weighted)
    k = int(np.argmin(spots))
    assert abs(shifts[k] - float(ts)) <= step
    assert float(tspot) <= spots.min() * (1 + 1e-10)


@pytest.mark.parametrize("opt_for", ["spotsize", "duration", "intensity"])
def test_scan_fitness_and_delay_stats_match_jax(asymmetric, opt_for):
    """``_scan_fitness`` (fitness, spot, duration per shift) and
    ``delay_stats_for_shift`` against the JAX functions, 1e-9 relative."""
    jout, tout, centre, normal, rot = asymmetric
    shifts = np.linspace(-30.0, 50.0, 9)
    ref = jopt._scan_fitness(jout, jnp.asarray(centre), jnp.asarray(normal), jnp.asarray(rot),
                             jnp.asarray(shifts), opt_for, True)
    got = topt._scan_fitness(tout, centre, normal, rot, shifts, opt_for, True)
    for g, r in zip(got, ref):
        assert g.dtype == np.float64 and g.shape == shifts.shape
        np.testing.assert_allclose(g, np.asarray(r), rtol=1e-9, atol=1e-15)
    for shift in (-12.5, 0.0, 40.0):
        ref_d = jopt.delay_stats_for_shift(jout, jnp.asarray(centre), jnp.asarray(normal), shift)
        got_d = topt.delay_stats_for_shift(tout, centre, normal, shift)
        assert float(got_d) == pytest.approx(float(ref_d), rel=1e-9)


def test_scan_batching_matches_serial(monkeypatch):
    """Four rolls of tests/test_parallel.py's chain stacked and traced once:
    every chain equals the port's serial trace (float64, atol 1e-12, dead
    rays included) and the JAX package's batched trace (1e-9 on alive
    rays)."""
    monkeypatch.setenv("ART_TPU_DTYPE", "float64")
    rolls = np.linspace(-0.2, 0.2, 4)
    jchains = _parallel_chain(JAX, 128).get_OE_loop_list(0, "roll", rolls)
    tchains = [c.to("cpu") for c in _parallel_chain(PORT, 128).get_OE_loop_list(0, "roll", rolls)]
    stacked_elements, stacked_sources = tmesh.stack_chains(tchains)
    assert stacked_sources.p.shape == (4, 128, 3) and stacked_sources.wavelength.shape == (4,)
    assert stacked_elements[0].rot.shape == (4, 3, 3) and stacked_elements[0].centre.shape == (4, 3)
    batched = tmesh.trace_scan(stacked_sources, stacked_elements)
    jelements, jsources = jmesh.stack_chains(jchains)
    jbatched = jmesh.trace_scan(jsources, jelements)
    for i, c in enumerate(tchains):
        ref = c.trace_final()
        got = tbundle.RayBundle(*(x[i] for x in batched))
        np.testing.assert_allclose(got.p.numpy(), ref.p.numpy(), rtol=0, atol=1e-12)
        np.testing.assert_allclose(got.d.numpy(), ref.d.numpy(), rtol=0, atol=1e-12)
        np.testing.assert_array_equal(got.alive.numpy(), ref.alive.numpy())
        alive = np.asarray(jbatched.alive)[i]
        np.testing.assert_array_equal(got.alive.numpy(), alive)
        assert alive.sum() > 60
        np.testing.assert_allclose(got.p.numpy()[alive], np.asarray(jbatched.p)[i][alive], rtol=0,
                                   atol=1e-9)
        np.testing.assert_allclose(tbundle.total_path(got).numpy()[alive],
                                   np.asarray(jbundle.total_path(jbatched))[i][alive], rtol=0, atol=1e-9)


def test_stack_chains_refuses_mixed_scans():
    """Chains that differ beyond their poses (another mirror, another ray
    count) do not stack: ValueError, as in the JAX package, and
    ``scan_unbatchable`` says why."""
    a = _parallel_chain(PORT, 64).to("cpu")
    mirrors, supports, _masks, placement = _models(PORT)
    other = placement.OEPlacement(
        {"Divergence": 15e-3, "SourceSize": 0, "Wavelength": 50e-6, "NumberRays": 64},
        [mirrors.MirrorSpherical(600, supports.SupportRound(20))], [1000.0], [10.0]).to("cpu")
    with pytest.raises(ValueError, match="element structures"):
        tmesh.stack_chains([a, other])
    with pytest.raises(ValueError, match="ray counts"):
        tmesh.stack_chains([a, _parallel_chain(PORT, 65).to("cpu")])
    assert tmesh.scan_unbatchable([a, a.copy_chain()]) is None


def test_run_ART_takes_a_precomputed_bundle():
    """``run_ART``'s positional slots are the JAX package's, and a
    precomputed bundle replaces the trace: the same results as the chain's
    own trace."""
    jparams = list(inspect.signature(jmain.run_ART).parameters)
    tparams = list(inspect.signature(tmain.run_ART).parameters)
    assert tparams[:len(jparams)] == jparams == [
        "chain", "SourceProperties", "DetectorOptions", "AnalysisOptions", "loop",
        "precomputed_bundle"]
    do = {"DistanceDetector": 1000.0, "AutoDetectorDistance": True, "OptFor": "spotsize"}
    sp, do, ao = tmain.complete_defaults({}, do, {"verbose": False})
    chain = _parallel_chain(PORT, 512).to("cpu")
    own = tmain.run_ART(chain, sp, do, ao, device="cpu")
    bundle = chain.trace_final()
    given = tmain.run_ART(chain, sp, do, ao, False, bundle, device="cpu")
    assert given[2:] == own[2:]
    assert given[1].get_distance() == own[1].get_distance()


def test_batched_final_bundles_and_memory_guard(monkeypatch, capsys):
    """``_batched_final_bundles``: the stacked trace's bundles, equal to each
    chain's own trace; None with the JAX package's stderr line when the
    stacked sources would pass ART_TPU_SCAN_STACK_MAX_BYTES, and when the
    chains do not stack."""
    chains = [c.to("cpu") for c in _flagship(PORT, 2048).get_OE_loop_list(1, "roll", [-0.1, 0.1])]
    monkeypatch.setenv("ART_TPU_SCAN_STACK_MAX_BYTES", "1000")
    assert tmain._batched_final_bundles(chains) is None
    assert "batched scan skipped" in capsys.readouterr().err
    monkeypatch.delenv("ART_TPU_SCAN_STACK_MAX_BYTES")
    bundles = tmain._batched_final_bundles(chains)
    assert [c.last_trace_engine for c in chains] == ["trace-scan"] * 2
    for c, b in zip(chains, bundles):
        ref = c.trace_final()
        assert c.last_trace_engine == "trace" and b.n_rays == 2048
        assert torch.equal(b.p, ref.p) and torch.equal(b.alive, ref.alive)
    short = _flagship(PORT, 1024).to("cpu")
    assert tmain._batched_final_bundles([chains[0], short]) is None
    assert "batched scan unavailable" in capsys.readouterr().err


def test_main_batched_scan_feeds_fused_optimizer(monkeypatch, capsys):
    """A scan the scan engine does not take (``scan_engine="off"``, the JAX
    package's ART_TPU_SCAN_ENGINE=off) whose chains take the plain trace
    (ART_TPU_ENGINE=trace) runs the batched trace, and the fused optimizer
    engages on its bundles, in both packages; the two agree chain by chain,
    and the port's batched path agrees with its serial plain trace (the
    memory guard at 0 bytes), its scan engine and its serial fused engine,
    all within tests/test_scan_kernel.py:308-313's run envelope. A chain
    that qualifies for the fused engine keeps it: without
    ART_TPU_ENGINE=trace the port does not batch."""
    _patch_thresholds(monkeypatch)
    monkeypatch.setattr(jmain, "_CLI_ACTIVE", True)
    sp = {"NumberRays": 4096}
    do = {"AutoDetectorDistance": True, "DistanceDetector": 500.0, "OptFor": "spotsize"}
    ao = {"verbose": True, "save_results": False}
    rolls = np.linspace(-0.2, 0.2, 4)
    monkeypatch.setenv("ART_TPU_SCAN_ENGINE", "off")
    jk = jmain.main(_flagship(JAX, 4096).get_OE_loop_list(1, "roll", rolls), sp, do, ao)
    assert capsys.readouterr().out.count("[fused kernel scan over all rays]") == 4
    tchains = _flagship(PORT, 4096).get_OE_loop_list(1, "roll", rolls)
    monkeypatch.setenv("ART_TPU_ENGINE", "trace")
    off = tmain.main(tchains, sp, do, ao, device="cpu", scan_engine="off")
    assert [c.last_trace_engine for c in tchains] == ["trace-scan"] * 4
    assert capsys.readouterr().out.count("[fused kernel scan over all rays]") == 4
    _assert_runs_close(off, jk)
    monkeypatch.setenv("ART_TPU_SCAN_STACK_MAX_BYTES", "0")
    serial = tmain.main(tchains, sp, do, ao, device="cpu", scan_engine="off")
    assert [c.last_trace_engine for c in tchains] == ["trace"] * 4
    assert "batched scan skipped" in capsys.readouterr().err
    _assert_runs_close(off, serial)
    monkeypatch.delenv("ART_TPU_SCAN_STACK_MAX_BYTES")
    monkeypatch.delenv("ART_TPU_ENGINE")
    fused = tmain.main(tchains, sp, do, ao, device="cpu")
    assert [c.last_trace_engine for c in tchains] == ["torch-scan"] * 4
    _assert_runs_close(off, fused)
    kernels = tmain.main(tchains, sp, do, ao, device="cpu", scan_engine="off")
    assert [c.last_trace_engine for c in tchains] == ["torch-source"] * 4
    assert "batched scan" not in capsys.readouterr().err
    _assert_runs_close(off, kernels)
    assert jchain.PALLAS_MIN_RAYS == tchain.PALLAS_MIN_RAYS == 1024
