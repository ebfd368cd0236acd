"""PyTorch port vs the JAX package: the host-side model layer (float64):
OEPlacement poses and source bundles, mirror helpers, detector placement and
response, the grid-refinement optimizer, and a round trip through
``interop``."""

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
import numpy as np
import pytest

from attosecondraytracing_tpu.analysis.optimizer import FindOptimalDistance as JFind
from attosecondraytracing_tpu.models import masks as jmask
from attosecondraytracing_tpu.models import mirrors as jmirror
from attosecondraytracing_tpu.models import sources as jsource
from attosecondraytracing_tpu.models import supports as jsupp
from attosecondraytracing_tpu.models.detector import Detector as JDetector
from attosecondraytracing_tpu.models.placement import OEPlacement as JPlacement
from attosecondraytracing_tpu.ops.trace import trace as jtrace
from attosecondraytracing_tpu_torch import interop
from attosecondraytracing_tpu_torch.analysis.optimizer import FindOptimalDistance as TFind
from attosecondraytracing_tpu_torch.models import masks as tmask
from attosecondraytracing_tpu_torch.models import mirrors as tmirror
from attosecondraytracing_tpu_torch.models import sources as tsource
from attosecondraytracing_tpu_torch.models import supports as tsupp
from attosecondraytracing_tpu_torch.models.detector import Detector as TDetector
from attosecondraytracing_tpu_torch.models.placement import OEPlacement as TPlacement

torch.set_num_threads(1)


def _flagship(mirror, mask, supp, place, n=2000):
    R, r = mirror.ReturnOptimalToroidalRadii(500.0, 80.0)
    tor = mirror.MirrorToroidal(R, r, supp.SupportRectangle(150, 32))
    msk = mask.Mask(supp.SupportRoundHole(20, 7, 0, 0))
    props = {"Divergence": 25e-3, "SourceSize": 0, "Wavelength": 80e-6, "DeltaFT": 0.5, "NumberRays": n}
    return place(props, [msk, tor, tor], [400, 100, 500], [0, 80, -80], [0, 0, 0], "flagship")


def _parabola_scan(mirror, mask, supp, place, n=1000):
    par = mirror.MirrorParabolic(100, 90, supp.SupportRoundHole(30, 5, 10, 5))
    props = {"Divergence": 0, "SourceSize": 50, "Wavelength": 800e-6, "DeltaFT": 2.7, "NumberRays": n}
    return place(props, [par], [[150.0, 200.0, 250.0]], [0.0])


def _extended(mirror, mask, supp, place, n=4000):
    sph = mirror.MirrorSpherical(-600, supp.SupportRound(20))
    props = {"Divergence": 2e-3, "SourceSize": 0.1, "Wavelength": 50e-6, "NumberRays": n}
    return place(props, [sph], [300], [5.0], [30.0])


JAX_MODELS = (jmirror, jmask, jsupp, JPlacement)
TORCH_MODELS = (tmirror, tmask, tsupp, TPlacement)


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _assert_chain_equal(tc, jc):
    for te, je in zip(tc.optical_elements, jc.optical_elements):
        for attr in ("position", "normal", "majoraxis"):
            np.testing.assert_allclose(getattr(te, attr), getattr(je, attr), rtol=0, atol=1e-12)
    for leaf in ("p", "d", "intensity", "wavelength", "opl", "alive"):
        np.testing.assert_allclose(_np(getattr(tc.source_rays, leaf)),
                                   np.asarray(getattr(jc.source_rays, leaf)), rtol=1e-12, atol=1e-12)
    assert tc.source_spec == interop.source_spec_from_numpy(jc.source_spec)
    assert tc.loop_variable_name == jc.loop_variable_name
    assert tc.loop_variable_value == jc.loop_variable_value


@pytest.mark.parametrize("build", [_flagship, _parabola_scan, _extended],
                         ids=["flagship", "parabola_scan", "extended"])
def test_oeplacement_matches_jax(build):
    jc, tc = build(*JAX_MODELS), build(*TORCH_MODELS)
    jcs = jc if isinstance(jc, list) else [jc]
    tcs = tc if isinstance(tc, list) else [tc]
    assert len(jcs) == len(tcs)
    for a, b in zip(tcs, jcs):
        _assert_chain_equal(a, b)


@pytest.mark.parametrize("i", range(6))
def test_mirror_classes_match_jax(i):
    def mirrors(m, s):
        return [
            m.MirrorPlane(s.SupportRound(20)),
            m.MirrorSpherical(-600, s.SupportRound(20)),
            m.MirrorParabolic(100, 60, s.SupportRound(12)),
            m.MirrorToroidal(*m.ReturnOptimalToroidalRadii(500, 80), s.SupportRectangle(150, 32)),
            m.MirrorEllipsoidal(s.SupportRectangle(80, 30), *m.ReturnOptimalEllipsoidalAxes(600, 75)),
            m.MirrorCylindrical(800, s.SupportRectangleHole(60, 30, 5, 1, 2)),
        ]

    jm, tm = mirrors(jmirror, jsupp)[i], mirrors(tmirror, tsupp)[i]
    assert tm.type == jm.type
    np.testing.assert_allclose(tm.get_centre(), jm.get_centre(), rtol=1e-15)
    np.testing.assert_allclose(tuple(tm.surface_params()), tuple(jm.surface_params()), rtol=1e-15)
    q = tm.get_centre() + np.array([0.3, -0.2, 0.0])
    np.testing.assert_allclose(tm.get_normal(q), jm.get_normal(q), rtol=1e-15)
    p, d = tm.get_centre() + np.array([1.0, 2.0, 300.0]), np.array([0.001, -0.002, -1.0])
    d = d / np.linalg.norm(d)
    hit_t, hit_j = tm._intersect_host(p, d), jm._intersect_host(p, d)
    assert (hit_t is None) == (hit_j is None)
    if hit_j is not None:
        np.testing.assert_allclose(hit_t, hit_j, rtol=1e-12)


def test_gaussian_profile_matches_jax():
    jb = jsource.ApplyGaussianIntensityToRayList(jsource.PointSource(np.zeros(3), [1, 0, 0], 0.02, 3000), 0.2)
    tb = tsource.ApplyGaussianIntensityToRayList(tsource.PointSource(np.zeros(3), [1, 0, 0], 0.02, 3000), 0.2)
    np.testing.assert_allclose(tb.intensity.numpy(), np.asarray(jb.intensity), rtol=1e-12)
    jb = jsource.PlaneWaveSquare(np.ones(3), [0, 1, 0], 10.0, 900)
    tb = tsource.PlaneWaveSquare(np.ones(3), [0, 1, 0], 10.0, 900)
    np.testing.assert_allclose(tb.p.numpy(), np.asarray(jb.p), rtol=1e-12)


@pytest.fixture(scope="module")
def traced():
    jc = _flagship(*JAX_MODELS)
    jout = jtrace(jc.source_rays, jc.device_elements(), keep_history=False)
    tout = interop.bundle_from_numpy(jout, device="cpu", dtype=torch.float64)
    return jc, jout, tout


def test_detector_autoplace_and_response_match_jax(traced):
    jc, jout, tout = traced
    jd, td = JDetector(np.zeros(3)), TDetector(np.zeros(3))
    jd.autoplace(jout, 495.0)
    td.autoplace(tout, 495.0)
    for attr in ("centre", "normal", "refpoint"):
        np.testing.assert_allclose(getattr(td, attr), getattr(jd, attr), rtol=0, atol=1e-12)
    assert td.get_distance() == pytest.approx(jd.get_distance(), abs=1e-12)
    np.testing.assert_allclose(td.get_PointList2D(tout).numpy(), np.asarray(jd.get_PointList2D(jout)),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(td.get_Delays(tout).numpy(), np.asarray(jd.get_Delays(jout)),
                               rtol=0, atol=1e-9)
    for weighted in (False, True):
        ts, tdur = td.get_SpotAndDuration(tout, weighted)
        js, jdur = jd.get_SpotAndDuration(jout, weighted)
        assert float(ts) == pytest.approx(float(js), rel=1e-12)
        assert float(tdur) == pytest.approx(float(jdur), rel=1e-9)


@pytest.mark.parametrize("opt_for", ["intensity", "spotsize", "duration"])
def test_grid_optimizer_matches_jax(traced, opt_for):
    jc, jout, tout = traced
    jd, td = JDetector(np.zeros(3)), TDetector(np.zeros(3))
    jd.autoplace(jout, 480.0)
    td.autoplace(tout, 480.0)
    jres = JFind(jd, jout, opt_for, Amplitude=40.0, Precision=2, IntensityWeighted=True)
    tres = TFind(td, tout, opt_for, Amplitude=40.0, Precision=2, IntensityWeighted=True)
    assert tres[0].get_distance() == pytest.approx(jres[0].get_distance(), abs=1e-9)
    for a, b in zip(tres[1:], jres[1:]):
        if not np.isnan(b):
            assert a == pytest.approx(float(b), rel=1e-9)


def test_interop_round_trip():
    """JAX-package records carried across equal the port's own records."""
    jc, tc = _flagship(*JAX_MODELS), _flagship(*TORCH_MODELS)
    carried = interop.elements_from_numpy(jax.tree.map(np.asarray, jc.device_elements()),
                                          device="cpu", dtype=torch.float64)
    own = tc.to("cpu").device_elements(torch.float64)
    for a, b in zip(carried, own):
        assert type(a) is type(b)
        for x, y in zip(a, b):
            if torch.is_tensor(x):
                assert x.dtype == torch.float64 and torch.equal(x, y)
            else:
                assert x == y
    bundle = interop.bundle_from_numpy(jc.source_rays, device="cpu", dtype=torch.float32)
    assert bundle.p.dtype == torch.float32 and bundle.alive.dtype == torch.bool
    np.testing.assert_allclose(bundle.p.numpy(), tc.source_rays.p.numpy(), rtol=1e-7, atol=1e-7)
    assert interop.source_spec_from_numpy(jc.source_spec) == tc.source_spec
    assert interop.source_spec_from_numpy(jc.source_spec.baked()) == tc.source_spec.baked()
    with pytest.raises(TypeError):
        interop.elements_from_numpy([object()], device="cpu", dtype=torch.float64)


def test_bundle_padding_and_compaction_match_jax(traced):
    from attosecondraytracing_tpu.ops import bundle as jbundle
    from attosecondraytracing_tpu_torch.ops import bundle as tbundle

    _, jout, tout = traced
    jpad, tpad = jbundle.pad_bundle(jout, jout.n_rays + 37), tbundle.pad_bundle(tout, tout.n_rays + 37)
    jcomp, jidx = jbundle.compact_host(jout)
    tcomp, tidx = tbundle.compact_host(tout)
    np.testing.assert_array_equal(tidx.numpy(), jidx)
    for a, b in ((tpad, jpad), (tcomp, jcomp)):
        for leaf in a._fields:
            np.testing.assert_array_equal(getattr(a, leaf).numpy(), np.asarray(getattr(b, leaf)), err_msg=leaf)
    with pytest.raises(ValueError):
        tbundle.pad_bundle(tout, 3)
