"""PyTorch port vs the JAX package: the six mirror surfaces' intersections
and normals on seeded rays, in float64 (t within 1e-9 mm) and float32 (the
gates of tests/test_surfaces.py: the float32 root within a few ulps of the
float64 one, and the float32 flagship transmission within 0.1 %)."""

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
from attosecondraytracing_tpu.models.placement import OEPlacement as JPlacement
from attosecondraytracing_tpu.ops import surfaces as jsrf
from attosecondraytracing_tpu.ops import trace as jtrace
from attosecondraytracing_tpu_torch.analysis import stats as tstats
from attosecondraytracing_tpu_torch.models import mirrors as tmirror
from attosecondraytracing_tpu_torch.models import supports as tsupp
from attosecondraytracing_tpu_torch.ops import surfaces as tsrf
from attosecondraytracing_tpu_torch import interop

torch.set_num_threads(1)


def _mirrors(mirror, supp):
    return [
        mirror.MirrorPlane(supp.SupportRound(20)),
        mirror.MirrorSpherical(600, supp.SupportRound(20)),
        mirror.MirrorParabolic(100, 90, supp.SupportRound(12)),
        mirror.MirrorParabolic(25.4, 0, supp.SupportRectangle(20, 20)),
        mirror.MirrorToroidal(*mirror.ReturnOptimalToroidalRadii(500, 80), supp.SupportRectangle(150, 32)),
        mirror.MirrorEllipsoidal(supp.SupportRectangle(80, 30), *mirror.ReturnOptimalEllipsoidalAxes(600, 75)),
        mirror.MirrorCylindrical(800, supp.SupportRectangle(60, 30)),
    ]


IDS = ["plane", "sphere", "parabola90", "parabola0", "toroid", "ellipsoid", "cylinder"]


def _rays_towards(mirror, rng, n):
    """Random rays aimed at the neighbourhood of the mirror patch centre
    from its 'up' side (the JAX package's test geometry)."""
    centre = mirror.get_centre()
    n_hat = mirror.get_normal(centre)
    dist = rng.uniform(100, 800, size=n)
    lateral = rng.normal(scale=20.0, size=(n, 3))
    lateral -= np.outer(lateral @ n_hat, n_hat)
    origins = centre + np.outer(dist, n_hat) + lateral
    targets = centre + rng.normal(scale=5.0, size=(n, 3))
    dirs = targets - origins
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return origins, dirs


def _pair(i):
    jm = _mirrors(jmirror, jsupp)[i]
    tm = _mirrors(tmirror, tsupp)[i]
    tsurface = tm.surface_params()
    return jm, jm.surface_params(), tm, type(tsurface)(*(float(v) for v in tsurface))


def _comps(a, dtype):
    t = torch.as_tensor(a, dtype=dtype)
    return (t[:, 0], t[:, 1], t[:, 2])


@pytest.mark.parametrize("i", range(7), ids=IDS)
def test_intersect_float64_matches_jax(i, rng):
    jm, jsurface, tm, tsurface = _pair(i)
    q, u = _rays_towards(jm, rng, 400)
    jt, jhit, jn, jx = jsrf.intersect_with_normal_c(
        jsurface, jm.support, tuple(jnp.asarray(q.T)), tuple(jnp.asarray(u.T)))
    tt, thit, tn, tx = tsrf.intersect_with_normal_c(
        tsurface, tm.support, _comps(q, torch.float64), _comps(u, torch.float64))
    hit = np.asarray(jhit)
    np.testing.assert_array_equal(thit.numpy(), hit)
    assert hit.sum() > 50
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=0, atol=1e-9)
    for a, b in zip(tn, jn):
        np.testing.assert_allclose(a.numpy()[hit], np.asarray(b)[hit], rtol=0, atol=1e-12)
    for a, b in zip(tx, jx):
        np.testing.assert_allclose(a.numpy()[hit], np.asarray(b)[hit], rtol=0, atol=1e-9)
    # the two-output form agrees with the fused one
    t2, hit2 = tsrf.intersect_c(tsurface, tm.support, _comps(q, torch.float64), _comps(u, torch.float64))
    np.testing.assert_array_equal(hit2.numpy(), hit)
    np.testing.assert_allclose(t2.numpy(), tt.numpy(), rtol=0, atol=1e-9)


@pytest.mark.parametrize("i", range(7), ids=IDS)
def test_intersect_float32_accuracy(i, rng):
    """Float32 roots (the toroid on its paraboloid-seed fast path) stay
    within the float32 envelope of the JAX package's float64 roots
    (tests/test_surfaces.py::test_toroid_float32_accuracy gates)."""
    jm, jsurface, tm, tsurface = _pair(i)
    q, u = _rays_towards(jm, rng, 500)
    j64, jhit = jsrf.intersect_c(jsurface, jm.support, tuple(jnp.asarray(q.T)), tuple(jnp.asarray(u.T)))
    t32, hit32 = tsrf.intersect_with_normal_c(
        tsurface, tm.support, _comps(q, torch.float32), _comps(u, torch.float32))[:2]
    assert t32.dtype == torch.float32
    h64, h32 = np.asarray(jhit), hit32.numpy()
    assert np.mean(h64 == h32) > 0.98
    both = h64 & h32
    err = np.abs(t32.numpy()[both] - np.asarray(j64)[both])
    assert np.median(err) < 3e-4
    assert np.percentile(err, 99) < 1.5e-3


def test_float32_flagship_transmission_error_bound():
    """The float32 trace of the flagship (mask + two 80 deg toroids) flips
    few edge rays: transmission within 0.1 % of the JAX float64 trace
    (tests/test_surfaces.py::test_float32_transmission_error_bound, at 2e4
    rays)."""
    R, r = jmirror.ReturnOptimalToroidalRadii(500.0, 80.0)
    tor = jmirror.MirrorToroidal(R, r, jsupp.SupportRectangle(150, 32))
    mask = jmask.Mask(jsupp.SupportRoundHole(20, 7, 0, 0))
    props = {"Divergence": 25e-3, "SourceSize": 0, "Wavelength": 80e-6,
             "DeltaFT": 0.5, "NumberRays": 20000}
    chain = JPlacement(props, [mask, tor, tor], [400, 100, 500], [0, 80, -80], [0, 0, 0])
    out64 = jtrace.trace(chain.source_rays, chain.device_elements(), keep_history=False)
    w64 = np.asarray(out64.alive) * np.asarray(chain.source_rays.intensity)
    et64 = 100.0 * w64.sum() / np.asarray(chain.source_rays.intensity).sum()

    els = interop.elements_from_numpy(jax.tree.map(np.asarray, chain.device_elements()),
                                      device="cpu", dtype=torch.float32)
    src = interop.bundle_from_numpy(chain.source_rays, device="cpu", dtype=torch.float32)
    from attosecondraytracing_tpu_torch.ops.trace import trace

    out32 = trace(src, els, keep_history=False)
    et32 = tstats.energy_transmission(src, out32)
    assert 0.0 < et64 < 100.0
    assert abs(et32 - et64) < 0.1, (et32, et64)
