"""PyTorch port vs the JAX package: geometry helpers and the five support
inclusion tests on the same seeded inputs, float64 (rtol 1e-12)."""

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

import jax.numpy as jnp
import numpy as np
import pytest

from attosecondraytracing_tpu.ops import geometry as jgeo
from attosecondraytracing_tpu.ops import supports as jsup
from attosecondraytracing_tpu_torch.ops import geometry as tgeo
from attosecondraytracing_tpu_torch.ops import supports as tsup

torch.set_num_threads(1)


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


def _cases(rng):
    a = rng.normal(size=(64, 3))
    b = rng.normal(size=(64, 3))
    n = b / np.linalg.norm(b, axis=-1, keepdims=True)
    axis, angle = rng.normal(size=3), float(rng.uniform(-3, 3))
    m = np.cross(n[0], rng.normal(size=3))
    m /= np.linalg.norm(m)
    plane_p, plane_n = rng.normal(size=3), n[1]
    x = rng.uniform(900.0, 1100.0, size=64)
    s, c = rng.normal(size=64) * 1e3, rng.normal(size=64) * 1e-13
    return {
        "normalize": (lambda: jgeo.normalize(jnp.asarray(a)), lambda: tgeo.normalize(_t(a))),
        "angle_between": (lambda: jgeo.angle_between(jnp.asarray(a), jnp.asarray(b)),
                          lambda: tgeo.angle_between(_t(a), _t(b))),
        "rotation_around_axis": (lambda: jgeo.rotation_around_axis(axis, angle),
                                 lambda: tgeo.rotation_around_axis(axis, angle)),
        "frame_rotation": (lambda: jgeo.frame_rotation(n[0], m),
                           lambda: tgeo.frame_rotation(_t(n[0]), _t(m))),
        "vogel_spiral": (lambda: jgeo.vogel_spiral(1000, 12.5),
                         lambda: tgeo.vogel_spiral(1000, 12.5)),
        "reflect": (lambda: jgeo.reflect(jnp.asarray(a), jnp.asarray(n)),
                    lambda: tgeo.reflect(_t(a), _t(n))),
        "kahan_add": (lambda: jnp.stack(jgeo.kahan_add(jnp.asarray(s), jnp.asarray(c), jnp.asarray(x))),
                      lambda: torch.stack(tgeo.kahan_add(_t(s), _t(c), _t(x)))),
        "line_plane_intersection": (
            lambda: jnp.concatenate([jgeo.line_plane_intersection(jnp.asarray(a), jnp.asarray(n), plane_p, plane_n)[1],
                                     jgeo.line_plane_intersection(jnp.asarray(a), jnp.asarray(n), plane_p, plane_n)[0][:, None]], axis=1),
            lambda: torch.cat([tgeo.line_plane_intersection(_t(a), _t(n), _t(plane_p), _t(plane_n))[1],
                               tgeo.line_plane_intersection(_t(a), _t(n), _t(plane_p), _t(plane_n))[0][:, None]], dim=1)),
    }


GEOMETRY = ("normalize", "angle_between", "rotation_around_axis", "frame_rotation",
            "vogel_spiral", "reflect", "kahan_add", "line_plane_intersection")


@pytest.mark.parametrize("name", GEOMETRY)
def test_geometry_matches_jax(name, rng):
    jax_fn, torch_fn = _cases(rng)[name]
    ref = np.asarray(jax_fn())
    got = torch_fn()
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=1e-12)


def test_kahan_add_float32_is_bitwise_jax(rng):
    """The compensation survives float32 in both packages identically: each
    step is an unfused float32 operation."""
    xs = rng.uniform(900.0, 1100.0, size=(64, 256)).astype(np.float32)
    js = jc = jnp.zeros(256, jnp.float32)
    ts = tc = torch.zeros(256, dtype=torch.float32)
    for x in xs:
        js, jc = jgeo.kahan_add(js, jc, jnp.asarray(x))
        ts, tc = tgeo.kahan_add(ts, tc, torch.as_tensor(x))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


SUPPORTS = {
    "SupportRound": (12.0,),
    "SupportRoundHole": (30.0, 5.0, 10.0, 5.0),
    "SupportRectangle": (150.0, 32.0),
    "SupportRectangleHole": (60.0, 30.0, 7.0, 3.0, -2.0),
    "SupportRectangleRectHole": (60.0, 30.0, 10.0, 6.0, 4.0, -3.0),
}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("name", sorted(SUPPORTS))
def test_support_include_matches_jax(name, dtype, rng):
    args = SUPPORTS[name]
    jsupport = getattr(jsup, name)(*args)
    tsupport = getattr(tsup, name)(*args)
    xy = rng.uniform(-40.0, 40.0, size=(2, 20000))
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    x, y = xy.astype(np_dtype)
    ref = np.asarray(jsup.include(jsupport, jnp.asarray(x), jnp.asarray(y)))
    got = tsup.include(tsupport, torch.as_tensor(x), torch.as_tensor(y))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), ref)
    assert 0 < ref.sum() < ref.size  # the draw straddles every boundary
