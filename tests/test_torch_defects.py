"""PyTorch port vs the JAX package: surface defects on the host and in the
lookups the trace runs (ops/zernike.py, ops/defects.py, models/defects.py,
DeformedMirror), the JAX records carried across by ``interop``, and the
engine rule's refusals of what the kernels do not take.

Inputs are made with numpy from a seed. Tolerances: the Zernike recurrence
and the defect lookups run the same operations in the same order in float64
in both packages, so they agree to 1e-12 (relative for the recurrence's
values, absolute in mm and rad for the lookups); the host defect maps are
the same NumPy code (Fourrier's float32 k-grid included) and agree to 1e-12
relative; host intersections to 1e-9 mm."""

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
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from attosecondraytracing_tpu.models import defects as jdef  # noqa: E402
from attosecondraytracing_tpu.models import mirrors as jmirror  # noqa: E402
from attosecondraytracing_tpu.models import supports as jsupp  # noqa: E402
from attosecondraytracing_tpu.models.placement import OEPlacement as JPlacement  # noqa: E402
from attosecondraytracing_tpu.ops import defects as jodef  # noqa: E402
from attosecondraytracing_tpu.ops.zernike import zernike_value_and_grad as jzernike  # noqa: E402
from attosecondraytracing_tpu_torch import interop  # noqa: E402
from attosecondraytracing_tpu_torch.models import chain as tchain  # noqa: E402
from attosecondraytracing_tpu_torch.models import defects as tdef  # noqa: E402
from attosecondraytracing_tpu_torch.models import mirrors as tmirror  # noqa: E402
from attosecondraytracing_tpu_torch.models import supports as tsupp  # noqa: E402
from attosecondraytracing_tpu_torch.models.placement import OEPlacement as TPlacement  # noqa: E402
from attosecondraytracing_tpu_torch.ops import defects as todef  # noqa: E402
from attosecondraytracing_tpu_torch.ops import fused_trace as ft  # noqa: E402
from attosecondraytracing_tpu_torch.ops.zernike import zernike_value_and_grad as tzernike  # noqa: E402

torch.set_num_threads(1)

COEFFS = {(2, 0): 1e-4, (3, 1): -2e-4, (4, 2): 5e-5, (6, 3): 2e-5}


@pytest.mark.parametrize("order", [2, 3, 4, 5, 6, 7, 8])
def test_zernike_recurrence_matches_jax(order, rng):
    """Values and both gradients of every (n, m) up to ``order``, float64,
    on NumPy arrays (the host models) and on tensors (the trace)."""
    x = rng.uniform(-0.95, 0.95, size=64)
    y = rng.uniform(-0.95, 0.95, size=64) * np.sqrt(1 - x**2)
    ref = jzernike(x, y, order)
    for got in (tzernike(x, y, order), tzernike(torch.from_numpy(x), torch.from_numpy(y), order)):
        for gd, rd in zip(got, ref):
            assert set(gd) == set(rd) == {(n, m) for n in range(order + 1) for m in range(n + 1)}
            for key in rd:
                g = gd[key].numpy() if torch.is_tensor(gd[key]) else np.asarray(gd[key])
                np.testing.assert_allclose(g, np.asarray(rd[key]), rtol=1e-12, atol=1e-12,
                                           err_msg=str(key))


def test_zernike_defect_matches_jax(rng):
    """Zernike.offset_at / slopes_at (host) and the trace's lookups of its
    device record, against the JAX package's, as
    tests/test_zernike_defects.py:40-53 holds device against host."""
    jd = jdef.Zernike(jsupp.SupportRound(20), COEFFS)
    td = tdef.Zernike(tsupp.SupportRound(20), COEFFS)
    x = rng.uniform(-10, 10, size=50)
    y = rng.uniform(-10, 10, size=50)
    np.testing.assert_allclose(td.offset_at(x, y), jd.offset_at(x, y), rtol=0, atol=1e-12)
    for g, r in zip(td.slopes_at(x, y), jd.slopes_at(x, y)):
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-12)
    assert td.offset_at(1.5, -2.0) == pytest.approx(jd.offset_at(1.5, -2.0), abs=1e-12)
    assert td.RMS() == pytest.approx(jd.RMS(), rel=1e-12) and td.PV() is None
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    dev = td.device_defect()
    assert isinstance(dev, todef.ZernikeDefect) and dev.radius == pytest.approx(20.0)
    np.testing.assert_allclose(todef.defect_offset(dev, tx, ty).numpy(),
                               np.asarray(jodef.defect_offset(jd.device_defect(), x, y)),
                               rtol=0, atol=1e-12)
    for g, r in zip(todef.defect_slopes(dev, tx, ty), jodef.defect_slopes(jd.device_defect(), x, y)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-12)
    n_t, n_j = td.get_normal(np.array([3.0, -4.0, 0.0])), jd.get_normal(np.array([3.0, -4.0, 0.0]))
    np.testing.assert_allclose(n_t, n_j, rtol=0, atol=1e-12)


def test_fourrier_maps_equal_jax():
    """Fourrier(seed=12345) synthesizes the same height and slope maps as
    the JAX package (the float32 k-grid decides the same band modes), and
    the trace's bilinear lookup of them agrees with JAX's."""
    kw = dict(RMS=1e-1, smallest=0.01, seed=12345)
    jd = jdef.Fourrier(jsupp.SupportRectangle(40, 40), **kw)
    td = tdef.Fourier(tsupp.SupportRectangle(40, 40), **kw)
    for name in ("_height", "_slope_x", "_slope_y"):
        np.testing.assert_allclose(getattr(td, name), getattr(jd, name), rtol=1e-12, atol=0,
                                   err_msg=name)
    assert (td._x0, td._y0, td._dx, td._dy) == pytest.approx((jd._x0, jd._y0, jd._dx, jd._dy), rel=1e-15)
    assert td.RMS() == pytest.approx(jd.RMS(), rel=1e-12) == pytest.approx(1e-1, rel=1e-6)
    assert td.PV() == pytest.approx(jd.PV(), rel=1e-12)
    rng = np.random.default_rng(7)
    x, y = rng.uniform(-25, 25, size=200), rng.uniform(-25, 25, size=200)  # clamped past the edge too
    dev = td.device_defect()
    grid = dev._replace(height=torch.from_numpy(dev.height), slope_x=torch.from_numpy(dev.slope_x),
                        slope_y=torch.from_numpy(dev.slope_y))
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    np.testing.assert_allclose(todef.defect_offset(grid, tx, ty).numpy(),
                               np.asarray(jodef.defect_offset(jd.device_defect(), x, y)), rtol=0, atol=1e-12)
    for g, r in zip(todef.defect_slopes(grid, tx, ty), jodef.defect_slopes(jd.device_defect(), x, y)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-12)
    np.testing.assert_allclose(td.offset_at(x, y), jd.offset_at(x, y), rtol=0, atol=1e-12)


def test_measured_map_matches_jax(rng):
    """MeasuredMap as tests/test_zernike_defects.py:84 checks it (the device
    lookup equals the host map), against the JAX package's."""
    xx, yy = np.meshgrid(np.linspace(0, 1, 32), np.linspace(0, 1, 24), indexing="ij")
    surface_map = 1e-4 * np.sin(2 * np.pi * xx) * np.cos(2 * np.pi * yy)
    jd = jdef.MeasuredMap(jsupp.SupportRectangle(30, 20), surface_map)
    td = tdef.MeasuredMap(tsupp.SupportRectangle(30, 20), surface_map)
    assert td.RMS() == pytest.approx(np.std(surface_map), rel=1e-12)
    x = rng.uniform(-10, 10, size=20)
    y = rng.uniform(-8, 8, size=20)
    dev = td.device_defect()
    grid = dev._replace(height=torch.from_numpy(dev.height), slope_x=torch.from_numpy(dev.slope_x),
                        slope_y=torch.from_numpy(dev.slope_y))
    got = todef.defect_offset(grid, torch.from_numpy(x), torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, td.offset_at(x, y), rtol=0, atol=1e-12)
    np.testing.assert_allclose(got, np.asarray(jodef.defect_offset(jd.device_defect(), x, y)),
                               rtol=0, atol=1e-12)
    for g, r in zip(td.slopes_at(x, y), jd.slopes_at(x, y)):
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-12)


def _deformed(pkg_mirror, pkg_supp, pkg_def, kind):
    """A Zernike-deformed toroid or a Fourrier-deformed parabola."""
    if kind == "zernike":
        R, r = pkg_mirror.ReturnOptimalToroidalRadii(500.0, 80.0)
        base = pkg_mirror.MirrorToroidal(R, r, pkg_supp.SupportRectangle(150, 32))
        defect = pkg_def.Zernike(pkg_supp.SupportRectangle(150, 32), COEFFS)
    else:
        base = pkg_mirror.MirrorParabolic(100, 10, pkg_supp.SupportRectangle(40, 40))
        defect = pkg_def.Fourrier(pkg_supp.SupportRectangle(40, 40), RMS=1e-3, smallest=1.0, seed=5)
    return pkg_mirror.DeformedMirror(base, [defect])


@pytest.mark.parametrize("kind", ["zernike", "fourrier"])
def test_deformed_mirror_host_matches_jax(kind, rng):
    """DeformedMirror's host intersection (the alignment ray of OEPlacement)
    and normal against the JAX package's, ray by ray."""
    jm = _deformed(jmirror, jsupp, jdef, kind)
    tm = _deformed(tmirror, tsupp, tdef, kind)
    assert tm.type == jm.type and isinstance(tm.surface_params(), type(tm.Mirror.surface_params()))
    np.testing.assert_allclose(tm.get_centre(), jm.get_centre(), rtol=0, atol=0)
    centre = jm.get_centre()
    hits = 0
    for _ in range(20):
        p = centre + np.array([0.0, 0.0, 50.0]) + rng.uniform(-5, 5, size=3)
        d = np.array([rng.uniform(-0.05, 0.05), rng.uniform(-0.05, 0.05), -1.0])
        d /= np.linalg.norm(d)
        qj, qt = jm._intersect_host(p, d), tm._intersect_host(p, d)
        assert (qj is None) == (qt is None)
        if qj is not None:
            hits += 1
            np.testing.assert_allclose(qt, qj, rtol=0, atol=1e-9)
            np.testing.assert_allclose(tm.get_normal(qt), jm.get_normal(qj), rtol=0, atol=1e-12)
    assert hits > 10
    assert len(tm.get_grid3D(200)) == len(jm.get_grid3D(200))


def test_deformed_placement_matches_jax(monkeypatch):
    """OEPlacement through a piston-deformed plane mirror (the JAX test of
    tests/test_zernike_defects.py:96): both packages place the same poses,
    and the port's trace (float64, as tests/conftest.py runs JAX) shortens
    the optical path by h / cos(alpha) as the JAX package's does."""
    monkeypatch.setenv("ART_TPU_DTYPE", "float64")
    h0 = 1e-3
    props = {"Divergence": 0, "SourceSize": 20, "Wavelength": 50e-6, "DeltaFT": 1, "NumberRays": 100}
    out = {}
    for name, mm, ms, md, place in (("jax", jmirror, jsupp, jdef, JPlacement),
                                    ("torch", tmirror, tsupp, tdef, TPlacement)):
        support = ms.SupportRectangle(40, 40)
        mirror = mm.MirrorPlane(support)
        deformed = mm.DeformedMirror(mirror, [md.MeasuredMap(support, np.full((16, 16), h0))])
        flat, dchain = place(props, [mirror], [100], [10]), place(props, [deformed], [100], [10])
        out[name] = (flat, dchain)
    for jc, tc in zip(out["jax"], out["torch"]):
        for je, te in zip(jc.optical_elements, tc.optical_elements):
            np.testing.assert_allclose(te.position, je.position, rtol=0, atol=1e-12)
            np.testing.assert_allclose(te.normal, je.normal, rtol=0, atol=1e-12)
    flat, dchain = (c.to("cpu") for c in out["torch"])
    opl_flat = flat.get_output_rays()[-1].opl.double().numpy()
    opl_def = dchain.get_output_rays()[-1].opl.double().numpy()
    np.testing.assert_allclose(opl_flat - opl_def, h0 / np.cos(np.deg2rad(10)), rtol=1e-6)
    jopl = np.asarray(out["jax"][1].get_output_rays()[-1].opl)
    np.testing.assert_allclose(opl_def, jopl, rtol=0, atol=1e-9)


def test_interop_carries_defects():
    """elements_from_numpy carries the JAX records' Zernike coefficients as
    floats and grid maps as tensors, equal to the port's own records."""
    props = {"Divergence": 0, "SourceSize": 20, "Wavelength": 50e-6, "NumberRays": 16}
    for kind in ("zernike", "fourrier"):
        jc = JPlacement(props, [_deformed(jmirror, jsupp, jdef, kind)], [100], [5])
        tc = TPlacement(props, [_deformed(tmirror, tsupp, tdef, kind)], [100], [5]).to("cpu")
        (carried,) = interop.elements_from_numpy(jax.tree.map(np.asarray, jc.device_elements()),
                                                 device="cpu", dtype=torch.float64)
        (own,) = tc.device_elements(torch.float64)
        (cd,), (od,) = carried.defects, own.defects
        assert type(cd) is type(od)
        if kind == "zernike":
            assert cd.coeffs == od.coeffs == COEFFS and cd.radius == pytest.approx(od.radius, rel=1e-15)
        else:
            for f in ("height", "slope_x", "slope_y"):
                assert torch.equal(getattr(cd, f), getattr(od, f)) and getattr(cd, f).dtype == torch.float64
            assert (cd.x0, cd.y0, cd.dx, cd.dy) == pytest.approx((od.x0, od.y0, od.dx, od.dy), rel=1e-15)


def _deformed_flagship(defect_fn, n_rays=2048):
    from attosecondraytracing_tpu_torch.models import masks

    R, r = tmirror.ReturnOptimalToroidalRadii(500.0, 80.0)
    tor = tmirror.MirrorToroidal(R, r, tsupp.SupportRectangle(150, 32))
    deformed = tmirror.DeformedMirror(tor, [defect_fn(tsupp.SupportRectangle(150, 32))])
    mask = masks.Mask(tsupp.SupportRoundHole(20, 7, 0, 0))
    props = {"Divergence": 25e-3, "SourceSize": 0, "Wavelength": 80e-6, "NumberRays": n_rays}
    return TPlacement(props, [mask, deformed, tor], [400, 100, 500], [0, 80, -80], [0, 0, 0])


def test_grid_defect_refused_at_kernel_size(monkeypatch):
    """A chain with a grid defect map takes the plain streamed trace below
    PALLAS_MIN_RAYS and the kernel engines at or above it (their plain
    versions on the CPU), within the kernels' envelopes of the plain trace
    (tests/test_pallas.py:44-51); what the kernels refuse at that size is
    only what exceeds their caps: more than MAX_GRIDS grid maps raise
    NotImplementedError naming the cap, on a CUDA device before anything is
    allocated or uploaded."""
    chain = _deformed_flagship(lambda s: tdef.Fourrier(s, RMS=1e-4, smallest=1.0, seed=3)).to("cpu")
    out = chain.trace_final()
    assert chain.last_trace_engine == "trace" and int(out.alive.sum()) > 500
    monkeypatch.setattr(tchain, "PALLAS_MIN_RAYS", 1024)
    assert chain.fused_eligible()
    fused = chain.trace_final()
    assert chain.last_trace_engine == "torch-source"
    both = fused.alive & out.alive
    assert int(both.sum()) > 500 and int((fused.alive != out.alive).sum()) <= 2
    dp = (fused.p[both] - out.p[both].float()).abs()
    assert float(dp.median()) < 1e-3 and float(dp.max()) < 5e-2
    table = ft.chain_table(None, chain.device_elements(torch.float64))  # the mask is folded
    (grid,) = table.elements[0].defects
    crowded = table._replace(elements=(table.elements[0]._replace(defects=(grid,) * 5),)
                             + table.elements[1:])
    with pytest.raises(NotImplementedError, match="MAX_GRIDS = 4"):
        ft.pack_chain(crowded)
    with pytest.raises(NotImplementedError, match="MAX_GRIDS = 4"):
        ft.streamed_trace(crowded, chain.source_rays, device="cuda")
    assert int(ft.streamed_trace(crowded, chain.source_rays, device="cpu").alive.sum()) > 500


def test_zernike_kernel_caps_refused():
    """The kernels' Zernike tables: orders up to 8 pack, higher orders,
    more than 4 deformed mirrors and one mirror's defects of different
    radii raise NotImplementedError naming the cap; the plain versions take
    them (the CPU trace runs)."""
    chain = _deformed_flagship(lambda s: tdef.Zernike(s, {(8, 4): 1e-5, **COEFFS})).to("cpu")
    spec = chain.source_spec.baked()
    rec = ft.pack_chain(ft.chain_table(spec, chain.device_elements(torch.float64)), False)
    assert rec["n_zernike"] == 1 and rec["ignore_defects"] == 0 and list(rec["zk_of"][:2]) == [0, -1]
    zk = rec["zk"][0]
    assert zk["max_order"] == 8 and zk["inv_r"] == np.float32(1.0 / tsupp_radius())
    for (n, m), c in {(8, 4): 1e-5, **COEFFS}.items():
        assert zk["c"][n * (n + 1) // 2 + m] == np.float32(c)
    assert ft.CHAIN_T.itemsize == 2744

    high = _deformed_flagship(lambda s: tdef.Zernike(s, {(9, 2): 1e-5})).to("cpu")
    table = ft.chain_table(spec, high.device_elements(torch.float64))
    with pytest.raises(NotImplementedError, match="cap of 8"):
        ft.pack_chain(table)
    with pytest.raises(NotImplementedError, match="cap of 8"):
        ft.fused_source_trace(table, spec, 1024, device="cuda")
    assert int(ft.fused_source_trace(table, spec, 1024, device="cpu").alive.sum()) > 100

    table = ft.chain_table(spec, chain.device_elements(torch.float64))
    el = table.elements[0]
    five = table._replace(elements=(el,) * 5, maps=table.maps[:1] * 5, premasks=((),) * 5)
    with pytest.raises(NotImplementedError, match="more than 4"):
        ft.pack_chain(five)
    two_radii = el._replace(defects=(todef.ZernikeDefect({(2, 0): 1e-4}, 10.0),
                                     todef.ZernikeDefect({(2, 0): 1e-4}, 20.0)))
    with pytest.raises(NotImplementedError, match="different radii"):
        ft.pack_chain(table._replace(elements=(two_radii,) + table.elements[1:]))
    summed = el._replace(defects=(todef.ZernikeDefect({(2, 0): 1e-4}, 20.0),
                                  todef.ZernikeDefect({(2, 0): 2e-4, (3, 3): 1e-5}, 20.0)))
    zk = ft.pack_chain(table._replace(elements=(summed,) + table.elements[1:]))["zk"][0]
    assert zk["c"][3] == np.float32(3e-4) and zk["c"][9] == np.float32(1e-5) and zk["max_order"] == 3


def tsupp_radius():
    """Circumscribed radius of the flagship toroid's 150 x 32 mm support."""
    return float(np.hypot(150.0, 32.0) / 2.0)
