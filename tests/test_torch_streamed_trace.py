"""PyTorch port vs the JAX package: the streamed kernels' plain version
(``streamed_trace_ref``, kernels K3 and K4) against the Pallas streamed trace
(``pallas_trace``, ``_kernel`` and ``_kernel_fresh``) run in interpret mode,
on bundles a user built; ``_is_fresh``; the ``trace_final`` engine rule for
such bundles; and ``--rays`` on a CONFIG whose source the user built.

Tolerances: the float32 envelope of tests/test_pallas.py:44-51 (positions
1e-3 mm median and 5e-2 mm max, optical path 0.1 mm, incidence 1e-4 rad on
rays alive in both; at most 2 edge rays may flip alive)."""

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
from attosecondraytracing_tpu.models import chain as jchain  # noqa: E402
from attosecondraytracing_tpu.models import masks as jmask  # noqa: E402
from attosecondraytracing_tpu.models import mirrors as jmirror  # noqa: E402
from attosecondraytracing_tpu.models import sources as jsource  # noqa: E402
from attosecondraytracing_tpu.models import supports as jsupp  # noqa: E402
from attosecondraytracing_tpu.models.placement import OEPlacement as JPlacement  # noqa: E402
from attosecondraytracing_tpu.ops import pallas_trace as jpt  # noqa: E402
from attosecondraytracing_tpu.ops import trace as jtr  # noqa: E402
from attosecondraytracing_tpu_torch import interop  # noqa: E402
from attosecondraytracing_tpu_torch import main as tmain  # noqa: E402
from attosecondraytracing_tpu_torch.models import chain as tchain  # noqa: E402
from attosecondraytracing_tpu_torch.models import sources as tsource  # noqa: E402
from attosecondraytracing_tpu_torch.ops import fused_trace as ft  # noqa: E402

torch.set_num_threads(1)

N = 4096
EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")


def _flagship():
    R, r = jmirror.ReturnOptimalToroidalRadii(500.0, 80.0)
    tor = jmirror.MirrorToroidal(R, r, jsupp.SupportRectangle(150, 32))
    mask = jmask.Mask(jsupp.SupportRoundHole(20, 7, 0, 0))
    props = {"Divergence": 25e-3, "SourceSize": 0, "Wavelength": 80e-6, "DeltaFT": 0.5, "NumberRays": N}
    return JPlacement(props, [mask, tor, tor], [400, 100, 500], [0, 80, -80], [0, 0, 0])


def _parabola():
    par = jmirror.MirrorParabolic(100, 90, jsupp.SupportRoundHole(30, 5, 10, 5))
    props = {"Divergence": 0, "SourceSize": 50, "Wavelength": 800e-6, "DeltaFT": 2.7, "NumberRays": N}
    chain = JPlacement(props, [par], [200], [0.0])
    chain.optical_elements[0].rotate_roll_by(np.rad2deg(50e-6))
    return chain


def _quadrics():
    ell = jmirror.MirrorEllipsoidal(jsupp.SupportRectangle(80, 30), *jmirror.ReturnOptimalEllipsoidalAxes(600, 75))
    sph = jmirror.MirrorSpherical(-2000, jsupp.SupportRound(25))
    cyl = jmirror.MirrorCylindrical(3000, jsupp.SupportRectangleHole(60, 30, 3, 10, 5))
    props = {"Divergence": 30e-3, "SourceSize": 0, "Wavelength": 50e-6, "NumberRays": N}
    return JPlacement(props, [sph, cyl, ell], [300, 200, 300], [5.0, 10.0, 75.0], [0, 90, 0])


def _cast32(b):
    return jax.tree.map(lambda x: np.asarray(x).astype(np.float32)
                        if np.issubdtype(np.asarray(x).dtype, np.floating) else np.asarray(x), b)


def _assert_envelope(out, ref):
    ja, ta = np.asarray(ref.alive), out.alive.numpy()
    assert N // 10 < ja.sum()
    assert (ja != ta).sum() <= 2
    both = ja & ta
    dp = np.abs(out.p.numpy()[both] - np.asarray(ref.p)[both])
    assert np.median(dp) < 1e-3 and dp.max() < 5e-2
    assert np.abs(out.opl.numpy()[both] - np.asarray(ref.opl)[both]).max() < 0.1
    assert np.abs(out.incidence.numpy()[both] - np.asarray(ref.incidence)[both]).max() < 1e-4


@pytest.mark.parametrize("build,split", [(_flagship, 1), (_quadrics, 1), (_parabola, 0)],
                         ids=["flagship", "quadrics", "parabola"])
def test_streamed_plain_matches_pallas(build, split):
    """K4 (a factory-fresh bundle) and K3 (a bundle with dead rays, nonzero
    optical paths and incidences: the output of the chain's first
    ``split`` elements) through the rest of the chain, plain version vs the
    Pallas kernels."""
    chain = build()
    jels = [e.to_device(dtype=jnp.float32) for e in chain.optical_elements]
    tels = interop.elements_from_numpy(jax.tree.map(np.asarray, chain.device_elements()),
                                       device="cpu", dtype=torch.float64)
    src = _cast32(chain.source_rays)
    # K4: the fresh factory bundle through the whole chain
    ref = jpt.pallas_trace(src, jels, fresh=True)
    tsrc = interop.bundle_from_numpy(src, device="cpu", dtype=torch.float32)
    table = ft.chain_table(None, tels)
    assert ft.pack_chain(table)["n_elements"] == len(table.elements)  # the kernel takes it
    out = ft.streamed_trace_ref(table, tsrc, fresh=True, device="cpu")
    _assert_envelope(out, ref)
    # the streamed variant on the same fresh bundle is the same trace
    again = ft.streamed_trace_ref(table, tsrc, fresh=False, device="cpu")
    for x, y in zip(out, again):
        assert torch.equal(x, y)
    if not split:
        # K3's version on the fresh bundle against the streamed Pallas kernel
        _assert_envelope(again, jpt.pallas_trace(src, jels, fresh=False))
        return
    # K3: a traced, non-fresh bundle through the remaining elements
    mid = _cast32(jtr.trace(src, jels[:split], keep_history=False))
    assert not jpt._is_fresh(mid)
    ref = jpt.pallas_trace(mid, jels[split:], fresh=False)
    tmid = interop.bundle_from_numpy(mid, device="cpu", dtype=torch.float32)
    assert not ft._is_fresh(tmid)
    out = ft.streamed_trace_ref(ft.chain_table(None, tels[split:]), tmid, fresh=False, device="cpu")
    _assert_envelope(out, ref)
    assert not out.alive[~tmid.alive].any()  # dead rays stay dead


def test_is_fresh_matches_jax():
    """The fresh predicate on the same arrays in both packages: a factory
    bundle is fresh; one dead ray, or one nonzero opl, opl_c or incidence
    makes it not."""
    base = _cast32(_parabola().source_rays)
    cases = {"factory": {}}
    for field, value in (("alive", False), ("opl", 1.0), ("opl_c", 1e-7), ("incidence", 0.1)):
        arr = np.array(getattr(base, field))
        arr[17] = value
        cases[field] = {field: arr}
    for name, change in cases.items():
        jb = base._replace(**change)
        tb = interop.bundle_from_numpy(jb, device="cpu", dtype=torch.float32)
        assert ft._is_fresh(tb) == jpt._is_fresh(jb) == (name == "factory"), name


def _user_flagship(n_rays):
    """The flagship's optics behind a PointSource the user built (no
    source_spec), in the port."""
    from attosecondraytracing_tpu_torch.models import masks, mirrors, supports
    from attosecondraytracing_tpu_torch.models.placement import OEPlacement

    R, r = mirrors.ReturnOptimalToroidalRadii(500.0, 80.0)
    tor = mirrors.MirrorToroidal(R, r, supports.SupportRectangle(150, 32))
    mask = masks.Mask(supports.SupportRoundHole(20, 7, 0, 0))
    props = {"Divergence": 25e-3, "SourceSize": 0, "Wavelength": 80e-6, "NumberRays": n_rays}
    chain = OEPlacement(props, [mask, tor, tor], [400, 100, 500], [0, 80, -80], [0, 0, 0])
    bundle = tsource.ApplyGaussianIntensityToRayList(
        tsource.PointSource(np.zeros(3), np.array([1.0, 0.0, 0.0]), 25e-3, n_rays, 80e-6), np.exp(-2.0))
    chain.source_rays = bundle
    return chain


def test_trace_final_rule_on_user_bundles(monkeypatch):
    """A user-built bundle of at least PALLAS_MIN_RAYS rays takes the
    streamed kernels (K4 when fresh, K3 otherwise; their plain versions on
    the CPU), with intensity and wavelength passed through; below the
    threshold it takes the plain streamed trace; engine="fused" forces the
    streamed kernels. On a CUDA device a chain the kernels do not take
    raises before anything is allocated."""
    chain = _user_flagship(N).to("cpu")
    assert chain.source_spec is None
    chain.trace_final()
    assert chain.last_trace_engine == "trace"  # below PALLAS_MIN_RAYS
    plain = chain.trace_final(engine="trace")
    seen = []
    real_ref = ft.streamed_trace_ref
    monkeypatch.setattr(ft, "streamed_trace_ref",
                        lambda *a, fresh, **k: seen.append(fresh) or real_ref(*a, fresh=fresh, **k))
    out = chain.trace_final(engine="fused")
    assert chain.last_trace_engine == "torch-streamed" and seen == [True]
    monkeypatch.setattr(tchain, "PALLAS_MIN_RAYS", 1024)
    ft.streamed_trace.launches = ft.streamed_trace.fresh_launches = 0
    again = chain.trace_final()
    assert chain.last_trace_engine == "torch-streamed" and seen == [True, True]
    assert ft.streamed_trace.launches == 0 and ft.streamed_trace.fresh_launches == 0
    assert torch.equal(out.p, again.p) and out.p.dtype == torch.float32
    assert torch.equal(out.intensity, chain.source_rays.intensity.float())
    assert float(out.wavelength) == pytest.approx(80e-6)
    both = out.alive & plain.alive
    assert int(both.sum()) > N // 10 and int((out.alive != plain.alive).sum()) <= 2
    assert float((out.p[both] - plain.p[both]).abs().max()) < 5e-2
    # a bundle that went through part of a chain is not fresh: K3's version
    chain.source_rays = chain.source_rays._replace(opl=chain.source_rays.opl + 1.0)
    shifted = chain.trace_final()
    assert seen[-1] is False
    assert torch.allclose(shifted.opl[shifted.alive], out.opl[shifted.alive] + 1.0, atol=1e-3)
    # what the kernels lack raises on CUDA before any allocation
    from attosecondraytracing_tpu_torch.models import masks, supports
    from attosecondraytracing_tpu_torch.models.placement import OEPlacement

    hole = supports.SupportRoundHole(Radius=30, RadiusHole=1, CenterHoleX=0, CenterHoleY=0)
    props = {"Divergence": 5e-3, "SourceSize": 0, "Wavelength": 80e-6, "NumberRays": 2048}
    long_chain = OEPlacement(props, [masks.Mask(hole) for _ in range(10)], [10.0] * 10, [0.0] * 10)
    long_chain.source_rays = long_chain.source_rays
    long_chain.device = torch.device("cuda")  # a CUDA device, without touching a card
    with pytest.raises(NotImplementedError):
        long_chain.trace_final()
    assert long_chain.last_trace_engine is None


def test_user_bundle_engine_matches_jax_pallas(monkeypatch):
    """trace_final on the same user-built flagship bundle in both packages:
    the port's streamed kernel engine (plain version) against the JAX
    package's "pallas" engine (the Pallas streamed kernel in interpret
    mode), within the envelope."""
    monkeypatch.setattr(tchain, "PALLAS_MIN_RAYS", 1024)
    jc = _flagship()
    jc.source_rays = jsource.ApplyGaussianIntensityToRayList(
        jsource.PointSource(np.zeros(3), np.array([1.0, 0.0, 0.0]), 25e-3, N, 80e-6), np.exp(-2.0))
    ref = jc.trace_final(engine="pallas")
    assert jc.last_trace_engine == "pallas"
    tc = _user_flagship(N).to("cpu")
    out = tc.trace_final()
    assert tc.last_trace_engine == "torch-streamed"
    _assert_envelope(out, ref)
    np.testing.assert_allclose(out.intensity.numpy(), np.asarray(ref.intensity), rtol=1e-6)


def test_rays_option_on_user_bundle_config(monkeypatch, capsys):
    """--rays on a CONFIG whose source the user built: both CLIs print that
    it is ignored for that chain and run the CONFIG at its own ray count,
    with the same transmission, spot SD and duration SD."""
    monkeypatch.setenv("ART_TPU_DTYPE", "float64")
    path = os.path.join(EXAMPLES, "CONFIG_toroidal2f-2f_byhand.py")
    jk = jmain.run_config_file(path, n_rays=1_000_000)
    tk = tmain.run_config_file(path, n_rays=1_000_000, device="cpu")
    out = capsys.readouterr().out
    assert "[attosecondraytracing_tpu] --rays ignored" in out
    assert "[attosecondraytracing_tpu_torch] --rays ignored" in out
    chain = tk["OpticalChain"][0]
    assert chain.source_rays.n_rays == 1000 and chain.last_trace_engine == "trace"
    for key in ("ETransmission", "SpotSizeSD", "DurationSD"):
        assert float(tk[key][0]) == pytest.approx(float(jk[key][0]), rel=1e-6), key
    assert jchain.PALLAS_MIN_RAYS == tchain.PALLAS_MIN_RAYS


def test_streamed_wrapper_on_cpu_takes_the_plain_version():
    """On the CPU the wrapper runs the plain version (identical outputs) and
    counts no launch; it decides freshness by _is_fresh."""
    chain = _user_flagship(N)
    table = ft.chain_table(None, [e.to_device("cpu", torch.float64) for e in chain.optical_elements])
    ft.streamed_trace.launches = ft.streamed_trace.fresh_launches = 0
    a = ft.streamed_trace(table, chain.source_rays, device="cpu")
    b = ft.streamed_trace_ref(table, chain.source_rays, fresh=True, device="cpu")
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert ft.streamed_trace.launches == 0 and ft.streamed_trace.fresh_launches == 0
    with pytest.raises(ValueError):
        ft.streamed_trace(table, chain.source_rays, device="meta")
