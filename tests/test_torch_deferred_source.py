"""The port's deferred factory source: ``OEPlacement`` and the chain's source
methods carry a factory source as its description and build its bundle on
the first read of ``OpticalChain.source_rays``; a fused design serves the
source intensity and the transmission's denominator from the device
without building the bundle. Held against the JAX package's eager sources
in float64."""

import sys

# tests/reference_shims.py leaves stand-in modules in sys.modules whose
# every attribute is a stub object; they are set aside while torch imports
# (as in tests/test_torch_models.py).
_stubs = {name: mod for name, mod in list(sys.modules.items())
          if not isinstance(getattr(mod, "__file__", None), (str, type(None)))}
for _name in _stubs:
    del sys.modules[_name]
import torch  # noqa: E402

sys.modules.update(_stubs)

import numpy as np
import pytest

from attosecondraytracing_tpu.models import masks as jmask
from attosecondraytracing_tpu.models import mirrors as jmirror
from attosecondraytracing_tpu.models import sources as jsource
from attosecondraytracing_tpu.models import supports as jsupp
from attosecondraytracing_tpu.models.placement import OEPlacement as JPlacement
from attosecondraytracing_tpu_torch import interop
from attosecondraytracing_tpu_torch import main as tmain
from attosecondraytracing_tpu_torch.models import chain as tchain
from attosecondraytracing_tpu_torch.models import masks as tmask
from attosecondraytracing_tpu_torch.models import mirrors as tmirror
from attosecondraytracing_tpu_torch.models import sources as tsource
from attosecondraytracing_tpu_torch.models import supports as tsupp
from attosecondraytracing_tpu_torch.models.placement import OEPlacement as TPlacement

torch.set_num_threads(1)

JAX_MODELS = (jmirror, jmask, jsupp, JPlacement)
TORCH_MODELS = (tmirror, tmask, tsupp, TPlacement)

#: source properties of the placed kinds (OEPlacement's rules pick the kind)
PROPS = {
    "cone": {"Divergence": 25e-3, "SourceSize": 0, "Wavelength": 80e-6, "DeltaFT": 0.5},
    "disk": {"Divergence": 0, "SourceSize": 40, "Wavelength": 800e-6, "DeltaFT": 2.7},
    "extended": {"Divergence": 2e-3, "SourceSize": 0.1, "Wavelength": 50e-6, "DeltaFT": 0.5},
}
JAX_FACTORY = {"cone": "PointSource", "disk": "PlaneWaveDisk", "extended": "ExtendedSource",
               "square": "PlaneWaveSquare"}


def _flagship(mirror, mask, supp, place, props, n):
    """Round-hole mask + two toroids at 80 deg in f-d-f."""
    R, r = mirror.ReturnOptimalToroidalRadii(500.0, 80.0)
    tor = mirror.MirrorToroidal(R, r, supp.SupportRectangle(150, 32))
    msk = mask.Mask(supp.SupportRoundHole(20, 7, 0, 0))
    return place(dict(props), [msk, tor, tor], [400.0, 100.0, 500.0], [0.0, 80.0, -80.0],
                 [0.0, 0.0, 0.0], "flagship")


def _pair(kind, n=3000):
    """(JAX chain, port chain) placed from one set of source properties."""
    props = dict(PROPS[kind], NumberRays=n)
    return (_flagship(*JAX_MODELS, props, n), _flagship(*TORCH_MODELS, props, n))


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _assert_bundle(t, j, tol=1e-14):
    """Leaf by leaf to ``tol``, relative to each leaf's scale."""
    for leaf in ("p", "d", "opl", "opl_c", "alive", "intensity", "incidence", "wavelength"):
        a, b = _np(getattr(t, leaf)), np.asarray(getattr(j, leaf))
        assert a.shape == b.shape and a.dtype == b.dtype, leaf
        scale = max(float(np.abs(b).max()), 1.0) if b.size and b.dtype != bool else 1.0
        np.testing.assert_allclose(a, b, rtol=0, atol=tol * scale, err_msg=leaf)


def _assert_spec(t, j):
    """The port's description against the JAX package's: its vectors and
    edge, read off the two packages' bundles, to a rounding unit."""
    assert (t is None) == (j is None)
    if j is None:
        return
    spec = interop.source_spec_from_numpy(j)
    for field in ("origin", "axis", "gaussian_edge"):
        np.testing.assert_allclose(np.asarray(getattr(t, field), float),
                                   np.asarray(getattr(spec, field), float),
                                   rtol=1e-15, atol=1e-15, err_msg=field)
    same = dict(origin=spec.origin, axis=spec.axis, gaussian_edge=spec.gaussian_edge)
    assert t._replace(**same) == spec


def _jax_source(kind, spec, edge):
    """The JAX package's eager bundle of the described source."""
    args = {"cone": (spec.param,), "disk": (spec.param,), "square": (spec.param,),
            "extended": (spec.diameter, spec.param)}[kind]
    bundle = getattr(jsource, JAX_FACTORY[kind])(np.asarray(spec.origin), np.asarray(spec.axis),
                                                 *args, spec.n_rays, spec.wavelength)
    return bundle if edge is None else jsource.ApplyGaussianIntensityToRayList(bundle, edge)


@pytest.fixture
def counts():
    """Host bundles built and device intensities synthesized since the
    test started: a callable returning (builds, syntheses)."""
    b0, s0 = tsource.factory_bundle.builds, tsource.factory_intensity.syntheses
    return lambda: (tsource.factory_bundle.builds - b0, tsource.factory_intensity.syntheses - s0)


@pytest.mark.parametrize("edge", [True, False], ids=["gaussian", "flat"])
@pytest.mark.parametrize("kind", ["cone", "disk", "extended", "square"])
def test_late_read_matches_jax_source(kind, edge, counts):
    """A placed chain (for 'square', a chain of PlaneWaveSquareFused's
    description) builds no bundle until ``source_rays`` is read, after a
    fused trace; the bundle then matches the JAX package's eager source in
    float64, with and without the Gaussian edge."""
    gauss = 1 / np.e**2
    if kind == "square":
        jc, tc = _pair("cone")
        jb, jspec = jsource.PlaneWaveSquareFused(np.zeros(3), np.array([1.0, 0.0, 0.0]), 40.0,
                                                 3000, 80e-6, gaussian_edge=gauss)
        tc = tchain.OpticalChain(None, tc.optical_elements,
                                 source_spec=interop.source_spec_from_numpy(jspec))
    else:
        jc, tc = _pair(kind)
        jspec = jc.source_spec
        assert tc.source_spec == interop.source_spec_from_numpy(jspec)
    if not edge:
        tc = tchain.OpticalChain(None, tc.optical_elements,
                                 source_spec=tc.source_spec._replace(gaussian_edge=None))
    assert counts() == (0, 0)
    out = tc.to("cpu").trace_final(engine="fused")
    assert tc.last_trace_engine == "torch-source" and counts() == (0, 1)
    ref = _jax_source(kind, jspec, gauss if edge else None)
    if kind != "square" and edge:
        _assert_bundle(jc.source_rays, ref, tol=0)  # the JAX chain's own source
    _assert_bundle(tc.source_rays, ref)
    assert counts() == (1, 1)
    tc.source_rays  # kept: read again, built once
    assert counts() == (1, 1)
    # the trace carried the synthesized intensity, the bundle's to float32
    assert torch.equal(out.intensity, tc.source_rays.intensity.float())


def test_fused_design_builds_no_host_bundle(monkeypatch, counts):
    """A fused design through ``main.main`` on the CPU builds no host
    bundle; its results match a chain whose bundle was read first."""
    monkeypatch.setenv("ART_TPU_ENGINE", "fused")
    monkeypatch.setattr(tchain, "PALLAS_MIN_RAYS", 1000)
    det = {"ReflectionNumber": -1, "ManualDetector": False, "DistanceDetector": 500.0,
           "AutoDetectorDistance": True, "OptFor": "intensity"}
    ana = {"verbose": False, "save_results": False}
    props = dict(PROPS["cone"], NumberRays=20000)
    results = []
    for read_first in (False, True):
        chain = _flagship(*TORCH_MODELS, props, 20000)
        if read_first:
            chain.source_rays
        before = counts()
        kept = tmain.main(chain, props, det, ana, device="cpu")
        assert chain.last_trace_engine == "torch-source"
        # one synthesis feeds the trace and the transmission's denominator
        assert counts()[0] == before[0] and counts()[1] == before[1] + (not read_first)
        results.append([kept["ETransmission"][0], kept["Detector"][0].get_distance(),
                        kept["SpotSizeSD"][0], kept["DurationSD"][0]])
    assert counts() == (1, 1)
    np.testing.assert_allclose(results[0], results[1], rtol=1e-12)
    assert 0 < results[0][0] < 100


@pytest.mark.parametrize("op", ["shift_vert", "shift_vector", "tilt_in_plane", "tilt_vector",
                                "resize", "copy", "oe_loop", "setter"])
def test_source_methods_match_jax(op, counts):
    """The chain's source methods give the JAX package's bundles and
    descriptions: a shift or tilt reads the bundle first, a resize, a copy
    and an element loop list stay unread until their bundle is read, the
    setter clears the description."""
    jc, tc = _pair("cone")
    if op == "shift_vert":
        jc.shift_source("vert", 0.3), tc.shift_source("vert", 0.3)
    elif op == "shift_vector":
        jc.shift_source(np.array([0.1, 0.2, 0.3]), 0.5)
        tc.shift_source(np.array([0.1, 0.2, 0.3]), 0.5)
    elif op == "tilt_in_plane":
        jc.tilt_source("in_plane", 0.01), tc.tilt_source("in_plane", 0.01)
    elif op == "tilt_vector":
        jc.tilt_source(np.array([0.0, 1.0, 0.2]), 0.02)
        tc.tilt_source(np.array([0.0, 1.0, 0.2]), 0.02)
    elif op == "resize":
        jc.resize_source(2500), tc.resize_source(2500)
        assert counts() == (0, 0)
    elif op == "copy":
        jc, tc = jc.copy_chain(), tc.copy_chain()
        assert counts() == (0, 0)
    elif op == "oe_loop":
        jc = jc.get_OE_loop_list(1, "roll", [0.1, 0.2])[1]
        tc = tc.get_OE_loop_list(1, "roll", [0.1, 0.2])[1]
        assert counts() == (0, 0)
    else:
        bundle = tsource.PointSource(np.zeros(3), np.array([1.0, 0.0, 0.0]), 0.01, 700)
        tc.source_rays = bundle
        jc.source_rays = jsource.PointSource(np.zeros(3), np.array([1.0, 0.0, 0.0]), 0.01, 700)
        assert tc.source_rays is bundle and tc.source_spec is None and counts() == (0, 0)
        assert not tc.fused_eligible() and tc.takes_plain_trace("auto")
    _assert_spec(tc.source_spec, jc.source_spec)
    _assert_bundle(tc.source_rays, jc.source_rays)
    assert counts()[0] == (0 if op == "setter" else 1)


@pytest.mark.parametrize("axis,values", [("tilt_out_plane", [0.0, 0.01]),
                                         ("shift_horiz", [-0.2, 0.2]),
                                         ("divergence", [0.01, 0.02])])
def test_source_loop_list_matches_jax(axis, values, counts):
    """``get_source_loop_list`` builds the chain's bundle once; a tilt or
    shift shares it, a divergence scan's cones stay unread; every chain's
    bundle and description match the JAX package's."""
    jc, tc = _pair("cone", n=2000)
    jchains = jc.get_source_loop_list(axis, values)
    tchains = tc.get_source_loop_list(axis, values)
    assert counts()[0] == 1
    for j, t in zip(jchains, tchains):
        assert (t.loop_variable_name, t.loop_variable_value) == (j.loop_variable_name,
                                                                 j.loop_variable_value)
        _assert_spec(t.source_spec, j.source_spec)
        _assert_bundle(t.source_rays, j.source_rays)
    assert counts()[0] == (1 + len(values) if axis == "divergence" else 1)


@pytest.mark.parametrize("kind", ["cone", "disk", "extended"])
def test_engine_choice_builds_nothing(kind, counts):
    """``fused_eligible`` and ``takes_plain_trace`` read the description's
    ray count and build nothing; an extended source reports the count it
    emits, ``n_sources * n_each``."""
    jc, tc = _pair(kind, n=250_000)
    assert tc.fused_eligible() and not tc.takes_plain_trace("auto")
    assert tc.takes_plain_trace("trace") and not tc.takes_plain_trace("fused")
    assert counts() == (0, 0)
    n_sources, n_each = tsource.extended_source_counts(0.1, 250_000)
    emitted = n_sources * n_each if kind == "extended" else 250_000
    assert tc.source_spec.n_rays == jc.source_spec.n_rays == emitted
    assert (emitted != 250_000) == (kind == "extended")
    tc.resize_source(5000)
    assert not tc.fused_eligible() and tc.takes_plain_trace("auto") and counts() == (0, 0)
    assert tc.source_rays.n_rays == tc.source_spec.n_rays == tsource.emitted_rays(kind, 5000, 0.1)


def test_read_builds_on_the_chains_card(monkeypatch):
    """A chain with a CUDA device builds its bundle there and holds it as
    CPU tensors; a chain without one builds on the CPU."""
    seen = []
    build = tsource.factory_bundle

    def spy(spec, *, device="cpu"):
        seen.append(torch.device(device))
        return build(spec, device="cpu")

    spy.builds = 0  # the counter the build bumps under its module name
    monkeypatch.setattr(tsource, "factory_bundle", spy)
    _, tc = _pair("cone", n=500)
    copy = tc.copy_chain()
    tc.device = torch.device("cuda", 0)  # set directly: no card here
    assert tc.source_rays.p.device.type == "cpu"
    copy.source_rays
    assert seen == [torch.device("cuda", 0), torch.device("cpu")]
