"""Giga-ray images of the port (``analysis/gigascan.py``) against the JAX
package's ``fused_source_images`` and against themselves.

The chain is tests/test_gigascan.py's (two toroids at 80 deg, float32
elements, the detector 5 mm before the focus), carried across with
``interop``; the JAX side runs ``engine="xla-source"`` (no interpret-mode
Pallas; that engine agrees with "pallas" per
test_xla_source_engine_matches_pallas_engine), the port runs on the CPU
(K1's plain version), 8192 rays into 64 x 64 pixels.

Envelopes: on the same traced rays (the JAX engine's chunks fed to the
port's loop) the two packages' images agree to float32 summation and the
mean delays within 1e-3 fs. End to end, each package traces in float32 with
its own arithmetic: per ray the impact points differ by up to 2.2e-3 mm
(median 3.5e-4 mm, a tenth of a pixel) and the delays by 0.76 fs (standard
deviation; one float32 ulp of the 1.6 m path is 0.41 fs); against a float64
trace of its own source rays JAX's engine errs 0.445 fs and the port's plain
K1 0.486 fs (test_float32_delay_noise_against_float64). So the end-to-end
images are held as tests/test_gigascan.py:132-185 holds two engines
(3x3-blurred L1, centroids, variances), the fitted extents within 3e-3 of
the width (the extreme rays' noise: 1.1e-3 measured), and the mean delays of
pixels holding more than 2.5 weight (the JAX tests' 5 per 16384 rays) within
a median of 0.2 fs and a maximum of 1.2 fs (read: 0.141 and 0.952; a pixel
mean over >= 3 rays keeps ~0.3 fs of that noise). Within the port the chunked and single-pass images are held to
the JAX package's own envelopes (tests/test_gigascan.py:30-53, :187-209).
"""

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
import numpy as np  # noqa: E402
import pytest  # noqa: E402
from numpy.lib.stride_tricks import sliding_window_view  # noqa: E402

from attosecondraytracing_tpu.analysis import gigascan as jgs  # noqa: E402
from attosecondraytracing_tpu.models import chain as jchain  # noqa: E402
from attosecondraytracing_tpu.models import masks as jmask  # noqa: E402
from attosecondraytracing_tpu.models import mirrors as jmirror  # noqa: E402
from attosecondraytracing_tpu.models import sources as jsource  # noqa: E402
from attosecondraytracing_tpu.models import supports as jsupp  # noqa: E402
from attosecondraytracing_tpu.models.detector import Detector as JDetector  # noqa: E402
from attosecondraytracing_tpu.models.placement import OEPlacement  # noqa: E402
from attosecondraytracing_tpu.ops import pallas_trace as jpt  # noqa: E402
from attosecondraytracing_tpu.ops import xla_source as jxs  # noqa: E402
from attosecondraytracing_tpu.ops.trace import trace as jtrace  # noqa: E402
from attosecondraytracing_tpu_torch import interop  # noqa: E402
from attosecondraytracing_tpu_torch.analysis import gigascan as gs  # noqa: E402
from attosecondraytracing_tpu_torch.models.detector import Detector  # noqa: E402
from attosecondraytracing_tpu_torch.ops import fused_trace as ft  # noqa: E402
from attosecondraytracing_tpu_torch.ops import surfaces as srf  # noqa: E402
from attosecondraytracing_tpu_torch.ops import trace as tt  # noqa: E402
from attosecondraytracing_tpu_torch.ops.precision import rsqrt  # noqa: E402
from attosecondraytracing_tpu_torch.ops.bundle import RayBundle  # noqa: E402

torch.set_num_threads(1)

N = 8192
BINS = (64, 64)
#: pixels whose mean delays are compared: the JAX tests' weight 5 per 16384 rays
MIN_WEIGHT = 5.0 * N / 16384


def _blur3(a):
    return sliding_window_view(np.pad(a, 1), (3, 3)).sum(axis=(2, 3))


def _moments(img):
    gx, gy = np.meshgrid(np.arange(img.shape[0]), np.arange(img.shape[1]), indexing="ij")
    w = img.sum()
    mx, my = (img * gx).sum() / w, (img * gy).sum() / w
    return np.array([mx, my]), np.array([(img * (gx - mx) ** 2).sum() / w,
                                         (img * (gy - my) ** 2).sum() / w])


def _delay_diffs(a, b, min_weight=MIN_WEIGHT):
    both = np.isfinite(a["mean_delay"]) & np.isfinite(b["mean_delay"]) & (a["weight_image"] > min_weight)
    return np.abs(a["mean_delay"] - b["mean_delay"])[both]


def _carry(chain, elements, det):
    """The port's (source spec, float32 elements, detector) of a JAX chain."""
    tels = interop.elements_from_numpy(jax.tree.map(np.asarray, elements), device="cpu",
                                       dtype=torch.float32)
    return (interop.source_spec_from_numpy(chain.source_spec), tels,
            Detector(det.refpoint, det.centre, det.normal))


@pytest.fixture(scope="module")
def setup():
    focal, inc = 500.0, 80.0
    R, r = jmirror.ReturnOptimalToroidalRadii(focal, inc)
    tor = jmirror.MirrorToroidal(R, r, jsupp.SupportRectangle(150, 32))
    props = {"Divergence": 25e-3, "SourceSize": 0, "Wavelength": 80e-6, "DeltaFT": 0.5,
             "NumberRays": N}
    chain = OEPlacement(props, [tor, tor], [500, 600], [inc, -inc], [0, 0])
    elements = [e.to_device(dtype=jnp.float32) for e in chain.optical_elements]
    det = JDetector(chain.optical_elements[-1].position)
    det.autoplace(chain.trace_final(engine="xla"), focal - 5.0)
    return chain, elements, det, _carry(chain, elements, det)


@pytest.fixture(scope="module")
def jax_images(setup):
    chain, elements, det, _ = setup
    return jgs.fused_source_images(chain.source_spec, elements, det, n_total=N, bins=BINS,
                                   engine="xla-source")


@pytest.fixture(scope="module")
def port_images(setup):
    spec, tels, det = setup[3]
    return gs.fused_source_images(spec, tels, det, n_total=N, bins=BINS)


def test_images_match_jax_on_the_same_rays(setup, jax_images):
    """The port's image loop fed the JAX engine's traced chunks (the chunk
    tracer argument) on the JAX extent: the binning, the weights, the
    delays against the chief ray and the re-centring agree with the JAX
    package's to float32 summation."""
    chain, elements, det, (spec, tels, tdet) = setup
    jspec = chain.source_spec.baked()

    def jax_tracer(table, bspec, chunk, n_total, *, device, ignore_defects):
        def trace_chunk(n_local, phase, k_frac):
            b = jxs.xla_trace_source(jspec, elements, n_local, phase=phase, k_frac=k_frac,
                                     n_total=n_total, ignore_defects=ignore_defects)
            return ft.TraceOutputs(*(torch.from_numpy(np.array(getattr(b, f)))
                                     for f in ft.TraceOutputs._fields))

        return trace_chunk

    res = gs._images(spec, tels, tdet, N, BINS, jax_images["extent"], 1 << 23, True,
                     torch.device("cpu"), jax_tracer)
    assert res["n_total"] == N and res["image"].shape == BINS
    assert res["sum_w"] == pytest.approx(jax_images["sum_w"], rel=1e-6)
    np.testing.assert_allclose(res["image"], jax_images["image"], rtol=0, atol=1e-4)
    assert np.array_equal(np.isfinite(res["mean_delay"]), np.isfinite(jax_images["mean_delay"]))
    diffs = _delay_diffs(res, jax_images, 0.0)
    assert diffs.size > 500 and diffs.max() < 1e-3  # fs


def test_images_match_jax(setup, jax_images, port_images):
    """End to end (the port's probe, chief ray and K1 plain version): the
    fitted extent, the sum of weights, and on the JAX extent the image's
    3x3-blurred L1, centroids and variances and the mean delays (module
    docstring: the float32 envelope of two packages' traces)."""
    spec, tels, det = setup[3]
    jlo, jhi = (np.asarray(v, np.float64) for v in jax_images["extent"])
    lo, hi = port_images["extent"]
    np.testing.assert_allclose(lo, jlo, rtol=0, atol=3e-3 * (jhi - jlo).max())
    np.testing.assert_allclose(hi, jhi, rtol=0, atol=3e-3 * (jhi - jlo).max())
    assert port_images["sum_w"] == pytest.approx(jax_images["sum_w"], rel=1e-4)
    res = gs.fused_source_images(spec, tels, det, n_total=N, bins=BINS,
                                 extent=jax_images["extent"])
    img, ref = res["image"], jax_images["image"]
    assert np.abs(_blur3(img) - _blur3(ref)).sum() < 0.05 * 9 * jax_images["sum_w"]
    (c, v), (cr, vr) = _moments(img), _moments(ref)
    np.testing.assert_allclose(c, cr, rtol=0, atol=0.05)  # 5 % of a pixel
    np.testing.assert_allclose(v, vr, rtol=0.01)
    diffs = _delay_diffs(res, jax_images)
    assert diffs.size > 50 and np.median(diffs) < 0.2 and diffs.max() < 1.2, (
        np.median(diffs), diffs.max())  # fs; reads 0.141, 0.952


def _plane_delays(p, d, opl, opl_c, det):
    """Float64 delays [fs] of traced rays extended to the detector plane."""
    p, d = np.asarray(p, np.float64), np.asarray(d, np.float64)
    t = ((np.asarray(det.centre) - p) @ np.asarray(det.normal)) / (d @ np.asarray(det.normal))
    return (np.asarray(opl, np.float64) - np.asarray(opl_c, np.float64) + t) * (1e15 / 299792458000.0)


def _ulp_errors(fn, x):
    """(mean, max) error in ulps of a float32 reciprocal square root."""
    exact = 1.0 / np.sqrt(x.astype(np.float64))
    e = np.abs(np.asarray(fn(x), np.float64) - exact) / np.spacing(exact.astype(np.float32))
    return e.mean(), e.max()


def _float64_delays(src, chain, det):
    """Float64 plane delays and alive mask of a float32 source bundle
    (either package's; its p and d read as numpy) traced in float64 by the
    JAX package."""
    jsrc = jpt.source_bundle(chain.source_spec.baked(), N)
    src64 = jsrc._replace(**{f: jnp.asarray(np.asarray(getattr(src, f)), jnp.float64)
                             for f in ("p", "d")})
    src64 = jax.tree.map(lambda a: a.astype(jnp.float64) if a.dtype == jnp.float32 else a, src64)
    o64 = jtrace(src64, [e.to_device(dtype=jnp.float64) for e in chain.optical_elements],
                 keep_history=False)
    return _plane_delays(o64.p, o64.d, o64.opl, o64.opl_c, det), np.asarray(o64.alive)


def test_float32_delay_noise_against_float64(setup, monkeypatch):
    """Each package's float32 trace of N source rays against a float64 trace
    of the same rays (printed with ``pytest -s``). A ray is the float32
    source ray that package synthesized: a direction rounded to another
    float32 is another ray, and its norm error (a few 1e-8) rides the 1.6 m
    path as about 0.15 fs, so each trace is held against the float64 trace
    of its own source. The port's plain K1 errs within 1.12 times JAX's
    engine. It did not before the port's CPU plain path took correctly
    rounded square roots (``ops/precision.rsqrt`` / ``sqrt``): torch.rsqrt
    on the CPU is 1/sqrt (two roundings), and its vectorized float32 sqrt
    put 37 of the 8192 source radii off by an ulp, while the toroid
    residual's rho - R cancels at R = 5.6 m, so an ulp of rsqrt moves the
    root. With torch's own rsqrt the port's trace errs more (the witness
    below). Against JAX's source the port's error stays within 1.5 times
    JAX's: its correctly rounded source directions differ from XLA's
    rsqrt. The port's chained trace run in float64 on the JAX package's
    source meets the float64 trace up to a constant (one algorithm, one
    order of operations)."""
    chain, elements, det, (spec, tels, _tdet) = setup
    baked = chain.source_spec.baked()
    truth, alive = _float64_delays(jpt.source_bundle(baked, N), chain, det)
    own_truth, own_alive = _float64_delays(ft.source_bundle(spec.baked(), N, device="cpu"),
                                           chain, det)
    assert np.array_equal(own_alive, alive)

    def error_std(p, d, opl, opl_c, ok, ref=truth):
        assert np.array_equal(np.asarray(ok), alive)
        return float(np.std((_plane_delays(p, d, opl, opl_c, det) - ref)[alive]))

    jb = jxs.xla_trace_source(baked, elements, N, n_total=N)
    pb = ft.fused_source_trace_ref(ft.chain_table(spec.baked(), tels), spec.baked(), N, device="cpu")
    pb = (pb.p.numpy(), pb.d.numpy(), pb.opl.numpy(), pb.opl_c.numpy(), pb.alive.numpy())
    table = ft.chain_table(spec.baked(), tels)
    (px, py, pz), (dx, dy, dz), _rr = jpt.synth_source_c(
        baked.kind, jnp.arange(N, dtype=jnp.float32), N, baked.radius, 0.0, 0.0,
        pos_radius=baked.pos_radius, n_each=baked.n_each, n_sources=baked.n_sources)

    def port_chain(dtype):
        c = [torch.from_numpy(np.asarray(v) + np.zeros(N, np.float32)).to(dtype)
             for v in (px, py, pz, dx, dy, dz)]
        z = torch.zeros_like(c[0])
        s = tt.TraceState(*c, z, z, torch.ones_like(z, dtype=torch.bool), z)
        for el, (M, b), pre in zip(table.elements, table.maps, table.premasks):
            s = tt.chained_step(el, M, b, s, want_incidence=False, premasks=pre, freeze_dead=False)
        s = tt.to_lab_c(table.final, s)
        return (torch.stack([s.px, s.py, s.pz], -1).numpy(), torch.stack([s.dx, s.dy, s.dz], -1).numpy(),
                s.opl.numpy(), s.opl_c.numpy(), s.alive.numpy())

    jax32 = error_std(jb.p, jb.d, jb.opl, jb.opl_c, jb.alive)
    port32 = error_std(*pb, ref=own_truth)
    port32_jax_truth = error_std(*pb)
    port32_jsrc = error_std(*port_chain(torch.float32))
    port64 = error_std(*port_chain(torch.float64))
    monkeypatch.setattr(srf, "rsqrt", torch.rsqrt)
    port32_torch_rsqrt = error_std(*port_chain(torch.float32))
    monkeypatch.undo()
    R = float(tels[0].surface.major_radius)
    x = np.random.default_rng(0).uniform((R - 50.0) ** 2, (R + 50.0) ** 2, 1 << 16).astype(np.float32)
    torch_ulps = _ulp_errors(lambda v: torch.rsqrt(torch.from_numpy(v)).numpy(), x)
    port_ulps = _ulp_errors(lambda v: rsqrt(torch.from_numpy(v)).numpy(), x)
    xla_ulps = _ulp_errors(lambda v: np.asarray(jax.jit(jax.lax.rsqrt)(jnp.asarray(v))), x)
    print(f"delay error std against float64 [fs]: JAX xla-source {jax32:.3f}, port plain K1 "
          f"{port32:.3f} (against JAX's source {port32_jax_truth:.3f}), port chained trace on "
          f"JAX's source {port32_jsrc:.3f} (with torch.rsqrt {port32_torch_rsqrt:.3f}; float64: "
          f"{port64:.2e}); rsqrt on the toroid's rho^2, ulps mean/max: torch "
          f"{torch_ulps[0]:.3f}/{torch_ulps[1]:.3f}, port {port_ulps[0]:.3f}/{port_ulps[1]:.3f}, "
          f"XLA {xla_ulps[0]:.3f}/{xla_ulps[1]:.3f}")
    assert port64 < 1e-3
    assert port_ulps[1] <= 0.5 + 1e-6
    assert port32_torch_rsqrt > port32_jsrc
    assert port32 <= 1.12 * jax32
    assert port32_jax_truth <= 1.5 * jax32


@pytest.mark.parametrize("chunk", [4096, 1024])
def test_chunked_images_match_single_pass(setup, port_images, chunk):
    """Chunks of 4096 and 1024 rays against one pass (chunk 2^23): the same
    global spiral through the (phase, k_frac) law, held to the JAX
    package's envelopes for the same comparison."""
    spec, tels, det = setup[3]
    res = gs.fused_source_images(spec, tels, det, n_total=N, bins=BINS, chunk=chunk,
                                 extent=port_images["extent"])
    ref = port_images
    assert res["sum_w"] == pytest.approx(ref["sum_w"], rel=1e-5)
    l1 = np.abs(res["image"] - ref["image"]).sum()
    if chunk == 4096:
        np.testing.assert_allclose(res["image"], ref["image"], atol=2.5)
        assert l1 < 0.01 * ref["sum_w"]
        diffs = _delay_diffs(ref, res)
        assert diffs.size > 50 and np.median(diffs) < 0.05 and diffs.max() < 0.5
    else:
        assert l1 < 0.03 * ref["sum_w"]
        assert np.abs(_blur3(res["image"]) - _blur3(ref["image"])).sum() < 0.01 * 9 * ref["sum_w"]


def test_delay_map_is_mean_centred(port_images):
    m, w = port_images["mean_delay"], port_images["weight_image"]
    finite = np.isfinite(m)
    assert finite.sum() > 500 and np.isnan(m[w == 0]).all()
    assert abs((m[finite] * w[finite]).sum() / w[finite].sum()) < 1e-3  # fs


def test_images_match_bundle_path(setup, port_images):
    """The image equals Detector.get_Image / get_DelayMap of the port on the
    K1 bundle of the same spiral with the image's weights as intensities
    (tests/test_gigascan.py:127-185): one chunk, the same rays, so the
    images agree to float64 summation; the delay maps differ by the
    constant between their centrings."""
    spec, tels, det = setup[3]
    bspec = spec.baked()
    out = ft.fused_source_trace_ref(ft.chain_table(bspec, tels), bspec, N, device="cpu")
    rr = ft.synth_spec(bspec, torch.arange(N), N)[2]
    bundle = RayBundle(p=out.p, d=out.d, opl=out.opl, opl_c=out.opl_c, alive=out.alive,
                          intensity=torch.exp(float(np.log(spec.gaussian_edge)) * rr),
                          incidence=out.incidence, wavelength=torch.tensor(spec.wavelength))
    img, _ = det.get_Image(bundle, bins=BINS, extent=port_images["extent"])
    np.testing.assert_allclose(img.double().numpy(), port_images["image"], rtol=0, atol=1e-5)
    assert port_images["sum_w"] == pytest.approx(float(bundle.weights().double().sum()), rel=1e-6)
    mean, w_img, _ = det.get_DelayMap(bundle, bins=BINS, extent=port_images["extent"])
    mean, w_img = mean.double().numpy(), w_img.double().numpy()
    finite = np.isfinite(mean)
    np.testing.assert_array_equal(finite, np.isfinite(port_images["mean_delay"]))
    mean = mean - (mean[finite] * w_img[finite]).sum() / w_img[finite].sum()
    diffs = np.abs(mean - port_images["mean_delay"])[finite & (w_img > MIN_WEIGHT)]
    assert diffs.size > 50 and np.median(diffs) < 0.05 and diffs.max() < 0.5


def _jax_chunk_law(chain, elements, det, n_total, chunk, monkeypatch):
    """(n_local, phase, k_frac) of every chunk JAX's fused_source_images
    traces (engine "xla-source", extent given, the traces and binnings
    stubbed), recorded from its multi-chunk dispatch and its remainder
    loop."""
    calls = []

    def fused(phases, kfracs, *args, chunk, **kw):
        calls.extend((chunk, float(p), float(k)) for p, k in zip(np.asarray(phases),
                                                                 np.asarray(kfracs)))
        bins = kw["bins"]
        return (jnp.zeros((kw["n_groups"],) + bins, jnp.float32),) * 2

    class State:
        def __init__(self, n):
            z = jnp.zeros((n,), jnp.float32)
            self.px = self.py = self.pz = self.dx = self.dy = self.dz = z
            self.opl = self.opl_c = self.incidence = z
            self.alive = jnp.zeros((n,), bool)

    def run(els, maps, final, premasks, det_, kind, radius, phase, k_frac, *rest):
        n_local = rest[3]
        calls.append((n_local, float(phase), float(k_frac)))
        return State(n_local)

    def binned(bundle, weights, centre, normal, rot, lo, hi, opl_ref, bins):
        return (jnp.zeros(bins, jnp.float32),) * 2

    monkeypatch.setattr(jgs, "_images_fused_xla", fused)
    monkeypatch.setattr(jxs, "_xla_source_run", run)
    monkeypatch.setattr(jgs, "_chunk_binned_sums", binned)
    extent = (np.array([-1.0, -1.0]), np.array([1.0, 1.0]))
    jgs.fused_source_images(chain.source_spec, elements, det, n_total=n_total, bins=(4, 4),
                            extent=extent, chunk=chunk, engine="xla-source")
    return calls


def _extended_chain():
    R, r = jmirror.ReturnOptimalToroidalRadii(500.0, 80.0)
    tor = jmirror.MirrorToroidal(R, r, jsupp.SupportRectangle(150, 32))
    mask = jmask.Mask(jsupp.SupportRoundHole(20, 3, 0, 0))
    props = {"Divergence": 10e-3, "SourceSize": 0.4, "Wavelength": 80e-6, "NumberRays": N}
    return OEPlacement(props, [mask, tor, tor], [400, 100, 500], [0, 80, -80], [0, 0, 0])


def _square_chain():
    par = jmirror.MirrorParabolic(100, 90, jsupp.SupportRoundHole(30, 5, 10, 5))
    props = {"Divergence": 0, "SourceSize": 50, "Wavelength": 800e-6, "DeltaFT": 2.7,
             "NumberRays": 64}
    placed = OEPlacement(props, [par], [200], [0.0])
    bundle, spec = jsource.PlaneWaveSquareFused(np.zeros(3), np.array([1.0, 0.0, 0.0]), 40.0, N,
                                                Wavelength=800e-6, gaussian_edge=float(np.exp(-2.0)))
    return jchain.OpticalChain(bundle, placed.optical_elements, source_spec=spec)


@pytest.mark.parametrize("kind", ["cone", "extended", "square"])
def test_chunk_law_matches_jax(setup, kind, monkeypatch):
    """The (n_local, phase, k_frac) of every chunk the port's loop traces
    (recorded through its chunk tracer) equal the JAX package's
    (_phase_kfrac, chunks aligned to whole sub-sources and grid rows), as
    the float32 scalars both kernels take."""
    if kind == "cone":
        chain, elements, det = setup[:3]
    else:
        chain = _extended_chain() if kind == "extended" else _square_chain()
        elements = [e.to_device(dtype=jnp.float32) for e in chain.optical_elements]
        det = JDetector(chain.optical_elements[-1].position)
        det.autoplace(chain.get_output_rays()[-1], 400.0)
    n_total, chunk = 3 * 1000 + 517, 1000
    ref = _jax_chunk_law(chain, elements, det, n_total, chunk, monkeypatch)
    spec, tels, tdet = _carry(chain, elements, det)
    assert spec.baked().kind == kind
    got = []

    def recording(table, bspec, size, n_tot, *, device, ignore_defects):
        plain = gs.plain_chunks(table, bspec, size, n_tot, device=device,
                                ignore_defects=ignore_defects)

        def trace_chunk(n_local, phase, k_frac):
            got.append((n_local, float(np.float32(phase)), float(np.float32(k_frac))))
            return plain(n_local, phase, k_frac)

        return trace_chunk

    gs._images(spec, tels, tdet, n_total, (4, 4), (np.array([-1.0, -1.0]), np.array([1.0, 1.0])),
               chunk, True, torch.device("cpu"), recording)
    assert got == ref and len(got) >= 4
    assert sum(n for n, _p, _k in got) == n_total
    if kind != "cone":
        n_each = spec.baked().n_each
        assert 1 < n_each < chunk and all(n % n_each == 0 for n, _p, _k in got[:-1])


@pytest.mark.parametrize("engine", gs.ENGINES)
def test_cuda_images_launch_k1_or_raise(setup, monkeypatch, engine):
    """On a CUDA chain (the image's device is the elements') both JAX engine
    names go to kernel K1i's one launch for all chunks
    (``prepare_fused_source_image``, with the chunk law, the chief-ray path
    and the window), never to K1's chunk loop or the plain version."""
    spec, tels, det = setup[3]
    extent = (np.array([-1.0, -2.0]), np.array([1.0, 2.0]))

    class Launched(Exception):
        pass

    def prepare(table, bspec, chunks, n_total, image_det, window, bins, *, device, gaussian_edge,
                ignore_defects, record):
        assert device.type == "cuda" and n_total == N and bins == BINS and record is None
        assert chunks == ft.source_chunks(bspec.kind, N, N) and gaussian_edge == spec.gaussian_edge
        assert image_det.opl_ref == 1234.5 and np.array_equal(window[1], extent[1])
        raise Launched

    def refuse(*args, **kwargs):
        raise AssertionError("the K1 loop or a plain version ran on a CUDA device")

    def refs(bspec, els, centre, normal, *, device, dtype):
        assert device.type == "cuda"
        return 1234.5, 1.0

    monkeypatch.setattr(gs, "_elements_device", lambda elements: torch.device("cuda"))
    monkeypatch.setattr(ft, "chief_ray_refs", refs)
    monkeypatch.setattr(ft, "prepare_fused_source_image", prepare)
    for name in ("prepare_fused_source_chunks", "fused_source_trace_ref", "fused_source_image_ref"):
        monkeypatch.setattr(ft, name, refuse)
    with pytest.raises(Launched):
        gs.fused_source_images(spec, tels, det, n_total=N, bins=BINS, extent=extent, engine=engine)


def test_images_refuse_an_unknown_engine(setup):
    spec, tels, det = setup[3]
    with pytest.raises(ValueError):
        gs.fused_source_images(spec, tels, det, n_total=N, engine="xla")
