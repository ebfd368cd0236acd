"""PyTorch port vs the JAX package on chains whose mirrors carry grid defect
maps (``Fourrier``, ``MeasuredMap``): every path of the port takes them at
production ray counts through the kernels (their plain versions here, on
the CPU), where the JAX package takes its XLA source engine
(``ops/xla_source.py``), its XLA scan engine and autograd.

The chains are built in both packages from the same seeds: the OAP with a
Fourier-PSD map of tests/test_xla_source.py (``smallest`` 0.5 mm: a 200 x
200 map), and the flagship with a map on its first toroid (``smallest`` 1
mm: 300 x 64 nodes). ``PALLAS_MIN_RAYS`` is patched down to 1024, as
tests/test_xla_source.py:151 patches it, so chains of a few thousand rays
take the kernel engines. Tolerances, each with its source:

* K1 against ``xla_trace_source`` (both float32 chained traces): alive
  counts within 0.5 % + 5 (tests/test_xla_source.py:65), alive positions per
  ray within 1e-3 mm median and 5e-2 mm max (tests/test_pallas.py:44-51);
* K3/K4 against the JAX streamed trace of the same bundle: the same;
* K2's moments against ``xla_source_moments``: spot SD rel 5e-3, duration SD
  3 % or 0.9 fs in quadrature, sum of weights rel 5e-3
  (tests/test_xla_source.py:88-99);
* the one-pass optimizer against JAX's with the XLA moments: distance 0.2
  mm, spot SD rel 2e-2 or 1e-5 mm (:130-131); a scan: distance 0.5 mm,
  transmission rel 2e-2 (:171-174); ``main.main``: the optimizer's;
* K6 (all tangent rows) against JAX's autograd of the focus loss: loss rel
  2e-3, gradient 2e-2 of its largest entry plus 2e-2 relative
  (tests/test_gradients.py:188-192); ``gradient_align`` losses per step
  rel 2e-3.
"""

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
from attosecondraytracing_tpu.models import chain as jchain  # noqa: E402
from attosecondraytracing_tpu.models.detector import Detector as JDetector  # noqa: E402
from attosecondraytracing_tpu.ops import pallas_trace as jpt  # noqa: E402
from attosecondraytracing_tpu.ops import xla_source as jxs  # noqa: E402
from attosecondraytracing_tpu.ops.trace import trace_jit  # noqa: E402
from attosecondraytracing_tpu_torch import interop  # noqa: E402
from attosecondraytracing_tpu_torch import main as tmain  # noqa: E402
from attosecondraytracing_tpu_torch.analysis import alignment as tal  # noqa: E402
from attosecondraytracing_tpu_torch.models import chain as tchain  # noqa: E402
from attosecondraytracing_tpu_torch.models.detector import Detector as TDetector  # noqa: E402
from attosecondraytracing_tpu_torch.ops import defects as todef  # noqa: E402
from attosecondraytracing_tpu_torch.ops import fused_grad as fg  # noqa: E402
from attosecondraytracing_tpu_torch.ops import fused_trace as ft  # noqa: E402
from attosecondraytracing_tpu_torch.ops import xla_source as txs  # noqa: E402

torch.set_num_threads(2)

N = 8192
EDGE = float(np.exp(-2.0))


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


def _pkg(pkg):
    from importlib import import_module

    return {m: import_module(f"{pkg}.models.{m}")
            for m in ("mirrors", "masks", "supports", "defects", "placement")}


def _oap(pkg, n_rays=N, rms=1e-4, extra=()):
    """tests/test_xla_source.py's chain: an OAP (f 150 mm, 90 deg) over a
    25 mm disk with a Fourier-PSD map (smallest wavelength 0.5 mm, seed
    12345), lit by a 60 mm plane wave; ``extra`` names further defects of
    the same mirror ("zernike")."""
    m = _pkg(pkg)
    support = m["supports"].SupportRound(25)
    mirror = m["mirrors"].MirrorParabolic(FocalEffective=150, OffAxisAngle=90, Support=support)
    defects = [m["defects"].Fourrier(support, RMS=rms, smallest=0.5, seed=12345)]
    if "zernike" in extra:
        defects.append(m["defects"].Zernike(support, {(2, 0): 2e-4, (3, 1): -1e-4}))
    props = {"Divergence": 0, "SourceSize": 60, "Wavelength": 80e-6, "DeltaFT": 0.5, "NumberRays": n_rays}
    return m["placement"].OEPlacement(props, [m["mirrors"].DeformedMirror(mirror, defects)], [200.0],
                                      [0.0], [0.0], "deformed"), props


def _flagship(pkg, n_rays=N, both_toroids=False):
    """The flagship (round-hole mask, two toroids in f-d-f) with a
    Fourier-PSD map on its first toroid (on both with ``both_toroids``:
    seeds 3 and 4)."""
    m = _pkg(pkg)
    R, r = m["mirrors"].ReturnOptimalToroidalRadii(500.0, 80.0)
    sup = m["supports"].SupportRectangle(150, 32)
    tor = m["mirrors"].MirrorToroidal(R, r, sup)

    def deformed(seed):
        return m["mirrors"].DeformedMirror(tor, [m["defects"].Fourrier(sup, RMS=1e-4, smallest=1.0,
                                                                        seed=seed)])

    mask = m["masks"].Mask(m["supports"].SupportRoundHole(Radius=20, RadiusHole=7, CenterHoleX=0,
                                                          CenterHoleY=0))
    props = {"Divergence": 25e-3, "SourceSize": 0, "Wavelength": 80e-6, "DeltaFT": 0.5,
             "NumberRays": n_rays}
    second = deformed(4) if both_toroids else tor
    return m["placement"].OEPlacement(props, [mask, deformed(3), second], [400.0, 100.0, 500.0],
                                      [0.0, 80.0, -80.0], [0.0, 0.0, 0.0], "grid flagship"), props


def _both(chain):
    """(JAX float32 elements, port float64 elements, JAX and port source
    info) of a JAX chain."""
    jels = [e.to_device(dtype=jnp.float32) for e in chain.optical_elements]
    tels = interop.elements_from_numpy(jax.tree.map(np.asarray, jels), device="cpu",
                                       dtype=torch.float64)
    info = chain.source_spec
    return jels, tels, info, interop.source_spec_from_numpy(info)


def _assert_rays_close(got, ref):
    """Alive counts within 0.5 % + 5; positions of rays alive in both within
    1e-3 mm median and 5e-2 mm max."""
    ja, ta = np.asarray(ref.alive), got.alive.cpu().numpy()
    assert abs(int(ja.sum()) - int(ta.sum())) <= 0.005 * ja.sum() + 5
    both = ja & ta
    assert both.sum() > 500
    dp = np.abs(got.p.cpu().numpy()[both] - np.asarray(ref.p)[both])
    assert np.median(dp) < 1e-3 and dp.max() < 5e-2, (np.median(dp), dp.max())


# ---------------------------------------------------------------------------
# F7: every path takes a grid chain at PALLAS_MIN_RAYS or more
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("source", ["factory", "user bundle"])
def test_trace_final_grid_chain_at_kernel_size(monkeypatch, source):
    """trace_final on a grid chain at PALLAS_MIN_RAYS rays or more takes a
    kernel engine, K1 for a factory source and K4 for a bundle the user
    built (their plain versions here), against the JAX package's XLA source
    engine and its streamed trace of the same bundle."""
    monkeypatch.setattr(tchain, "PALLAS_MIN_RAYS", 1024)
    jc, _ = _oap("attosecondraytracing_tpu")
    jels, *_ = _both(jc)
    tc = _oap("attosecondraytracing_tpu_torch")[0].to("cpu")
    if source == "factory":
        got = tc.trace_final()
        assert tc.last_trace_engine == "torch-source"
        ref = jxs.xla_trace_source(jc.source_spec.baked(), jels, N, wavelength=80e-6)
    else:
        bundle = interop.bundle_from_numpy(jax.tree.map(np.asarray, jc.source_rays), device="cpu",
                                           dtype=torch.float32)
        tc.source_rays = bundle
        got = tc.trace_final()
        assert tc.last_trace_engine == "torch-streamed"
        ref = trace_jit(jax.tree.map(lambda x: jnp.asarray(x, jnp.float32)
                                     if jnp.issubdtype(jnp.asarray(x).dtype, jnp.floating) else x,
                                     jc.source_rays), jels, keep_history=False)
    _assert_rays_close(got, ref)


def test_main_grid_chain_auto_detector_matches_jax(monkeypatch):
    """main.main with AutoDetectorDistance on a grid chain: one K1 and one
    K2 pass (plain versions) against the JAX package's main on its XLA
    source engine and XLA moments."""
    monkeypatch.setattr(jchain, "PALLAS_MIN_RAYS", 1024)
    monkeypatch.setattr(tchain, "PALLAS_MIN_RAYS", 1024)
    do = {"AutoDetectorDistance": True, "DistanceDetector": 150.0, "OptFor": "spotsize"}
    ao = {"verbose": False, "save_results": False}
    jc, props = _oap("attosecondraytracing_tpu")
    jk = jmain.main(jc, props, do, ao)
    tc, _ = _oap("attosecondraytracing_tpu_torch")
    tk = tmain.main(tc, props, do, ao, device="cpu")
    assert tc.last_trace_engine == "torch-source"
    (jT,), (tT,) = jk["ETransmission"], tk["ETransmission"]
    assert 0 < tT <= 100 and tT == pytest.approx(jT, rel=2e-2)
    assert tk["Detector"][0].get_distance() == pytest.approx(jk["Detector"][0].get_distance(), abs=0.2)
    assert tk["SpotSizeSD"][0] == pytest.approx(jk["SpotSizeSD"][0], rel=2e-2, abs=1e-5)


def test_scan_of_grid_chains_matches_jax_xla_scan(monkeypatch):
    """A 3-chain pitch scan of a grid chain: the port's scan engine (K5's
    plain version, one record for the three chains, which share the map)
    against the JAX package's XLA scan engine (tests/test_xla_source.py:
    151-174)."""
    monkeypatch.setattr(jchain, "PALLAS_MIN_RAYS", 1024)
    monkeypatch.setattr(tchain, "PALLAS_MIN_RAYS", 1024)
    monkeypatch.setattr(jmain, "_CLI_ACTIVE", True)
    monkeypatch.setenv("ART_TPU_SCAN_ENGINE", "xla")
    sp = {"NumberRays": 4096}
    do = {"AutoDetectorDistance": True, "DistanceDetector": 150.0, "OptFor": "spotsize"}
    ao = {"verbose": False, "save_results": False}
    pitches = np.linspace(-0.1, 0.1, 3)
    jchains = _oap("attosecondraytracing_tpu", 4096)[0].get_OE_loop_list(0, "pitch", pitches)
    jk = jmain.main(jchains, sp, do, ao)
    assert all(c.last_trace_engine == "xla-scan" for c in jchains)
    monkeypatch.delenv("ART_TPU_SCAN_ENGINE")
    tchains = _oap("attosecondraytracing_tpu_torch", 4096)[0].get_OE_loop_list(0, "pitch", pitches)
    tk = tmain.main(tchains, sp, do, ao, device="cpu")
    assert all(c.last_trace_engine == "torch-scan" for c in tchains)
    for d_t, d_j in zip(tk["Detector"], jk["Detector"]):
        assert d_t.get_distance() == pytest.approx(d_j.get_distance(), abs=0.5)
    np.testing.assert_allclose(tk["ETransmission"], jk["ETransmission"], rtol=0.02)


def test_gradient_align_auto_on_grid_chain(monkeypatch):
    """gradient_align(engine="auto") on a grid chain at PALLAS_MIN_RAYS rays
    or more takes the fused engine (K6's plain version, every tangent row
    per step); its losses per step against the JAX package's autograd
    engine from the same start."""
    from attosecondraytracing_tpu.analysis import alignment as jal

    monkeypatch.setattr(tchain, "PALLAS_MIN_RAYS", 1024)
    kw = dict(iters=3, lr=2e-4, survival_weight=0.1)
    # JAX in float32 throughout, as its engines run: under this suite's x64
    # default its autograd graph mixes float64 in and compiles for minutes
    with jax.enable_x64(False):
        jc, _ = _flagship("attosecondraytracing_tpu", 4096)
        jc.rotate_OE(1, "roll", 0.3)
        jdet = JDetector(jc.optical_elements[-1].position)
        jdet.autoplace(jc.trace_final(engine="xla"), 500.0)
        _, jh = jal.gradient_align(jc, jdet, engine="xla", **kw)
    tc = _flagship("attosecondraytracing_tpu_torch", 4096)[0].to("cpu")
    tc.rotate_OE(1, "roll", 0.3)
    tdet = TDetector(tc.optical_elements[-1].position)
    tdet.autoplace(tc.trace_final(engine="trace"), 500.0)
    _, th = tal.gradient_align(tc, tdet, engine="auto", **kw)
    assert tal.gradient_align.last_engine == "torch-grad"
    np.testing.assert_allclose(th, jh, rtol=2e-3)


# ---------------------------------------------------------------------------
# the kernels' plain versions against the JAX engines
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ignore", [True, False])
@pytest.mark.parametrize("build", ["oap", "flagship", "zernike and grid", "two grid mirrors"])
def test_k1_plain_matches_xla_trace_source(build, ignore):
    """K1's plain version against xla_trace_source on grid chains, both
    ignore_defects: a map on one mirror, a mirror carrying a Zernike and a
    grid defect, two grid mirrors; the record takes each grid."""
    chain = {"oap": lambda: _oap("attosecondraytracing_tpu")[0],
             "flagship": lambda: _flagship("attosecondraytracing_tpu")[0],
             "zernike and grid": lambda: _oap("attosecondraytracing_tpu", extra=("zernike",))[0],
             "two grid mirrors": lambda: _flagship("attosecondraytracing_tpu", both_toroids=True)[0],
             }[build]()
    jels, tels, jinfo, tinfo = _both(chain)
    table = ft.chain_table(tinfo.baked(), tels)
    rec = ft.pack_chain(table, ignore)
    assert rec["n_grids"] == (2 if build == "two grid mirrors" else 1)
    assert rec["n_zernike"] == (build == "zernike and grid")
    ref = jxs.xla_trace_source(jinfo.baked(), jels, N, wavelength=80e-6, ignore_defects=ignore)
    got = ft.fused_source_trace(table, tinfo.baked(), N, device="cpu", ignore_defects=ignore)
    _assert_rays_close(got, ref)
    if not ignore and build == "oap":  # the slopes turn the directions
        base = ft.fused_source_trace(table, tinfo.baked(), N, device="cpu", ignore_defects=True)
        both = base.alive & got.alive
        assert float((base.d[both] - got.d[both]).abs().max()) > 1e-5


@pytest.mark.parametrize("fresh", [True, False])
def test_k34_plain_matches_jax_streamed_trace(fresh):
    """K4 (fresh) and K3's plain versions on a bundle through the grid
    flagship, ignore_defects False, against the JAX package's streamed trace
    of the same float32 bundle (K3's: the bundle after the mask)."""
    chain = _flagship("attosecondraytracing_tpu", N)[0]
    jels, tels, *_ = _both(chain)
    src = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32)
                       if jnp.issubdtype(jnp.asarray(x).dtype, jnp.floating) else x, chain.source_rays)
    if not fresh:
        src = trace_jit(src, jels[:1], keep_history=False)
        jels, tels = jels[1:], tels[1:]
    ref = trace_jit(src, jels, ignore_defects=False, keep_history=False)
    bundle = interop.bundle_from_numpy(jax.tree.map(np.asarray, src), device="cpu", dtype=torch.float32)
    assert ft._is_fresh(bundle) == fresh
    got = ft.streamed_trace(ft.chain_table(None, tels), bundle, device="cpu", ignore_defects=False)
    _assert_rays_close(got, ref)


@pytest.fixture(scope="module")
def oap_detector():
    """The OAP chain in both packages and tests/test_xla_source.py's
    detector, 8 mm short of the focus."""
    chain = _oap("attosecondraytracing_tpu")[0]
    jels, tels, jinfo, tinfo = _both(chain)
    out = trace_jit(chain.source_rays, jels, ignore_defects=False, keep_history=False)
    det = JDetector(np.zeros(3))
    det.autoplace(out, 142.0)
    return {"jels": jels, "tels": tels, "jspec": jinfo.baked(), "tspec": tinfo.baked(), "det": det,
            "out": out}


def test_k2_moments_match_xla_source_moments(oap_detector):
    """K2's moments (through the port's ops/xla_source) against the JAX
    package's xla_source_moments on the OAP, ignore_defects False: the
    statistics at 3 distances."""
    d = oap_detector
    det = d["det"]
    args = (det.centre, det.normal, det._plane_rotation())
    ref = jxs.xla_source_moments(d["jspec"], d["jels"], N, *args, gaussian_edge=EDGE, ignore_defects=False)
    got = txs.xla_source_moments(d["tspec"], d["tels"], N, *args, gaussian_edge=EDGE, ignore_defects=False)
    assert got["opl_ref"] == pytest.approx(ref["opl_ref"], abs=1e-3)
    distances = (-5.0, 0.0, 5.0)
    sk, sr = (ft.sums_to_stats(ft.moments_to_distance_sums(m["moments"], distances, m["centre_distance"]),
                               m["opl_ref"], distances) for m in (got, ref))
    np.testing.assert_allclose(sk["sum_w"], sr["sum_w"], rtol=5e-3)
    np.testing.assert_allclose(sk["spot_sd"], sr["spot_sd"], rtol=5e-3, atol=1e-6)
    for k, r in zip(sk["duration_sd"], sr["duration_sd"]):
        assert abs(k - r) <= 0.03 * r or abs(k * k - r * r) ** 0.5 <= 0.9, (k, r)


def test_optimizer_matches_jax_with_xla_moments(oap_detector):
    """FindOptimalDistanceFused over the port's make_xla_moments_fn against
    the JAX package's FindOptimalDistancePallas over its XLA moments."""
    from attosecondraytracing_tpu.analysis.optimizer import FindOptimalDistancePallas
    from attosecondraytracing_tpu_torch.analysis.optimizer import FindOptimalDistanceFused

    d = oap_detector
    jfn = jxs.make_xla_moments_fn(d["jspec"], d["jels"], N, ignore_defects=False)
    jd, jspot, _ = FindOptimalDistancePallas(d["jspec"], d["jels"], N, d["det"], OptFor="spotsize",
                                             Amplitude=20.0, Precision=3, moments_fn=jfn)
    tdet = TDetector(np.zeros(3))
    tdet.centre, tdet.normal = d["det"].centre, d["det"].normal
    tfn = txs.make_xla_moments_fn(d["tspec"], d["tels"], N, ignore_defects=False)
    td, tspot, _ = FindOptimalDistanceFused(d["tspec"], d["tels"], N, d["det"], OptFor="spotsize",
                                            Amplitude=20.0, Precision=3, device="cpu", moments_fn=tfn)
    assert td.get_distance() == pytest.approx(jd.get_distance(), abs=0.2)
    assert tspot == pytest.approx(jspot, rel=2e-2, abs=1e-5)


def test_k6_plain_matches_jax_autograd():
    """One gradient step on the grid flagship: K6's plain version (all 18
    tangent rows in one call) through fused_focus_value_and_grad against the
    JAX package's autograd of the focus loss on the kernel-form source with
    the rr-law weights (tests/test_gradients.py:140-192)."""
    from attosecondraytracing_tpu.analysis import alignment as jal

    n = 4096
    chain = _flagship("attosecondraytracing_tpu", n)[0]
    jels, tels, jinfo, tinfo = _both(chain)
    baked = jinfo.baked()
    det = JDetector(chain.optical_elements[-1].position)
    det.autoplace(trace_jit(jpt.source_bundle(baked, 256, wavelength=80e-6), jels, keep_history=False), 495.0)
    rot = det._plane_rotation()
    geo = (np.asarray(baked.rot, np.float64), np.asarray(jinfo.origin, np.float64), det.centre, det.normal,
           rot)
    angles = np.zeros((3, 3), np.float32)
    shifts = np.zeros((3, 3), np.float32)
    angles[1, 0], angles[2, 2], shifts[1, 0] = 2e-4, -1e-4, 0.05
    jparams = jal.AlignmentParams(jnp.asarray(angles), jnp.asarray(shifts))
    src = jpt.source_bundle(baked, n, wavelength=80e-6)
    src = src._replace(intensity=jnp.exp(np.log(EDGE) * jnp.arange(n, dtype=jnp.float32) / n))

    def xla_loss(p):
        return jal.focus_loss(p, src, jels, jnp.asarray(det.centre, jnp.float32),
                              jnp.asarray(det.normal, jnp.float32), jnp.asarray(rot, jnp.float32),
                              duration_weight=0.0, survival_weight=1.0)

    with jax.enable_x64(False):  # float32, as the engine runs (see test_gradient_align_auto_on_grid_chain)
        loss_x, grads_x = jax.value_and_grad(xla_loss)(jparams)
    spec = fg.make_loss_spec(tinfo._replace(gaussian_edge=EDGE, n_rays=n), tels, det.centre, det.normal,
                             device="cpu")
    tparams = tal.AlignmentParams(torch.from_numpy(angles), torch.from_numpy(shifts))
    loss_f, grads_f = fg.fused_focus_value_and_grad(tparams, spec, tels, *geo, device="cpu")
    assert loss_f == pytest.approx(float(loss_x), rel=2e-3)
    for g_f, g_x in ((grads_f.angles, grads_x.angles), (grads_f.shifts, grads_x.shifts)):
        g_x = np.asarray(g_x)
        scale = max(float(np.abs(g_x).max()), 1e-12)
        np.testing.assert_allclose(g_f.numpy(), g_x, atol=2e-2 * scale, rtol=2e-2)


# ---------------------------------------------------------------------------
# the record and the caches
# ---------------------------------------------------------------------------


def test_pack_chain_grid_fields():
    """GridP of a packed grid: the map's nodes, origin and spacing as
    float32, the clamp bounds nx - 1.000001 and ny - 1.000001 rounded as
    float32 (as the plain version's clamp rounds them), its mirror's range;
    the rows pointer is 0 without a device and the packed rows' with one."""
    chain = _flagship("attosecondraytracing_tpu_torch", 16)[0].to("cpu")
    table = ft.chain_table(chain.source_spec.baked(), chain.device_elements(torch.float64))
    (grid,) = table.elements[0].defects
    nx, ny = grid.height.shape
    assert (nx, ny) == (300, 64)
    rec = ft.pack_chain(table, False)
    g = rec["grid"][0]
    assert rec["n_grids"] == 1 and list(rec["grid_begin"][:2]) == [0, 1] and list(rec["grid_end"][:2]) == [1, 1]
    assert (g["nx"], g["ny"], g["rows"]) == (nx, ny, 0)
    for f in ("x0", "y0", "dx", "dy"):
        assert g[f] == np.float32(getattr(grid, f))
    assert g["fx_max"] == np.float32(nx - 1.000001) and g["fy_max"] == np.float32(ny - 1.000001)
    rows = ft.grid_rows(grid, "cpu")
    assert ft.pack_chain(table, False, "cpu")["grid"][0]["rows"] == rows.data_ptr()
    assert rows.shape == (nx * ny, 4) and rows.dtype == torch.float32
    np.testing.assert_array_equal(rows[:, 0].numpy(), grid.height.reshape(-1).float().numpy())
    np.testing.assert_array_equal(rows[:, 2].numpy(), grid.slope_y.reshape(-1).float().numpy())
    assert not rows[:, 3].any()
    with pytest.raises(NotImplementedError, match="MAX_GRIDS = 4"):
        ft.pack_chain(table._replace(elements=(table.elements[0]._replace(defects=(grid,) * 5),)
                                     + table.elements[1:]))


def test_grid_maps_made_once_per_device_and_freed_with_the_map():
    """A grid map's copies and packed rows are made once per device while
    the map lives (the element records of every call share them), chain
    copies share the map, and the cache entry goes with the map."""
    import gc

    chain = _flagship("attosecondraytracing_tpu_torch", 16)[0].to("cpu")
    a = chain.device_elements(torch.float32)[1].defects[0]
    b = chain.copy_chain().device_elements(torch.float32)[1].defects[0]
    assert a.height is b.height and a.height.dtype == torch.float32
    host = chain.optical_elements[1].to_device("cpu", torch.float64).defects[0]
    assert ft.grid_rows(host, "cpu") is ft.grid_rows(host, "cpu")
    defect = todef.GridDefect(torch.zeros(4, 3), torch.ones(4, 3), torch.ones(4, 3), 0.0, 0.0, 1.0, 1.0)
    key = id(defect.height)
    ft.grid_rows(defect, "cpu")
    assert key in todef._DERIVED
    del defect
    gc.collect()
    assert key not in todef._DERIVED


def test_xla_source_names_take_the_jax_signatures():
    """The port's ops/xla_source has the JAX module's public names with its
    parameters (the port adds ``device``)."""
    for name in ("xla_trace_source", "xla_source_moments", "make_xla_moments_fn"):
        jp = list(inspect.signature(getattr(jxs, name)).parameters)
        tp = list(inspect.signature(getattr(txs, name)).parameters)
        assert tp[:len(jp)] == jp and tp[len(jp):] == ["device"], (name, jp, tp)
