"""PyTorch port vs the JAX package: ``parallel/mesh.py``, the sharded kernel
passes and their callers, on the CPU.

The JAX functions run on the 8 virtual CPU devices of tests/conftest.py,
their Pallas kernels in interpret mode as the JAX package's own tests run
them; the port runs on a ``["cpu"] * 8`` mesh (one process, eight shards),
its kernels' plain versions. Each sharded function is held against the JAX
function on the same inputs and against the port's unsharded call, within
the JAX tests' envelopes for shards (per-shard float32 spiral phases round
differently from the global digit split, so a boundary ray may move):

* stats (tests/test_stats_kernel.py:159-161): sum of weights and spot SD
  rel 2e-3, duration SD rel 2e-2 or 0.2 fs;
* scan moments (tests/test_scan_kernel.py:226-256): sum of weights 2e-3,
  spot SD 5e-3, duration SD 3 % or 0.9 fs in quadrature;
* images (tests/test_gigascan.py:100-127): sum of weights rel 1e-5, every
  pixel within 2.5, L1 within 2 % of the total weight (port against port;
  against the JAX package the two packages' float32 image envelope of
  tests/test_torch_gigascan.py, which holds with or without shards);
* gradient (tests/test_gradients.py:281-296): loss rel 1e-4, gradients
  within 2e-3 of their largest entry;
* traces (tests/test_parallel.py): float64 positions within 1e-12 mm of the
  unsharded trace (1e-9 of the JAX package's), padding dead.

One test runs two processes on gloo (2 ranks x 1 shard, a ``file://``
store, each with its own timeout): every result equals the one-process
2-shard mesh bit for bit."""

import os
import subprocess
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

from attosecondraytracing_tpu.models.detector import Detector as JDetector  # noqa: E402
from attosecondraytracing_tpu.ops import pallas_grad as jpg  # noqa: E402
from attosecondraytracing_tpu.ops import pallas_scan as jps  # noqa: E402
from attosecondraytracing_tpu.ops import pallas_trace as jpt  # noqa: E402
from attosecondraytracing_tpu.parallel import mesh as jmesh  # noqa: E402
from attosecondraytracing_tpu_torch import interop  # noqa: E402
from attosecondraytracing_tpu_torch.analysis import stats as tstats  # noqa: E402
from attosecondraytracing_tpu_torch.analysis.gigascan import fused_source_images  # noqa: E402
from attosecondraytracing_tpu_torch.ops import fused_grad as fg  # noqa: E402
from attosecondraytracing_tpu_torch.ops import fused_scan as fs  # noqa: E402
from attosecondraytracing_tpu_torch.ops import fused_trace as ft  # noqa: E402
from attosecondraytracing_tpu_torch.parallel import mesh as pm  # noqa: E402
from test_gradients import _grad_setup  # noqa: E402
from test_scan_kernel import _detector_for, _f32_elements, _flagship  # noqa: E402
from test_torch_batched import JAX, PORT, _models, _parallel_chain  # noqa: E402
from test_torch_fused_grad import _port_args  # noqa: E402
from test_torch_gigascan import _blur3, _delay_diffs, _moments  # noqa: E402

torch.set_num_threads(1)

N = 16384
DISTANCES = (-10.0, 0.0, 10.0)
EDGE = float(np.exp(-2.0))
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _no_stub_modules():
    """Set tests/reference_shims.py's stub modules aside while this module's
    tests run: torch.func (K6's plain version) looks modules up through
    inspect on its first transforms, which fails on the stubs."""
    with pytest.MonkeyPatch.context() as mp:
        for name, mod in list(sys.modules.items()):
            if not isinstance(getattr(mod, "__file__", None), (str, type(None))):
                mp.delitem(sys.modules, name)
        yield


def _mesh8():
    return pm.make_mesh(devices=["cpu"] * 8)


def _jax_mesh8():
    return jax.sharding.Mesh(np.array(jax.devices()[:8]), ("rays",))


@pytest.fixture(scope="module")
def flagship():
    """tests/test_scan_kernel.py's flagship (mask, two 80 deg toroids) in
    both packages: JAX float32 elements and the port's float64 copies, the
    source, and a detector 10 mm short of the focus."""
    chain = _flagship(16)
    elements = _f32_elements(chain)
    det = _detector_for(chain, elements)
    tels = interop.elements_from_numpy(jax.tree.map(np.asarray, elements), device="cpu",
                                       dtype=torch.float64)
    spec = chain.source_spec.baked()
    return {"chain": chain, "elements": elements, "tels": tels, "det": det, "spec": spec,
            "tspec": interop.source_spec_from_numpy(spec), "rot": det._plane_rotation()}


def _assert_shard_stats(a, b):
    np.testing.assert_allclose(a["sum_w"], b["sum_w"], rtol=2e-3)
    np.testing.assert_allclose(a["spot_sd"], b["spot_sd"], rtol=2e-3)
    np.testing.assert_allclose(a["duration_sd"], b["duration_sd"], rtol=2e-2, atol=0.2)


def _assert_scan_stats(a, b):
    np.testing.assert_allclose(a["sum_w"], b["sum_w"], rtol=2e-3)
    np.testing.assert_allclose(a["spot_sd"], b["spot_sd"], rtol=5e-3, atol=1e-6)
    for k, r in zip(a["duration_sd"], b["duration_sd"]):
        assert abs(k - r) <= 0.03 * r or abs(k * k - r * r) ** 0.5 <= 0.9, (k, r)


def _moment_stats(moments, opl_ref, centre_distance=0.0):
    sums = ft.moments_to_distance_sums(moments, DISTANCES, centre_distance)
    return ft.sums_to_stats(sums, opl_ref, DISTANCES)


def test_mesh_validation():
    """make_mesh: JAX's ValueError on a shape that does not match the
    devices; the axes, shape and shard coordinates; no default devices
    without a card."""
    with pytest.raises(ValueError):
        jmesh.make_mesh(rays=3, scan=2)
    with pytest.raises(ValueError):
        pm.make_mesh(rays=3, scan=2, devices=["cpu"] * 8)
    mesh = pm.make_mesh(rays=4, scan=2, devices=["cpu"] * 8)
    assert mesh.axis_names == ("scan", "rays") == jmesh.make_mesh(rays=4, scan=2).axis_names
    assert mesh.shape == {"scan": 2, "rays": 4} and mesh.size == 8
    assert mesh.shards == tuple(range(8)) and mesh.coords(6) == (1, 2) and mesh.group is None
    assert _mesh8().shape == {"scan": 1, "rays": 8}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pm.make_mesh()


def test_distributed_init_reports_failure(monkeypatch, capsys):
    """A failed init_process_group is said on stderr and returned as False,
    as the JAX package's distributed_init does (tests/test_parallel.py:99);
    the backend is gloo without a card."""
    import torch.distributed as dist

    seen = []

    def boom(**kwargs):
        seen.append(kwargs)
        raise RuntimeError("no coordinator address configured")

    monkeypatch.setattr(dist, "init_process_group", boom)
    assert pm.distributed_init() is False
    err = capsys.readouterr().err
    assert "continuing single-host" in err and "no coordinator address configured" in err
    assert seen == [{"backend": "gloo"}]


def test_shard_source_offsets_match_jax():
    """The per-shard (n_local, phase, k_frac) law, bit for bit."""
    for n_total, n_dev in ((N, 8), (10_000_000, 4), (1 << 30, 4), (999, 3)):
        n_j, ph_j, kf_j = jmesh.shard_source_offsets(n_total, n_dev)
        n_t, ph_t, kf_t = pm.shard_source_offsets(n_total, n_dev)
        assert n_t == n_j and ph_t.dtype == kf_t.dtype == np.float32
        np.testing.assert_array_equal(ph_t, np.asarray(ph_j))
        np.testing.assert_array_equal(kf_t, np.asarray(kf_j))
    with pytest.raises(ValueError):
        pm.shard_source_offsets(1000, 3)


def test_sharded_trace_matches_unsharded(monkeypatch):
    """tests/test_parallel.py::test_sharded_trace_matches_unsharded: 250
    rays over 8 shards are padded to 256; the real rays equal the unsharded
    trace and the JAX sharded trace, the padding stays dead, and a
    reduction over the result is whole."""
    monkeypatch.setenv("ART_TPU_DTYPE", "float64")
    chain = _parallel_chain(PORT, 250).to("cpu")
    ref = chain.trace_final()
    out = pm.trace_sharded(chain.source_rays, chain.device_elements(), _mesh8())
    assert out.n_rays == 256 and out.p.dtype == torch.float64
    n = ref.n_rays
    np.testing.assert_allclose(out.p[:n].numpy(), ref.p.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(out.alive[:n].numpy(), ref.alive.numpy())
    assert not out.alive[n:].any()
    assert tstats.energy_transmission(out, out) == pytest.approx(100.0)
    jchain = _parallel_chain("attosecondraytracing_tpu", 250)
    jout = jmesh.trace_sharded(jchain.source_rays, jchain.device_elements(), jmesh.make_mesh())
    alive = np.asarray(jout.alive)
    np.testing.assert_array_equal(out.alive.numpy(), alive)
    np.testing.assert_allclose(out.p.numpy()[alive], np.asarray(jout.p)[alive], rtol=0, atol=1e-9)
    history = pm.trace_sharded(chain.source_rays, chain.device_elements(), _mesh8(), keep_history=True)
    assert len(history) == 1 and torch.equal(history[0].p, out.p)


def test_bundle_sharding_and_shard_bundle():
    """Each shard's ray range under the padding law (the ray axis of a
    2 x 4 mesh: replicated along 'scan'), and its piece on its device."""
    mesh = pm.make_mesh(rays=4, scan=2, devices=["cpu"] * 8)
    slices = pm.bundle_sharding(mesh, 10)
    assert [(s.shard, s.rays.start, s.rays.stop) for s in slices] == [
        (i, 3 * (i % 4), 3 * (i % 4) + 3) for i in range(8)]
    stacked = pm.bundle_sharding(mesh, 8, n_chains=4)
    assert [(s.chains.start, s.chains.stop) for s in stacked] == [(0, 2)] * 4 + [(2, 4)] * 4
    with pytest.raises(ValueError):
        pm.bundle_sharding(mesh, 8, n_chains=3)
    chain = _parallel_chain(PORT, 10).to("cpu")
    pieces = pm.shard_bundle(chain.source_rays, mesh)
    assert [p.n_rays for _s, p in pieces] == [3] * 8
    assert not pieces[3][1].alive[1:].any() and pieces[3][1].alive[0]


def test_scan_sharded_2x4_mesh(monkeypatch):
    """tests/test_parallel.py::test_scan_sharded_2x4_mesh: two chains along
    'scan', their rays along 'rays': the (2, 128) result equals each chain's
    own trace and the JAX package's."""
    monkeypatch.setenv("ART_TPU_DTYPE", "float64")
    rolls = np.linspace(-0.2, 0.2, 2)
    chains = [c.to("cpu") for c in _parallel_chain(PORT, 128).get_OE_loop_list(0, "roll", rolls)]
    mesh = pm.make_mesh(rays=4, scan=2, devices=["cpu"] * 8)
    out = pm.trace_scan_sharded(chains, mesh)
    assert out.p.shape == (2, 128, 3) and out.wavelength.shape == (2,)
    jout = jmesh.trace_scan_sharded(
        _parallel_chain("attosecondraytracing_tpu", 128).get_OE_loop_list(0, "roll", rolls),
        jmesh.make_mesh(rays=4, scan=2))
    for i, c in enumerate(chains):
        ref = c.trace_final()
        np.testing.assert_allclose(out.p[i].numpy(), ref.p.numpy(), rtol=0, atol=1e-12)
        np.testing.assert_array_equal(out.alive[i].numpy(), ref.alive.numpy())
        alive = np.asarray(jout.alive)[i]
        np.testing.assert_allclose(out.p[i].numpy()[alive], np.asarray(jout.p)[i][alive], rtol=0,
                                   atol=1e-9)
    with pytest.raises(ValueError, match="divide the scan axis"):
        pm.trace_scan_sharded(chains + chains[:1], mesh)


def test_source_stats_sharded_matches_jax_and_unsharded(flagship):
    """K2 per shard (its plain version) over 8 shards: against the JAX
    package's source_stats_sharded and the port's single pass."""
    fl = flagship
    det = fl["det"]
    kw = dict(det_centre=det.centre, det_normal=det.normal, det_rot=fl["rot"], distances=DISTANCES)
    ft.fused_source_moments.launches = 0
    got = pm.source_stats_sharded(fl["tspec"], fl["tels"], N, _mesh8(), gaussian_edge=EDGE, **kw)
    assert ft.fused_source_moments.launches == 0  # plain versions launch nothing
    ref_j = jmesh.source_stats_sharded(fl["spec"], fl["elements"], N, _jax_mesh8(),
                                       gaussian_edge=EDGE, **kw)
    one = ft.source_detector_moments(fl["tspec"], fl["tels"], N, det.centre, det.normal, fl["rot"],
                                     device="cpu", gaussian_edge=EDGE)
    _assert_shard_stats(got, _moment_stats(one["moments"], one["opl_ref"]))
    _assert_shard_stats(got, {k: np.asarray(v) for k, v in ref_j.items()})
    with pytest.raises(ValueError):
        pm.source_stats_sharded(fl["tspec"], fl["tels"], N + 1, _mesh8(), **kw)
    for kind in ("extended", "square"):
        with pytest.raises(NotImplementedError):
            pm.source_stats_sharded(fl["tspec"]._replace(kind=kind), fl["tels"], N, _mesh8(), **kw)


def test_scan_moments_sharded_matches_jax_and_unsharded(flagship):
    """K5 per shard over 8 shards: against the JAX package's
    scan_moments_sharded and the port's scan_moments; what it refuses."""
    fl = flagship
    det, spec = fl["det"], fl["spec"]
    opl_ref, _o, inv_dn = jpt.chief_ray_refs(spec, fl["elements"], det.centre, det.normal, (0.0,))
    svec = jps.scan_chain_scalars(fl["elements"], np.asarray(spec.rot), np.asarray(spec.origin),
                                  det.centre, det.normal, fl["rot"])
    jspec = jps.make_scan_spec("cone", fl["elements"], N)
    tspec = fs.make_scan_spec("cone", fl["tels"], N)
    kw = dict(radius=spec.radius, gaussian_edge=EDGE)
    got = pm.scan_moments_sharded(tspec, svec, N, _mesh8(), opl_ref, inv_dn, **kw)
    ref_j = jmesh.scan_moments_sharded(jspec, svec, N, _jax_mesh8(), opl_ref, inv_dn, **kw)
    one = fs.scan_moments(tspec, svec, N, opl_ref, inv_dn, device="cpu", **kw)
    _assert_scan_stats(_moment_stats(got, opl_ref), _moment_stats(one, opl_ref))
    _assert_scan_stats(_moment_stats(got, opl_ref), _moment_stats(np.asarray(ref_j), opl_ref))
    for kind in ("extended", "square"):
        with pytest.raises(NotImplementedError):
            pm.scan_moments_sharded(tspec._replace(source_kind=kind), svec, N, _mesh8(), opl_ref, inv_dn)
    with pytest.raises(ValueError):
        pm.scan_moments_sharded(tspec, svec, N + 1, _mesh8(), opl_ref, inv_dn)


def test_scan_mesh_rules_and_moments_fn(flagship, monkeypatch):
    """``_scan_mesh``: None without ART_TPU_SCAN_MESH=1, on the CPU of one
    process, for extended and square sources and for a ray count that does
    not divide; with a mesh, ``make_moments_fn`` shards its K5 passes and
    matches the single-device closure."""
    fl = flagship
    det = fl["det"]
    tspec = fs.make_scan_spec("cone", fl["tels"], N)
    info = interop.source_spec_from_numpy(fl["chain"].source_spec)
    assert fs._scan_mesh(tspec, N, device="cpu") is None
    monkeypatch.setenv("ART_TPU_SCAN_MESH", "1")
    assert fs._scan_mesh(tspec, N, device="cpu") is None  # one process, no card
    fn_1 = fs.make_moments_fn(tspec, fl["tels"], info, N, device="cpu")
    monkeypatch.setattr(pm, "_default_mesh", lambda device: _mesh8())
    assert fs._scan_mesh(tspec, N, device="cpu").size == 8
    assert fs._scan_mesh(tspec._replace(source_kind="extended"), N, device="cpu") is None
    assert fs._scan_mesh(tspec._replace(source_kind="square"), N, device="cpu") is None
    assert fs._scan_mesh(tspec, N + 3, device="cpu") is None
    fn_8 = fs.make_moments_fn(tspec, fl["tels"], info, N, device="cpu")
    mom_1, mom_8 = (fn(det.centre, det.normal, fl["rot"], gaussian_edge=EDGE) for fn in (fn_1, fn_8))
    assert mom_8["opl_ref"] == mom_1["opl_ref"]
    _assert_scan_stats(_moment_stats(mom_8["moments"], mom_8["opl_ref"]),
                       _moment_stats(mom_1["moments"], mom_1["opl_ref"]))


@pytest.fixture(scope="module")
def image_chain():
    """tests/test_gigascan.py's chain (two 80 deg toroids, float32 elements,
    the detector 5 mm before the focus) in both packages."""
    mirrors, supports, _masks, placement = _models(JAX)
    R, r = mirrors.ReturnOptimalToroidalRadii(500.0, 80.0)
    tor = mirrors.MirrorToroidal(R, r, supports.SupportRectangle(150, 32))
    props = {"Divergence": 25e-3, "SourceSize": 0, "Wavelength": 80e-6, "DeltaFT": 0.5,
             "NumberRays": N}
    chain = placement.OEPlacement(props, [tor, tor], [500, 600], [80.0, -80.0], [0, 0])
    elements = [e.to_device(dtype=jax.numpy.float32) for e in chain.optical_elements]
    det = JDetector(chain.optical_elements[-1].position)
    det.autoplace(chain.trace_final(engine="xla"), 495.0)
    tels = interop.elements_from_numpy(jax.tree.map(np.asarray, elements), device="cpu",
                                       dtype=torch.float32)
    return chain, elements, tels, det


def _mean_delays(w, wd):
    has = w > 0
    return {"weight_image": w, "mean_delay": np.where(
        has, wd / np.where(has, w, 1.0) - wd.sum() / w.sum(), np.nan)}


def test_source_images_sharded_matches_jax_and_unsharded(image_chain):
    """K1i per shard (its plain version, the chunk loop) over 8 shards at
    16384 rays into 64 x 64 pixels. Against the port's single-device image:
    the JAX package's shard envelope (sum of weights 1e-5, every pixel
    within 2.5, L1 within 2 %) and mean delays within a median of 0.1 fs.
    Against the JAX package's source_images_sharded: the envelope of the two
    packages' float32 traces (tests/test_torch_gigascan.py::test_images_match_jax:
    3x3-blurred L1 within 5 %, centroids 0.05 pixel, variances 1 %, mean
    delays median 0.2 fs, max 1.2 fs), since the packages' impact points
    differ per ray by up to 2.2e-3 mm with or without shards. The JAX
    refusals."""
    chain, elements, tels, det = image_chain
    info = interop.source_spec_from_numpy(chain.source_spec)
    spec = info.baked()
    res_1 = fused_source_images(info, tels, det, n_total=N, bins=(64, 64))
    opl_ref, _i = ft.chief_ray_refs(spec, tels, det.centre, det.normal, device="cpu",
                                    dtype=torch.float32)
    args = (det.centre, det.normal, det._plane_rotation(), res_1["extent"])
    kw = dict(bins=(64, 64), gaussian_edge=info.gaussian_edge, opl_ref=opl_ref)
    w8, wd8 = pm.source_images_sharded(spec, tels, N, _mesh8(), *args, **kw)
    assert w8.shape == wd8.shape == (64, 64) and w8.dtype == np.float64
    ref = res_1["image"]
    assert w8.sum() == pytest.approx(ref.sum(), rel=1e-5)
    np.testing.assert_allclose(w8, ref, atol=2.5)
    assert np.abs(w8 - ref).sum() < 0.02 * ref.sum()
    diffs = _delay_diffs(_mean_delays(w8, wd8), res_1, 5.0)
    assert diffs.size > 50 and np.median(diffs) < 0.1

    wj, wdj = (np.asarray(x, np.float64) for x in jmesh.source_images_sharded(
        chain.source_spec.baked(), elements, N, _jax_mesh8(), *args, **kw))
    assert w8.sum() == pytest.approx(wj.sum(), rel=1e-4)
    assert np.abs(_blur3(w8) - _blur3(wj)).sum() < 0.05 * 9 * wj.sum()
    (c, v), (cj, vj) = _moments(w8), _moments(wj)
    np.testing.assert_allclose(c, cj, rtol=0, atol=0.05)
    np.testing.assert_allclose(v, vj, rtol=0.01)
    diffs = _delay_diffs(_mean_delays(w8, wd8), _mean_delays(wj, wdj), 5.0)
    assert diffs.size > 50 and np.median(diffs) < 0.2 and diffs.max() < 1.2

    for bad in (dict(n_total=N + 4), dict(chunk=1000), dict(chunk=1 << 25, n_total=1 << 28)):
        with pytest.raises(ValueError):
            pm.source_images_sharded(spec, tels, bad.get("n_total", N), _mesh8(), *args,
                                     chunk=bad.get("chunk", 1 << 23), **kw)
    for kind in ("extended", "square"):
        with pytest.raises(NotImplementedError):
            pm.source_images_sharded(spec._replace(kind=kind), tels, N, _mesh8(), *args)


def test_image_chunks_cover_the_spiral_unless_sharded(image_chain):
    """K1i's chunk table must cover the whole spiral (a chunking that drops
    rays raises), except where a shard asks for its part with
    ``covers_spiral=False``: then the two halves' images add up to the
    whole one."""
    chain, _elements, tels, det = image_chain
    spec = interop.source_spec_from_numpy(chain.source_spec).baked()
    table = ft.chain_table(spec, tels)
    rec = ft.ImageDetector(tuple(np.asarray(det.centre, np.float64)),
                           tuple(np.asarray(det.normal, np.float64)),
                           tuple(map(tuple, np.asarray(det._plane_rotation(), np.float64)[:2])), 0.0)
    window, bins = (np.array([-1.0, -1.0]), np.array([1.0, 1.0])), (32, 32)
    half = N // 2

    def images(chunks, **kw):
        out = tuple(torch.zeros(bins[0] * bins[1], dtype=torch.float64) for _ in range(2))
        ft.fused_source_image_ref(table, spec, chunks, N, rec, window, bins, out, device="cpu", **kw)
        return out

    with pytest.raises(ValueError):
        images([(half, 0.0, 0.0)])
    whole = images([(half, 0.0, 0.0), (half, float(np.mod(half * ft._PHI_FRAC, 1.0)), half / N)])
    parts = [images([(half, float(np.mod(o * ft._PHI_FRAC, 1.0)), o / N)], covers_spiral=False)
             for o in (0, half)]
    assert whole[0].sum() > 0
    for k in range(2):
        np.testing.assert_allclose((parts[0][k] + parts[1][k]).numpy(), whole[k].numpy(), rtol=1e-12,
                                   atol=1e-12)


def test_fused_grad_sharded_matches_jax_and_single():
    """K6 per shard over 8 shards (``fused_focus_value_and_grad(mesh=)``):
    against the port's single pass and the JAX package's sharded gradient;
    a shard of more rays than one kernel chunk, and an extended source,
    refused."""
    args = _grad_setup(8192)
    targs = _port_args(args)
    loss_1, grads_1 = fg.fused_focus_value_and_grad(*targs, device="cpu")
    loss_8, grads_8 = fg.fused_focus_value_and_grad(*targs, device="cpu", mesh=_mesh8())
    loss_j, grads_j = jpg.fused_focus_value_and_grad(*args, mesh=_jax_mesh8())
    for loss, grads in ((loss_1, grads_1), (float(loss_j), grads_j)):
        assert loss_8 == pytest.approx(float(loss), rel=1e-4)
        for g_8, g in zip(grads_8, (np.asarray(grads.angles), np.asarray(grads.shifts))):
            g_8, g = g_8.numpy(), np.asarray(g)
            scale = max(np.abs(g).max(), 1e-12)
            np.testing.assert_allclose(g_8, g, atol=2e-3 * scale, rtol=2e-3)
    with pytest.raises(ValueError, match="kernel chunk"):
        fg.fused_focus_value_and_grad(*targs, chunk_size=512, device="cpu", mesh=_mesh8())
    spec = targs[1]
    with pytest.raises(NotImplementedError):
        fg._stats_and_jacobian(np.zeros(fg.n_scalars(3), np.float32), None,
                               spec._replace(source_kind="extended"), 8192, device="cpu", mesh=_mesh8())


#: The body both sides of the two-process test run: ``results(mesh)`` traces
#: the port's flagship at 4096 rays (no JAX) through every sharded function.
COMMON = r"""
import numpy as np
import torch

torch.set_num_threads(1)
from attosecondraytracing_tpu_torch.analysis import alignment, stats
from attosecondraytracing_tpu_torch.models import masks, mirrors, supports
from attosecondraytracing_tpu_torch.models.detector import Detector
from attosecondraytracing_tpu_torch.models.placement import OEPlacement
from attosecondraytracing_tpu_torch.ops import fused_grad as fg
from attosecondraytracing_tpu_torch.ops import fused_scan as fs
from attosecondraytracing_tpu_torch.ops import fused_trace as ft
from attosecondraytracing_tpu_torch.parallel import mesh as pm

N = 4096


def results(mesh):
    R, r = mirrors.ReturnOptimalToroidalRadii(500.0, 80.0)
    tor = mirrors.MirrorToroidal(R, r, supports.SupportRectangle(150, 32))
    mask = masks.Mask(supports.SupportRoundHole(20, 7, 0, 0))
    props = {"Divergence": 25e-3, "SourceSize": 0, "Wavelength": 80e-6, "DeltaFT": 0.5,
             "NumberRays": N}
    chain = OEPlacement(props, [mask, tor, tor], [400, 100, 500], [0, 80, -80], [0, 0, 0]).to("cpu")
    info = chain.source_spec._replace(gaussian_edge=float(np.exp(-2.0)))
    spec = info.baked()
    els = chain.device_elements(torch.float64)
    probe = chain.trace_final(engine="trace")
    det = Detector(chain.optical_elements[-1].position)
    det.autoplace(probe, 495.0)
    rot = det._plane_rotation()
    xy = stats.detector_points_2d(probe, det.centre, det.normal, rot).double().numpy()[probe.alive.numpy()]
    extent = (xy.min(axis=0) * 1.1, xy.max(axis=0) * 1.1)
    out = {}
    st = pm.source_stats_sharded(spec, els, N, mesh, det.centre, det.normal, rot,
                                 distances=(-5.0, 0.0, 5.0), gaussian_edge=info.gaussian_edge)
    out.update({"stats_" + k: np.asarray(v) for k, v in st.items()})
    opl_ref, inv_dn = ft.chief_ray_refs(spec, els, det.centre, det.normal, device="cpu",
                                        dtype=torch.float32)
    sspec = fs.make_scan_spec("cone", els, N)
    svec = fs.scan_chain_scalars(els, np.asarray(spec.rot), np.asarray(spec.origin), det.centre,
                                 det.normal, rot)
    out["scan"] = pm.scan_moments_sharded(sspec, svec, N, mesh, opl_ref, inv_dn, radius=spec.radius,
                                          gaussian_edge=info.gaussian_edge)
    fn = fs.make_moments_fn(sspec, els, info, N, device="cpu")
    out["moments_fn"] = fn(det.centre, det.normal, rot, gaussian_edge=info.gaussian_edge)["moments"]
    out["w_img"], out["wd_img"] = pm.source_images_sharded(
        spec, els, N, mesh, det.centre, det.normal, rot, extent, bins=(32, 32), chunk=1024,
        gaussian_edge=info.gaussian_edge, opl_ref=opl_ref)
    lspec = fg.make_loss_spec(info, els, det.centre, det.normal, device="cpu")
    params = alignment.zero_params(3)
    params = params._replace(angles=params.angles.clone().index_fill_(0, torch.tensor([1]), 2e-4))
    loss, grads = fg.fused_focus_value_and_grad(params, lspec, els, np.asarray(spec.rot),
                                                np.asarray(spec.origin), det.centre, det.normal,
                                                rot, device="cpu", mesh=mesh)
    out["loss"] = np.float64(loss)
    out["grad_angles"], out["grad_shifts"] = grads.angles.numpy(), grads.shifts.numpy()
    traced = pm.trace_sharded(chain.source_rays, els, mesh)
    out["trace_p"], out["trace_alive"] = traced.p.numpy(), traced.alive.numpy()
    return out
"""

RANK = r"""
import os
import sys

import torch.distributed as dist

rank, world, store, path = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
os.environ["ART_TPU_SCAN_MESH"] = "1"
assert pm.distributed_init(backend="gloo", init_method="file://" + store, rank=rank,
                           world_size=world)
mesh = pm.make_mesh(devices=["cpu"], group=dist.group.WORLD)
assert mesh.shards == (rank,) and mesh.size == world
scan_mesh = fs._scan_mesh(fs.make_scan_spec("cone", [], N), N, device="cpu")
assert scan_mesh is not None and scan_mesh.size == world and scan_mesh.group is not None
out = results(mesh)
np.savez(path, **out)
dist.destroy_process_group()
"""


def test_two_process_gloo_matches_one_process_mesh(tmp_path, monkeypatch):
    """Two ranks on gloo (one shard each, a file:// store) against the
    one-process 2-shard mesh: every result bit for bit, each rank's trace
    its half of the one-process trace, and the scan engine's moments_fn
    sharded over the process group (ART_TPU_SCAN_MESH=1). A rank that fails
    or outlives its 240 s fails the test and is killed."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("ART_TPU_")}
    env.update(PYTHONPATH=ROOT + os.pathsep + env.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    store = tmp_path / "store"
    procs = [subprocess.Popen([sys.executable, "-c", COMMON + RANK, str(rank), "2", str(store),
                               str(tmp_path / f"rank{rank}.npz")],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for rank in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], "\n".join(logs)

    for name in [k for k in list(os.environ) if k.startswith("ART_TPU_")]:
        monkeypatch.delenv(name)
    ns = {}
    exec(COMMON, ns)
    one = ns["results"](pm.make_mesh(devices=["cpu"] * 2))
    per = one["trace_p"].shape[0] // 2
    for rank in range(2):
        got = np.load(tmp_path / f"rank{rank}.npz")
        for key, ref in one.items():
            if key.startswith("trace_"):
                ref = ref[rank * per:(rank + 1) * per]
            elif key == "moments_fn":
                ref = one["scan"]  # the same K5 pass sharded over the 2 ranks
            np.testing.assert_array_equal(got[key], ref, err_msg=f"rank {rank}: {key}")
