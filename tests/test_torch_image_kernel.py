"""Kernel K1i, the giga-ray image in one launch (``ops/fused_trace.
prepare_fused_source_image``), on the CPU, where its plain version
(``fused_source_image_ref``) runs: the chunk
table and grid its wrapper packs for the card (the launch captured), its
plain version's per-ray record against the bundle path's binning
(``stats.detector_points_3d``, ``histogram._bin_indices``) and against the
JAX package's per-chunk binning on the same rays, and the record's chunk
range. The kernel itself runs only on the card (``chip_smoke.py``, phase
images)."""

import contextlib
import sys

# tests/reference_shims.py leaves stand-in modules in sys.modules whose
# attributes are stubs; importing torch runs inspect.getmodule over them, so
# they are set aside while torch imports (as in tests/test_torch_gigascan.py).
_stubs = {name: mod for name, mod in list(sys.modules.items())
          if not isinstance(getattr(mod, "__file__", None), (str, type(None)))}
for _name in _stubs:
    del sys.modules[_name]
import torch  # noqa: E402

sys.modules.update(_stubs)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from attosecondraytracing_tpu.analysis import gigascan as jgs  # noqa: E402
from attosecondraytracing_tpu.ops.bundle import RayBundle as JRayBundle  # noqa: E402
from attosecondraytracing_tpu_torch.analysis import gigascan as gs  # noqa: E402
from attosecondraytracing_tpu_torch.analysis import histogram, stats  # noqa: E402
from attosecondraytracing_tpu_torch.models import masks, mirrors, sources, supports  # noqa: E402
from attosecondraytracing_tpu_torch.models.detector import Detector  # noqa: E402
from attosecondraytracing_tpu_torch.models.placement import OEPlacement  # noqa: E402
from attosecondraytracing_tpu_torch.ops import _cuda  # noqa: E402
from attosecondraytracing_tpu_torch.ops import fused_trace as ft  # noqa: E402
from attosecondraytracing_tpu_torch.ops.geometry import kahan_add  # noqa: E402
from attosecondraytracing_tpu_torch.ops.precision import LIGHT_SPEED_MM_S  # noqa: E402

torch.set_num_threads(1)

N = 6000
BINS = (48, 40)


def _chain(kind):
    """A chain with a ``kind`` source (cone, disk, extended, square) at N
    rays, its elements on the CPU and a detector 400 mm behind it."""
    tor = mirrors.MirrorToroidal(*mirrors.ReturnOptimalToroidalRadii(500.0, 80.0),
                                 supports.SupportRectangle(150, 32))
    if kind == "square":
        par = mirrors.MirrorParabolic(100, 90, supports.SupportRoundHole(30, 5, 10, 5))
        props = {"Divergence": 0, "SourceSize": 50, "Wavelength": 800e-6, "NumberRays": 64}
        chain = OEPlacement(props, [par], [200], [0.0])
        bundle, spec = sources.PlaneWaveSquareFused(np.zeros(3), np.array([1.0, 0.0, 0.0]), 40.0, N,
                                                    Wavelength=800e-6, gaussian_edge=float(np.exp(-2.0)))
        from attosecondraytracing_tpu_torch.models.chain import OpticalChain

        chain = OpticalChain(bundle, chain.optical_elements, source_spec=spec)
    else:
        mask = masks.Mask(supports.SupportRoundHole(20, 3, 0, 0))
        props = {"Divergence": 10e-3 if kind != "disk" else 0, "Wavelength": 80e-6, "NumberRays": N,
                 "SourceSize": {"cone": 0, "disk": 8.0, "extended": 0.4}[kind]}
        chain = OEPlacement(props, [mask, tor, tor], [400, 100, 500], [0, 80, -80], [0, 0, 0])
    chain.to("cpu")
    assert chain.source_spec.baked().kind == kind
    det = Detector(chain.optical_elements[-1].position)
    det.autoplace(chain.trace_final(engine="trace"), 400.0)
    return chain, det


@pytest.fixture(scope="module")
def cone():
    return _chain("cone")


def _image_detector(det, opl_ref):
    rot = det._plane_rotation()
    return ft.ImageDetector(tuple(det.centre), tuple(det.normal), tuple(map(tuple, rot[:2])), opl_ref)


@pytest.mark.parametrize("kind", ["cone", "disk", "extended", "square"])
def test_chunk_table_is_the_chunk_law(kind, monkeypatch):
    """The wrapper's chunk table (captured at the launch, the card stubbed)
    holds every chunk's (phase, k_frac) of ``source_chunks`` as float32, in
    order, on a grid sized to the chunks' rays at K1i's rays per block; the
    extended and square sources' chunks cover whole sub-sources and rows."""
    chain, det = _chain(kind)
    spec = chain.source_spec
    baked = spec.baked()
    chunk = 1000
    launched = []

    def launch(chain_rec, src_rec, image_rec, n_rays, size, grid, params, images, record, stream,
               grids=()):
        launched.append((n_rays, size, grid, params.clone(), record, src_rec))

    monkeypatch.setattr(ft, "_cuda_device", lambda device, name: torch.device(device))
    monkeypatch.setattr(_cuda, "source_image_rays_per_block", lambda: 256)
    monkeypatch.setattr(_cuda, "launch_fused_source_image", launch)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: type("S", (), {"cuda_stream": 0}))
    ft.prepare_fused_source_image.launches = 0
    n_total = baked.n_sources * baked.n_each if kind == "extended" else N
    gs._images_k1i(spec, chain.device_elements(), det, n_total, BINS, None, chunk, True,
                   torch.device("cpu"))
    assert ft.prepare_fused_source_image.launches == 1 and len(launched) == 1
    n_rays, size, grid, params, record, src_rec = launched[0]
    law = ft.source_chunks(kind, n_total, n_total, chunk, n_each=baked.n_each,
                           n_sources=baked.n_sources)
    assert len(law) >= 4 and n_rays == n_total == sum(n for n, _p, _k in law) and size == law[0][0]
    np.testing.assert_array_equal(params.numpy(), np.array([[p, k] for _n, p, k in law], np.float32))
    assert grid == ft.ray_grid([n for n, _p, _k in law], 256) and record is None
    assert bool(src_rec["weighted"]) == (spec.gaussian_edge is not None)
    if kind in ("extended", "square"):
        assert all(n % baked.n_each == 0 for n, _p, _k in law[:-1]) and 1 < baked.n_each < chunk


def _zero_images():
    return tuple(torch.zeros(BINS[0] * BINS[1], dtype=torch.float64) for _ in range(2))


def _bundle_path_images(out, weights, det, opl_ref, window, bins):
    """The images of one traced chunk binned as the bundle path bins (the
    form of the image loop before K1i): stats.detector_points_3d and
    plane_coords, the Kahan delay, histogram._bin_indices and index_add_
    over every ray, zero weight where dead or outside."""
    centre, normal, rot = (torch.as_tensor(v, dtype=torch.float32)
                           for v in (det.centre, det.normal, det._plane_rotation()))
    pts3, t = stats.detector_points_3d(out, centre, normal)
    xy = stats.plane_coords(pts3, centre, rot)
    s, c = kahan_add(out.opl, out.opl_c, t)
    delay = ((s - torch.tensor(opl_ref, dtype=torch.float32)) - c) * (1e15 / LIGHT_SPEED_MM_S)
    lo, hi = (torch.as_tensor(v, dtype=torch.float32) for v in window)
    ix, iy, inside = histogram._bin_indices(xy, lo, hi, bins)
    wv = torch.where(out.alive & inside, weights, 0.0)
    images = tuple(torch.zeros(bins[0] * bins[1], dtype=torch.float64) for _ in range(2))
    histogram.bin_add(images, histogram._flat_index(ix, iy, bins), (wv, wv * delay))
    return images


def test_record_binned_equals_the_bundle_path(cone):
    """K1i's per-ray record in its plain form (flat pixel or -1, weight,
    delay) summed by index_add_ equals, bit for bit, the images of the same
    traced chunk binned through the bundle path's functions; every alive
    ray inside the window counts and no other."""
    chain, det = cone
    baked = chain.source_spec.baked()
    els = chain.device_elements()
    table = ft.chain_table(baked, els)
    out = ft.fused_source_trace_ref(table, baked, N, device="cpu")
    w = ft.source_weights(baked, N, N, 0.0, 0.0, chain.source_spec.gaussian_edge, "cpu")
    xy = stats.detector_points_2d(out, *(torch.as_tensor(v, dtype=torch.float32) for v in
                                         (det.centre, det.normal, det._plane_rotation())))
    lo, hi = xy[out.alive].min(0).values.numpy(), xy[out.alive].max(0).values.numpy()
    window = (lo + 0.3 * (hi - lo), hi)  # a window that cuts the beam
    opl_ref = float(out.opl[out.alive][0]) + 400.0
    rec = ft.pack_image(_image_detector(det, opl_ref), window, BINS)
    flat, wr, delay = ft.image_rays_ref(out, w, rec)
    images = tuple(torch.zeros(BINS[0] * BINS[1], dtype=torch.float64) for _ in range(2))
    ft.bin_image_rays(images, flat, wr, delay)
    ref = _bundle_path_images(out, w, det, opl_ref, window, BINS)
    for img, r in zip(images, ref):
        np.testing.assert_array_equal(img.numpy(), r.numpy())
    counted = flat >= 0
    assert 200 < int(counted.sum()) < int(out.alive.sum())
    assert not bool((counted & ~out.alive).any()) and bool((delay[~counted] == 0).all())
    assert torch.equal(wr, w) and flat.dtype == torch.int32
    assert int(flat.max()) < BINS[0] * BINS[1]


def test_record_binning_matches_jax_on_the_same_rays():
    """The plain per-ray epilogue against the JAX package's per-chunk
    binning (``analysis/gigascan._chunk_binned_sums``, float32 one-hot
    matmuls at full precision on the CPU) on the same rays, made with numpy
    from a seed: rays headed through a tilted plane, 10 % dead. The images
    agree within float32 summation but for rays that land on a pixel edge
    (XLA's matmul may round the in-plane coordinate otherwise): at most 2
    rays move, and the mean delays of the pixels agree within two float32
    ulps of the 40 mm path (XLA's dot products may round the leg t
    otherwise: the largest difference reads 1.1 ulps)."""
    rng = np.random.default_rng(5)
    n = 4096
    normal = np.array([0.1, 0.2, 1.0]) / np.linalg.norm([0.1, 0.2, 1.0])
    centre = np.array([100.0, 2.0, -3.0])
    det = Detector(np.zeros(3))
    det.centre, det.normal = centre, normal
    rot = det._plane_rotation()
    d = normal + rng.normal(0.0, 2e-3, (n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    p = centre + rng.normal(0.0, 0.05, (n, 3)) - 40.0 * d
    opl = rng.uniform(0.0, 1e-3, n)
    opl_c = rng.normal(0.0, 1e-5, n)
    alive = rng.uniform(size=n) > 0.1
    w = rng.uniform(0.2, 1.0, n)
    f32 = np.float32
    out = ft.TraceOutputs(*(torch.from_numpy(np.ascontiguousarray(v, f32)) for v in (p, d, opl, opl_c)),
                          alive=torch.from_numpy(alive), incidence=torch.zeros(n))
    window = (np.array([-0.12, -0.1]), np.array([0.1, 0.13]))
    bins = (16, 20)
    opl_ref = 40.0
    rec = ft.pack_image(ft.ImageDetector(tuple(centre), tuple(normal), tuple(map(tuple, rot[:2])),
                                         opl_ref), window, bins)
    images = tuple(torch.zeros(bins[0] * bins[1], dtype=torch.float64) for _ in range(2))
    ft.bin_image_rays(images, *ft.image_rays_ref(out, torch.from_numpy(w.astype(f32)), rec))
    port_w, port_wd = (img.numpy().reshape(bins) for img in images)
    jb = JRayBundle(p=jnp.asarray(p, f32), d=jnp.asarray(d, f32), opl=jnp.asarray(opl, f32),
                    opl_c=jnp.asarray(opl_c, f32), alive=jnp.asarray(alive),
                    intensity=jnp.ones(n, f32), incidence=jnp.zeros(n, f32), wavelength=jnp.float32(1e-4))
    jw, jwd = (np.asarray(v, np.float64) for v in jgs._chunk_binned_sums(
        jb, jnp.asarray(w, f32), jnp.asarray(centre, f32), jnp.asarray(normal, f32),
        jnp.asarray(rot, f32), jnp.asarray(window[0], f32), jnp.asarray(window[1], f32),
        jnp.float32(opl_ref), bins))
    assert port_w.sum() > 0.5 * w[alive].sum()
    assert port_w.sum() == pytest.approx(jw.sum(), rel=2 * 1e-6 + 2 * w.max() / port_w.sum())
    assert np.abs(port_w - jw).sum() <= 2 * 2 * w.max() + 1e-4 * port_w.sum()
    both = (port_w > 0.5) & (np.abs(port_w - jw) < 1e-4 * port_w)
    assert both.sum() > 100
    ulp_fs = float(np.spacing(np.float32(opl_ref))) * 1e15 / LIGHT_SPEED_MM_S
    diffs = np.abs(port_wd[both] / port_w[both] - jwd[both] / jw[both])
    assert diffs.max() < 2 * ulp_fs, (diffs.max(), ulp_fs)


def test_record_holds_its_chunk_range(cone):
    """The plain version of K1i writes the record of chunks first .. first
    + n_chunks - 1 (ray k of chunk first + c at c * chunk + k) and adds
    every chunk into the images: the record's chunks (the last one short,
    its tail left at -1) equal each chunk's own epilogue, and the images
    equal the image loop's."""
    chain, det = cone
    spec = chain.source_spec
    baked = spec.baked()
    els = chain.device_elements()
    table = ft.chain_table(baked, els)
    chunk = 1024
    chunks = ft.source_chunks(baked.kind, N, N, chunk)
    assert len(chunks) == 6 and chunks[-1][0] < chunk
    res = gs.fused_source_images(spec, els, det, n_total=N, bins=BINS, chunk=chunk)
    opl_ref, _ = ft.chief_ray_refs(baked, els, det.centre, det.normal, device="cpu",
                                   dtype=torch.float32)
    idet = _image_detector(det, opl_ref)
    record = ft.image_record(3, 3, chunk, device="cpu")
    images = _zero_images()
    ft.fused_source_image_ref(table, baked, chunks, N, idet, res["extent"], BINS, images, device="cpu",
                              gaussian_edge=spec.gaussian_edge, record=record)
    np.testing.assert_array_equal(images[0].reshape(BINS).numpy(), res["weight_image"])
    assert float(images[0].sum()) == pytest.approx(res["sum_w"], rel=1e-12)
    rec = ft.pack_image(idet, res["extent"], BINS)
    for c in (3, 4, 5):
        n_local, phase, k_frac = chunks[c]
        out = ft.fused_source_trace_ref(table, baked, n_local, device="cpu", phase=phase,
                                        k_frac=k_frac, n_total=N)
        w = ft.source_weights(baked, n_local, N, phase, k_frac, spec.gaussian_edge, "cpu")
        at = (c - 3) * chunk
        for got, want in zip(record[2:], ft.image_rays_ref(out, w, rec)):
            assert torch.equal(got[at:at + n_local], want)
    assert bool((record.flat[2 * chunk + chunks[-1][0]:] == -1).all())
    assert int((record.flat >= 0).sum()) > 100


def test_image_arguments_are_checked(cone):
    """The wrapper refuses what the kernel cannot take: more than 2^31 rays,
    chunks whose sizes do not add up to the total, unequal chunks, a
    record of the wrong size."""
    chain, det = cone
    baked = chain.source_spec.baked()
    table = ft.chain_table(baked, chain.device_elements())
    idet = _image_detector(det, 1000.0)
    window = (np.array([-1.0, -1.0]), np.array([1.0, 1.0]))
    big = ft.source_chunks("cone", 3 << 30, 3 << 30)
    for chunks, n_total in ((big, 3 << 30), (ft.source_chunks("cone", 100, 100, 64), 99),
                            ([(64, 0.0, 0.0), (32, 0.1, 0.5), (64, 0.2, 0.7)], 160)):
        with pytest.raises(ValueError):
            ft.fused_source_image_ref(table, baked, chunks, n_total, idet, window, BINS, _zero_images(),
                                      device="cpu")
    with pytest.raises(ValueError):
        ft.prepare_fused_source_image(table, baked, ft.source_chunks("cone", 100, 100), 100, idet,
                                      window, BINS, device="cpu")


def test_image_record_layout_matches_the_kernel():
    """IMAGE_T mirrors ``ImageP`` of csrc/fused_trace.cu: 18 floats, then two
    ints (80 bytes); the window scale is PyTorch's ``bins / (hi - lo)`` of
    float32 values (the rounded reciprocal times the bins)."""
    assert ft.IMAGE_T.itemsize == 80 and ft.IMAGE_T.fields["nx"][1] == 72
    text = (_cuda.CSRC / "fused_trace.cu").read_text()
    assert "struct ImageP {\n  float c[3], n[3];\n  float rot[6];" in text
    rec = ft.pack_image(ft.ImageDetector((0.0,) * 3, (0.0, 0.0, 1.0), ((1.0, 0, 0), (0, 1.0, 0)), 1.0),
                        (np.array([0.1, -0.3]), np.array([0.7, 0.2])), (512, 300))
    lo, hi = torch.tensor([0.1, -0.3]), torch.tensor([0.7, 0.2])
    assert float(rec["scale"][0]) == float(512 / (hi[0] - lo[0]))
    assert float(rec["scale"][1]) == float(300 / (hi[1] - lo[1]))
