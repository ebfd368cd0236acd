"""Detector images of the port (``analysis/histogram.py``,
``Detector.get_Image`` / ``get_DelayMap``) against the JAX package's on the
same float64 bundle: a toroidal 2f-2f chain traced by the JAX package
(tests/test_histogram.py's), seeded intensities, carried across with
``interop``. Images and means within 1e-9, and against ``np.histogram2d``
(the JAX tests' bound, tests/test_histogram.py:45,82-84); gradients with
respect to the intensities within 1e-12 (:112-130)."""

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

from attosecondraytracing_tpu.analysis import histogram as jh  # noqa: E402
from attosecondraytracing_tpu.models import mirrors as mmirror  # noqa: E402
from attosecondraytracing_tpu.models import supports as msupp  # noqa: E402
from attosecondraytracing_tpu.models.detector import Detector as JDetector  # noqa: E402
from attosecondraytracing_tpu.models.placement import OEPlacement  # noqa: E402
from attosecondraytracing_tpu_torch import interop  # noqa: E402
from attosecondraytracing_tpu_torch.analysis import histogram as th  # noqa: E402
from attosecondraytracing_tpu_torch.models.detector import Detector  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def traced():
    """(JAX bundle, port bundle, JAX detector, port detector): 4000 rays of
    a toroidal 2f-2f chain 30 mm off focus, with seeded intensities."""
    focal, inc = 500.0, 80.0
    R, r = mmirror.ReturnOptimalToroidalRadii(focal, inc)
    mirror = mmirror.MirrorToroidal(R, r, msupp.SupportRectangle(300, 50))
    props = {"Divergence": 15e-3, "SourceSize": 0, "Wavelength": 50e-6, "DeltaFT": 1,
             "NumberRays": 4000}
    chain = OEPlacement(props, [mirror], [2 * focal], [inc])
    out = chain.get_output_rays()[-1]
    rng = np.random.default_rng(11)
    out = out._replace(intensity=jnp.asarray(rng.uniform(0.2, 1.0, out.n_rays)))
    jdet = JDetector(np.zeros(3))
    jdet.autoplace(out, 2 * focal - 30.0)
    bundle = interop.bundle_from_numpy(jax.tree.map(np.asarray, out), device="cpu",
                                       dtype=torch.float64)
    return out, bundle, jdet, Detector(jdet.refpoint, jdet.centre, jdet.normal)


def _weights(out):
    return np.asarray(out.alive, dtype=float) * np.asarray(out.intensity)


def test_detector_image_matches_jax_and_histogram2d(traced):
    out, bundle, jdet, det = traced
    ref, (jlo, jhi) = jdet.get_Image(out, bins=(64, 48))
    img, (lo, hi) = det.get_Image(bundle, bins=(64, 48))
    assert img.dtype == torch.float64 and img.shape == (64, 48)
    np.testing.assert_allclose(lo.numpy(), np.asarray(jlo), rtol=0, atol=1e-12)
    np.testing.assert_allclose(hi.numpy(), np.asarray(jhi), rtol=0, atol=1e-12)
    np.testing.assert_allclose(img.numpy(), np.asarray(ref), rtol=0, atol=1e-9)
    xy = det.get_PointList2D(bundle).numpy()
    w = _weights(out)
    lo, hi = lo.numpy(), hi.numpy()
    h2d, _, _ = np.histogram2d(xy[:, 0], xy[:, 1], bins=(64, 48),
                               range=[[lo[0], hi[0]], [lo[1], hi[1]]], weights=w)
    np.testing.assert_allclose(img.numpy(), h2d, rtol=0, atol=1e-9)
    assert float(img.sum()) == pytest.approx(w.sum(), rel=1e-12)  # the auto extent loses nothing


def test_fixed_extent_drops_points_outside(traced):
    out, bundle, jdet, det = traced
    lo, hi = np.array([-0.05, -0.05]), np.array([0.05, 0.05])
    ref, _ = jdet.get_Image(out, bins=(32, 32), extent=(lo, hi))
    img, (lo2, hi2) = det.get_Image(bundle, bins=(32, 32), extent=(lo, hi))
    np.testing.assert_allclose(lo2.numpy(), lo)
    np.testing.assert_allclose(hi2.numpy(), hi)
    np.testing.assert_allclose(img.numpy(), np.asarray(ref), rtol=0, atol=1e-9)
    xy = det.get_PointList2D(bundle).numpy()
    inside = ((xy >= lo) & (xy <= hi)).all(axis=1)
    assert 0 < inside.sum() < bundle.n_rays
    assert float(img.sum()) == pytest.approx(_weights(out)[inside].sum(), rel=1e-12)


def test_upper_edge_points_fall_in_the_last_bin():
    """_bin_indices of both packages on points at, inside and outside the
    window's edges: equal indices and masks; a point exactly on the upper
    edge counts in the last bin, as in np.histogram2d."""
    lo, hi = np.array([-1.0, 0.0]), np.array([1.0, 3.0])
    xy = np.array([[-1.0, 0.0], [1.0, 3.0], [1.0, 1.5], [0.999, 2.999], [-1.0001, 1.0],
                   [0.0, 3.0001], [0.25, 0.75], [1.5, -0.5]])
    bins = (8, 6)
    ix, iy, inside = th._bin_indices(torch.from_numpy(xy), torch.from_numpy(lo),
                                     torch.from_numpy(hi), bins)
    jix, jiy, jinside = jh._bin_indices(jnp.asarray(xy), jnp.asarray(lo), jnp.asarray(hi), bins)
    np.testing.assert_array_equal(ix.numpy(), np.asarray(jix))
    np.testing.assert_array_equal(iy.numpy(), np.asarray(jiy))
    np.testing.assert_array_equal(inside.numpy(), np.asarray(jinside))
    assert (ix[1].item(), iy[1].item(), bool(inside[1])) == (7, 5, True)
    w = np.arange(1.0, len(xy) + 1.0)
    (img,) = th.binned_sums(ix, iy, (torch.where(inside, torch.from_numpy(w), 0.0),), bins)
    h2d, _, _ = np.histogram2d(xy[:, 0], xy[:, 1], bins=bins, range=[[-1, 1], [0, 3]], weights=w)
    np.testing.assert_allclose(img.numpy(), h2d, rtol=0, atol=1e-12)


@pytest.mark.parametrize("weighted", [True, False])
def test_delay_map_matches_jax(traced, weighted):
    """get_DelayMap (and value_map under it): per-pixel weighted mean delays
    and weight images within 1e-9 of the JAX package's, NaN where a pixel
    has no weight, and against the per-pixel means of np.add.at."""
    out, bundle, jdet, det = traced
    jmean, jw, (jlo, jhi) = jdet.get_DelayMap(out, bins=(24, 24), intensity_weighted=weighted)
    mean, w_img, (lo, hi) = det.get_DelayMap(bundle, bins=(24, 24), intensity_weighted=weighted)
    jmean, mean = np.asarray(jmean), mean.numpy()
    np.testing.assert_array_equal(np.isnan(mean), np.isnan(jmean))
    occupied = ~np.isnan(mean)
    assert 20 < occupied.sum() < 24 * 24
    np.testing.assert_allclose(mean[occupied], jmean[occupied], rtol=0, atol=1e-9)
    np.testing.assert_allclose(w_img.numpy(), np.asarray(jw), rtol=0, atol=1e-9)
    xy = det.get_PointList2D(bundle).numpy()
    delays = det.get_Delays(bundle).numpy()
    w = _weights(out) if weighted else np.asarray(out.alive, dtype=float)
    lo, hi = lo.numpy(), hi.numpy()
    ix = np.clip(((xy[:, 0] - lo[0]) / (hi[0] - lo[0]) * 24).astype(int), 0, 23)
    iy = np.clip(((xy[:, 1] - lo[1]) / (hi[1] - lo[1]) * 24).astype(int), 0, 23)
    ref_w, ref_wd = np.zeros((24, 24)), np.zeros((24, 24))
    np.add.at(ref_w, (ix, iy), w)
    np.add.at(ref_wd, (ix, iy), w * delays)
    np.testing.assert_allclose(mean[occupied], ref_wd[occupied] / ref_w[occupied], rtol=0, atol=1e-9)


def test_image_gradient_matches_jax(traced):
    """d(weighted pixel sum)/d(intensities) through detector_image, against
    jax.grad of the JAX package's: within 1e-12 (and alive x in-window)."""
    out, bundle, jdet, det = traced
    lo, hi = np.array([-1.0, -1.0]), np.array([1.0, 1.0])
    rot = jdet._plane_rotation()
    pix = np.random.default_rng(5).uniform(size=(8, 8))

    def jmass(intensity):
        img, _ = jh.detector_image(out._replace(intensity=intensity), jdet.centre, jdet.normal,
                                   rot, bins=(8, 8), extent=(lo, hi))
        return jnp.sum(img * pix)

    jgrad = np.asarray(jax.grad(jmass)(out.intensity))
    intensity = bundle.intensity.clone().requires_grad_(True)
    img, _ = th.detector_image(bundle._replace(intensity=intensity), det.centre, det.normal, rot,
                               bins=(8, 8), extent=(lo, hi))
    (img * torch.from_numpy(pix)).sum().backward()
    np.testing.assert_allclose(intensity.grad.numpy(), jgrad, rtol=0, atol=1e-12)
    inside = (np.abs(det.get_PointList2D(bundle).numpy()) <= 1.0).all(axis=1)
    assert (np.abs(jgrad) > 0).sum() == (np.asarray(out.alive) & inside).sum() > 100


def test_binned_sums_dtype_and_precision():
    """Images come back in the dtype of their columns (float32 columns are
    summed in float64), and the JAX ``precision`` argument is accepted."""
    ix = torch.tensor([0, 1, 1, 2], dtype=torch.int32)
    iy = torch.tensor([2, 0, 0, 1], dtype=torch.int32)
    col = torch.tensor([1.0, 2.0, 3.0, 1e8], dtype=torch.float32)
    a, b = th.binned_sums(ix, iy, (col, 2 * col), (3, 3), precision="highest")
    assert a.dtype == b.dtype == torch.float32 and a.shape == (3, 3)
    assert a[1, 0].item() == 5.0 and a[2, 1].item() == 1e8 and b[0, 2].item() == 2.0
