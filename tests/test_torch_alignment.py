"""PyTorch port vs the JAX package: gradient-based alignment
(``analysis/alignment.py``).

* ``apply_params`` perturbs poses as JAX does (float64, rel 1e-12).
* ``focus_loss`` and its ``torch.autograd`` gradient against
  ``jax.value_and_grad`` in float64 on the rolled parabola of
  tests/test_gradients.py:16-37 (loss rel 1e-9, gradients within 1e-6 of
  their largest entry: the same float64 arithmetic, reverse mode in both,
  summed in another order), and against central finite differences.
* ``gradient_align`` realigns that parabola through the autograd engine,
  and descends on the 2-toroid chain of tests/test_gradients.py:195-219
  through the fused engine (kernel K6's plain version on the CPU)."""

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

from attosecondraytracing_tpu.analysis import alignment as jal  # noqa: E402
from attosecondraytracing_tpu_torch import interop  # noqa: E402
from attosecondraytracing_tpu_torch.analysis import alignment as tal  # noqa: E402
from attosecondraytracing_tpu_torch.models import chain as tchain  # noqa: E402
from test_gradients import _chain_and_detector  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _no_stub_modules():
    """Set tests/reference_shims.py's stub modules aside while this module's
    tests run: torch.func looks modules up through inspect on its first
    transforms, which fails on the stubs (see the top of this file)."""
    with pytest.MonkeyPatch.context() as mp:
        for name, mod in list(sys.modules.items()):
            if not isinstance(getattr(mod, "__file__", None), (str, type(None))):
                mp.delitem(sys.modules, name)
        yield


def _params(rng, n_elements, scale=1.0):
    angles = rng.normal(scale=1e-4 * scale, size=(n_elements, 3))
    shifts = rng.normal(scale=1e-2 * scale, size=(n_elements, 3))
    return angles, shifts


def _port_problem(chain, det):
    """The JAX chain's float64 source and elements, and its detector, as the
    port's."""
    tels = interop.elements_from_numpy(jax.tree.map(np.asarray, chain.device_elements()),
                                       device="cpu", dtype=torch.float64)
    src = interop.bundle_from_numpy(jax.tree.map(np.asarray, chain.source_rays), device="cpu",
                                    dtype=torch.float64)
    return src, tels, (det.centre, det.normal, det._plane_rotation())


def test_apply_params_matches_jax(rng):
    """The perturbed poses of the flagship's three elements (mask and two
    toroids) in float64."""
    from test_gradients import _grad_setup

    args = _grad_setup(16)
    elements = [e._replace(rot=jnp.asarray(e.rot, jnp.float64),
                           position=jnp.asarray(e.position, jnp.float64)) for e in args[2]]
    angles, shifts = _params(rng, 3, scale=100.0)
    ref = jal.apply_params(elements, jal.AlignmentParams(jnp.asarray(angles), jnp.asarray(shifts)))
    tels = interop.elements_from_numpy(jax.tree.map(np.asarray, elements), device="cpu",
                                       dtype=torch.float64)
    got = tal.apply_params(tels, tal.AlignmentParams(torch.tensor(angles), torch.tensor(shifts)))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.rot.numpy(), np.asarray(r.rot), rtol=1e-12, atol=1e-15)
        np.testing.assert_allclose(g.position.numpy(), np.asarray(r.position), rtol=1e-12)
    zero = tal.zero_params(3)
    assert zero.angles.dtype == torch.float32 and zero.shifts.shape == (3, 3)
    same = tal.apply_params(tels, zero)
    assert all(torch.equal(s.position, t.position) for s, t in zip(same, tels))


def test_focus_loss_and_grad_match_jax(rng):
    """focus_loss and its autograd gradient against jax.value_and_grad on the
    rolled parabola, float64, with the survival and duration terms on."""
    chain, det = _chain_and_detector(misalign_roll_deg=0.05)
    elements = chain.device_elements()
    centre, normal, rot = det.centre, det.normal, det._plane_rotation()
    angles, shifts = _params(rng, 1)
    kw = dict(duration_weight=0.5, survival_weight=1.0)
    loss_j, g_j = jax.value_and_grad(jal.focus_loss)(
        jal.AlignmentParams(jnp.asarray(angles), jnp.asarray(shifts)), chain.source_rays, elements,
        jnp.asarray(centre), jnp.asarray(normal), jnp.asarray(rot), **kw)
    src, tels, geo = _port_problem(chain, det)
    p = tal.AlignmentParams(torch.tensor(angles, requires_grad=True), torch.tensor(shifts, requires_grad=True))
    loss_t = tal.focus_loss(p, src, tels, *geo, **kw)
    loss_t.backward()
    assert float(loss_t) == pytest.approx(float(loss_j), rel=1e-9)
    for got, ref in ((p.angles.grad, g_j.angles), (p.shifts.grad, g_j.shifts)):
        got, ref = got.numpy(), np.asarray(ref)
        assert np.all(np.isfinite(got))
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * np.abs(ref).max())


def test_focus_loss_gradient_matches_finite_difference():
    """tests/test_gradients.py:40-62 on the port: central differences of the
    float64 loss against the autograd gradient, per angle and shift."""
    chain, det = _chain_and_detector(misalign_roll_deg=0.05)
    src, tels, geo = _port_problem(chain, det)

    def loss(angles, shifts):
        return tal.focus_loss(tal.AlignmentParams(angles, shifts), src, tels, *geo)

    angles = torch.zeros((1, 3), dtype=torch.float64, requires_grad=True)
    shifts = torch.zeros((1, 3), dtype=torch.float64, requires_grad=True)
    loss(angles, shifts).backward()
    eps = 1e-7
    for which, grad in ((0, angles.grad), (1, shifts.grad)):
        for j in range(3):
            delta = torch.zeros((1, 3), dtype=torch.float64)
            delta[0, j] = eps
            base = [angles.detach(), shifts.detach()]
            plus, minus = list(base), list(base)
            plus[which] = base[which] + delta
            minus[which] = base[which] - delta
            fd = (float(loss(*plus)) - float(loss(*minus))) / (2 * eps)
            np.testing.assert_allclose(float(grad[0, j]), fd, rtol=5e-3, atol=1e-10)


def test_alignment_step_descends():
    """One plain SGD step along the autograd gradient lowers the loss."""
    chain, det = _chain_and_detector(misalign_roll_deg=0.1)
    src, tels, geo = _port_problem(chain, det)
    params = tal.zero_params(1, dtype=torch.float64)
    new, loss0 = tal.alignment_step(params, 1e-6, src, tels, *geo)
    _, loss1 = tal.alignment_step(new, 1e-6, src, tels, *geo)
    assert float(loss1) < float(loss0)
    assert not new.angles.requires_grad


def test_gradient_align_autograd_realigns_rolled_parabola(monkeypatch):
    """tests/test_gradients.py:65-75 through the port's autograd engine
    (chosen by "auto" below PALLAS_MIN_RAYS): the loss falls by 20x."""
    monkeypatch.setenv("ART_TPU_DTYPE", "float64")
    from attosecondraytracing_tpu_torch.models.detector import Detector
    from attosecondraytracing_tpu_torch.models import mirrors, supports
    from attosecondraytracing_tpu_torch.models.placement import OEPlacement

    parabola = mirrors.MirrorParabolic(100, 90, supports.SupportRound(12))
    props = {"Divergence": 0, "SourceSize": 20, "Wavelength": 50e-6, "DeltaFT": 1, "NumberRays": 400}
    chain = OEPlacement(props, [parabola], [200], [0.0]).to("cpu")
    det = Detector(chain.optical_elements[0].position)
    det.autoplace(chain.trace_final(), 100.0)
    chain.optical_elements[0].rotate_roll_by(0.1)
    params, history = tal.gradient_align(chain, det, iters=60, lr=2e-3)
    assert tal.gradient_align.last_engine == "autograd"
    assert history[-1] < 0.05 * history[0], history
    assert params.angles.shape == (1, 3) and params.angles.dtype == torch.float32
    with pytest.raises(ValueError):
        tal.gradient_align(chain, det, iters=1, engine="xla")


def test_gradient_align_fused_descends(monkeypatch, capsys):
    """tests/test_gradients.py:195-219 through the port's fused engine
    (kernel K6's plain version on the CPU): two toroids, the first rolled
    0.3 deg, 12 Adam steps; "auto" takes the same engine at
    PALLAS_MIN_RAYS, and verbose prints the JAX package's lines."""
    from attosecondraytracing_tpu_torch.models.detector import Detector
    from attosecondraytracing_tpu_torch.models import mirrors, supports
    from attosecondraytracing_tpu_torch.models.placement import OEPlacement
    from attosecondraytracing_tpu_torch.ops import fused_grad as fg

    R, r = mirrors.ReturnOptimalToroidalRadii(500.0, 80.0)
    tor = mirrors.MirrorToroidal(R, r, supports.SupportRectangle(150, 32))
    props = {"Divergence": 25e-3, "SourceSize": 0, "Wavelength": 80e-6, "DeltaFT": 0.5,
             "NumberRays": 2048}
    chain = OEPlacement(props, [tor, tor], [500, 600], [80.0, -80.0], [0, 0]).to("cpu")
    chain.rotate_OE(0, "roll", 0.3)
    det = Detector(chain.optical_elements[-1].position)
    det.autoplace(chain.trace_final(engine="trace"), 500.0)
    fg.fused_stats_params.launches = 0
    params, history = tal.gradient_align(chain, det, iters=12, lr=2e-4, engine="fused",
                                         survival_weight=0.1, verbose=True)
    assert tal.gradient_align.last_engine == "torch-grad"
    assert fg.fused_stats_params.launches == 0  # plain version on the CPU
    assert history[-1] < 0.9 * history[0], history
    assert np.all(np.isfinite(params.angles.numpy()))
    assert "align iter 0: loss" in capsys.readouterr().out
    monkeypatch.setattr(tchain, "PALLAS_MIN_RAYS", 1024)
    assert chain.fused_eligible()
    _, again = tal.gradient_align(chain, det, iters=1, lr=2e-4, survival_weight=0.1)
    assert tal.gradient_align.last_engine == "torch-grad"
    assert again[0] == pytest.approx(history[0], rel=1e-12)
