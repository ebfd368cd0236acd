"""The pose vector's tangent rows in closed form (``ops/fused_grad.
scalar_jacobian`` / ``scalar_tangents``), the rows kernel K6 takes in every
fused alignment step.

* The closed form against ``torch.func.jacfwd`` of the differentiable
  ``chain_scalars(apply_params(...))`` (tests/torch_pose_oracle.py) in
  float64, before the float32
  rounding: within 1e-12 of each parameter's largest entry, on the f-x-f
  flagship, its Zernike- and grid-deformed twins, the one-element deformed
  parabola of ``CONFIG_deformed.py`` and a five-element chain with a mask
  inside, at zero parameters, at random ones up to 1e-2 rad and 1 mm, and
  at angles near 0.3 rad (the sine and cosine terms of the partials).
* ``gradient_align``'s fused engine takes the closed form once per Adam step
  and enters no ``torch.func.jacfwd``; its steps agree with the same steps
  on a ``jacfwd`` oracle within float32 noise. The host side of a fused step
  (everything but K6) enters no ``torch.func`` transform at all."""

import sys

# tests/reference_shims.py leaves stand-in modules in sys.modules whose
# attributes are stubs; importing torch runs inspect.getmodule over them, so
# they are set aside while torch imports (as in tests/test_torch_k7_record.py).
_stubs = {name: mod for name, mod in list(sys.modules.items())
          if not isinstance(getattr(mod, "__file__", None), (str, type(None)))}
for _name in _stubs:
    del sys.modules[_name]
import torch  # noqa: E402

sys.modules.update(_stubs)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from attosecondraytracing_tpu_torch.analysis import alignment as al  # noqa: E402
from attosecondraytracing_tpu_torch.ops import fused_grad as fg  # noqa: E402
from attosecondraytracing_tpu_torch.utils import kernel_ab as ab  # noqa: E402
from torch_pose_oracle import chain_scalars  # noqa: E402

torch.set_num_threads(1)

CHAINS = ("flat", "zernike", "grid", "deformed_parabola", "five")
PARAMS = ("zero", "small", "large")


@pytest.fixture(autouse=True, scope="module")
def _no_stub_modules():
    """Set tests/reference_shims.py's stub modules aside while this module's
    tests run: torch.func (the oracle) looks modules up through inspect on
    its first transforms, which fails on the stubs (see the top of this
    file)."""
    with pytest.MonkeyPatch.context() as mp:
        for name, mod in list(sys.modules.items()):
            if not isinstance(getattr(mod, "__file__", None), (str, type(None))):
                mp.delitem(sys.modules, name)
        yield


def _placed(optics, distances, incidence, planes, props):
    """Host float64 element records of an ``OEPlacement`` chain and its
    source frame (rotation, origin)."""
    from attosecondraytracing_tpu_torch.models.placement import OEPlacement

    chain = OEPlacement(props, optics, distances, incidence, planes)
    info = chain.source_spec
    return ([e.to_device("cpu", torch.float64) for e in chain.optical_elements],
            np.asarray(info.baked().rot, np.float64), np.asarray(info.origin, np.float64))


def _chain(name):
    """The host elements of chain ``name`` and a pose problem's geometry:
    its source frame and a tilted detector plane (centre, normal, rows of
    its rotation) 300 mm past the last element."""
    from attosecondraytracing_tpu_torch.models import defects, masks, mirrors, supports

    if name in ("flat", "zernike", "grid"):
        host, spec = ab.flagship(16, name)
        src = (np.asarray(spec.rot, np.float64), np.asarray(spec.origin, np.float64))
    elif name == "deformed_parabola":
        support = supports.SupportRectangle(40, 40)
        mirror = mirrors.DeformedMirror(mirrors.MirrorParabolic(25.4, 0, support),
                                        [defects.Fourrier(support, RMS=1e-1, smallest=1.0, seed=12345)])
        props = {"Divergence": 0, "SourceSize": 100, "Wavelength": 800e-6, "DeltaFT": 0,
                 "NumberRays": 16}
        host, *src = _placed([mirror], [15], [0], [0], props)
    else:
        R, r = mirrors.ReturnOptimalToroidalRadii(500.0, 80.0)
        tor = mirrors.MirrorToroidal(R, r, supports.SupportRectangle(150, 32))
        mask = masks.Mask(supports.SupportRoundHole(Radius=20, RadiusHole=7, CenterHoleX=0,
                                                    CenterHoleY=0))
        plane = mirrors.MirrorPlane(supports.SupportRectangle(60, 30))
        sphere = mirrors.MirrorSpherical(800.0, supports.SupportRound(25))
        props = {"Divergence": 25e-3, "SourceSize": 0, "Wavelength": 80e-6, "NumberRays": 16}
        host, *src = _placed([tor, mask, tor, plane, sphere], [400.0, 200.0, 300.0, 300.0, 200.0],
                             [80.0, 0.0, -80.0, 45.0, 10.0], [0.0, 0.0, 0.0, 90.0, 30.0], props)
    last = np.asarray(host[-1].position, np.float64)
    c, s = np.cos(0.2), np.sin(0.2)
    det_rot = np.array([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]]) @ np.array(
        [[0.0, 1.0, 0.0], [0.0, 0.0, 1.0], [1.0, 0.0, 0.0]])
    geo = (*src, last + 300.0 * det_rot[2], det_rot[2], det_rot)
    return host, geo


def _params(kind, n_elements, seed):
    rng = np.random.default_rng(seed)
    if kind == "zero":
        return al.zero_params(n_elements, dtype=torch.float64)
    shifts = rng.uniform(-1.0, 1.0, (n_elements, 3))
    if kind == "small":
        angles = rng.uniform(-1e-2, 1e-2, (n_elements, 3))
    else:
        angles = rng.choice([-1.0, 1.0], (n_elements, 3)) * rng.uniform(0.28, 0.32, (n_elements, 3))
    return al.AlignmentParams(torch.tensor(angles), torch.tensor(shifts))


def _jacfwd_rows(host, params, *geo):
    """The oracle: ``torch.func.jacfwd`` of ``params -> chain_scalars(
    apply_params(host, params))`` in float64, as (6K, n_scalars) rows
    (angles row-major, then shifts)."""
    K = len(host)
    flat = torch.cat([torch.as_tensor(params.angles, dtype=torch.float64).reshape(-1),
                      torch.as_tensor(params.shifts, dtype=torch.float64).reshape(-1)])

    def scal(fp):
        p = al.AlignmentParams(angles=fp[:3 * K].reshape(K, 3), shifts=fp[3 * K:].reshape(K, 3))
        return chain_scalars(al.apply_params(host, p), *geo)

    return torch.func.jacfwd(scal)(flat).T.numpy()


@pytest.mark.parametrize("params_kind", PARAMS)
@pytest.mark.parametrize("chain", CHAINS)
def test_closed_form_matches_jacfwd(chain, params_kind):
    """Every parameter's row of the closed form equals the oracle's within
    1e-12 of that row's largest entry (float64 round-off: the two sum the
    same products in other orders); ``scalar_tangents`` is its float32
    rounding, done once, and counts one evaluation."""
    host, geo = _chain(chain)
    K = len(host)
    params = _params(params_kind, K, seed=CHAINS.index(chain))
    ref = _jacfwd_rows(host, params, *geo)
    got = fg.scalar_jacobian(host, params, *geo)
    assert got.shape == ref.shape == (6 * K, fg.n_scalars(K)) and got.dtype == np.float64
    scale = np.abs(ref).max(axis=1)
    assert np.all(scale > 0)
    err = np.abs(got - ref).max(axis=1)
    assert np.all(err <= 1e-12 * scale), (err / scale).max()
    calls = fg.scalar_tangents.calls
    rows = fg.scalar_tangents(host, params, *geo)
    assert fg.scalar_tangents.calls == calls + 1
    assert rows.dtype == np.float32 and np.array_equal(rows, got.astype(np.float32))


def _align_problem():
    """The align cell's use on the f-x-f flagship at 2048 rays: chain placed
    at 500 mm, detector autoplaced at 500 mm, the first toroid rolled 0.05
    deg and pitched 0.02 deg."""
    from attosecondraytracing_tpu_torch.models import masks, mirrors, supports
    from attosecondraytracing_tpu_torch.models.detector import Detector
    from attosecondraytracing_tpu_torch.models.placement import OEPlacement

    R, r = mirrors.ReturnOptimalToroidalRadii(500.0, 80.0)
    tor = mirrors.MirrorToroidal(R, r, supports.SupportRectangle(150, 32))
    mask = masks.Mask(supports.SupportRoundHole(Radius=20, RadiusHole=7, CenterHoleX=0, CenterHoleY=0))
    props = {"Divergence": 25e-3, "SourceSize": 0, "Wavelength": 80e-6, "DeltaFT": 0.5,
             "NumberRays": 2048}
    chain = OEPlacement(props, [mask, tor, tor], [400.0, 100.0, 500.0], [0.0, 80.0, -80.0],
                        [0.0, 0.0, 0.0]).to("cpu")
    det = Detector(chain.optical_elements[-1].position)
    det.autoplace(chain.trace_final(engine="trace"), 500.0)
    chain.rotate_OE(1, "roll", 0.05)
    chain.rotate_OE(1, "pitch", 0.02)
    return chain, det


def test_gradient_align_takes_the_closed_form_once_a_step(monkeypatch):
    """Three Adam steps of the fused engine (K6's plain version on the CPU)
    with ``torch.func.jacfwd`` made to raise: ``scalar_tangents.calls`` rises
    by exactly three. The same steps with ``scalar_tangents`` swapped for the
    ``jacfwd`` oracle (rounded to float32 as the rows are) give the same loss
    history and final parameters within float32 noise."""
    chain, det = _align_problem()
    steps = 3

    def run():
        params, history = al.gradient_align(chain, det, iters=steps, lr=2e-5, engine="fused")
        assert al.gradient_align.last_engine == "torch-grad"
        return np.concatenate([params.angles.numpy().ravel(), params.shifts.numpy().ravel()]), history

    def refuse(*args, **kwargs):
        raise AssertionError("torch.func.jacfwd entered on the fused alignment path")

    calls = fg.scalar_tangents.calls
    with monkeypatch.context() as mp:
        mp.setattr(torch.func, "jacfwd", refuse)
        got_params, got_history = run()
    assert fg.scalar_tangents.calls == calls + steps

    def oracle(host, params, *geo):
        return _jacfwd_rows(host, params, *geo).astype(np.float32)

    monkeypatch.setattr(fg, "scalar_tangents", oracle)
    ref_params, ref_history = run()
    assert fg.scalar_tangents is oracle
    np.testing.assert_allclose(got_history, ref_history, rtol=1e-6)
    # Adam moves each parameter by up to lr a step: float32 noise on that
    assert np.all(np.abs(got_params - ref_params) <= 1e-6 * 2e-5 * steps + 1e-7 * np.abs(ref_params))


def test_fused_step_host_side_enters_no_torch_func(monkeypatch):
    """One fused step's host work (the pose vector, its tangent rows, the
    loss and its gradient) with every ``torch.func`` transform made to raise
    and the K6 sums stood in for: the step completes, takes one closed-form
    evaluation, and its gradient is the stand-in's contraction."""
    chain, det = _align_problem()
    host = [e.to_device("cpu", torch.float64) for e in chain.optical_elements]
    info = chain.source_spec
    spec = fg.make_loss_spec(info, chain.device_elements(), det.centre, det.normal, device="cpu")
    geo = (np.asarray(info.baked().rot, np.float64), np.asarray(info.origin, np.float64),
           det.centre, det.normal, det._plane_rotation())
    sums = np.array([2000.0, 1.0, -2.0, 5.0, 7.0, 0.5, 3.0])
    seen = {}

    def stand_in(sprimal, stangents, spec, chunk_size, *, device, mesh=None):
        seen["rows"] = stangents
        return sums, np.arange(stangents.shape[0] * 7, dtype=np.float64).reshape(-1, 7)

    def refuse(*args, **kwargs):
        raise AssertionError("a torch.func transform entered on a fused step's host side")

    monkeypatch.setattr(fg, "_stats_and_jacobian", stand_in)
    for name in ("jacfwd", "jacrev", "jvp", "vjp", "vmap", "grad", "grad_and_value", "hessian",
                 "linearize"):
        monkeypatch.setattr(torch.func, name, refuse)
    params = al.zero_params(3)
    params.angles[1, 0] = 2e-4
    calls = fg.scalar_tangents.calls
    loss, grads = fg.fused_focus_value_and_grad(params, spec, host, *geo, device="cpu")
    assert fg.scalar_tangents.calls == calls + 1
    assert seen["rows"].shape == (18, fg.n_scalars(3)) and seen["rows"].dtype == np.float32
    _, dloss = fg._loss_from_stats(sums, spec, fg._total_weight(spec))
    want = np.arange(18 * 7, dtype=np.float64).reshape(-1, 7) @ dloss
    got = np.concatenate([grads.angles.numpy().ravel(), grads.shifts.numpy().ravel()])
    np.testing.assert_array_equal(got, want.astype(np.float32))
    assert np.isfinite(loss)
