"""The benchmark's frozen reference optics against the JAX package on the
CPU, in float64, at 8192 rays: the placement, the Gaussian source, and the
traced bundle of the flagship and of the flagship with test Zernike terms
on its first toroid; and its Zernike sum against the JAX package's
recurrence."""

import json

import jax
import numpy as np
import pytest
import torch

from cells_small import ROOT

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import attosecondraytracing_tpu as jart  # noqa: E402
from attosecondraytracing_tpu.ops import zernike as jzernike  # noqa: E402

from benchmark import sources  # noqa: E402
from benchmark.defects import zernike  # noqa: E402
from benchmark.reference import optics as op  # noqa: E402

N_RAYS = 8192


#: Zernike terms (n, m, coefficient [mm]) put on the first toroid to test the
#: reference's deformed-mirror branch; test values, not a deployment's
TEST_ZERNIKE = [[2, 0, 2e-4], [3, 1, -1e-4], [4, 2, 5e-5], [6, 3, 2e-5]]


def _config(name):
    if name == "fxf_flagship_test_zernike":
        cfg = _config("fxf_flagship")
        cfg["optics"][1]["zernike"] = TEST_ZERNIKE
        return cfg
    return json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())


def _jax_chain(cfg, second):
    def support(spec):
        if spec["kind"] == "round_hole":
            return jart.supports.SupportRoundHole(
                Radius=spec["Radius"], RadiusHole=spec["RadiusHole"],
                CenterHoleX=spec["CenterHoleX"], CenterHoleY=spec["CenterHoleY"])
        return jart.supports.SupportRectangle(spec["dimX"], spec["dimY"])

    optics = []
    for spec in cfg["optics"]:
        if spec["kind"] == "mask":
            optics.append(jart.masks.Mask(support(spec["support"])))
            continue
        optic = jart.mirrors.MirrorToroidal(
            *jart.mirrors.ReturnOptimalToroidalRadii(spec["focal"], spec["incidence"]),
            support(spec["support"]))
        if spec.get("zernike"):
            terms = {(n, m): c for n, m, c in spec["zernike"]}
            zernike = jart.defects.Zernike(support(spec["support"]), terms)
            optic = jart.mirrors.DeformedMirror(optic, [zernike])
        optics.append(optic)
    props = dict(cfg["source"], NumberRays=N_RAYS)
    distances = list(cfg["distances_mm"][:-1]) + [second]
    return jart.OEPlacement(props, optics, distances, cfg["incidence_deg"],
                            cfg["incidence_plane_deg"], "")


@pytest.mark.parametrize("second", [350.0, 650.0])
@pytest.mark.parametrize("name", ["fxf_flagship", "fxf_flagship_test_zernike"])
def test_reference_matches_jax_package(name, second, monkeypatch):
    monkeypatch.setenv("ART_TPU_DTYPE", "float64")
    cfg = _config(name)
    chain = _jax_chain(cfg, second)
    out = chain.get_output_rays()[-1]

    f64 = dict(dtype=torch.float64, device="cpu")
    optics = op.optics_from_config(cfg)
    distances = list(cfg["distances_mm"][:-1]) + [second]
    poses = op.place(optics, distances, cfg["incidence_deg"], cfg["incidence_plane_deg"], **f64)
    for el, pose in zip(chain.optical_elements, poses):
        np.testing.assert_allclose(pose.position.numpy(), el.position, atol=1e-9)
        np.testing.assert_allclose(pose.normal.numpy(), el.normal, atol=1e-12)
        np.testing.assert_allclose(pose.major.numpy(), el.majoraxis, atol=1e-12)

    source = sources.of(cfg)
    src = source.rays(0, N_RAYS, N_RAYS, **f64)
    d0 = np.stack([c.numpy() for c in src.d], -1)
    np.testing.assert_allclose(d0, np.asarray(chain.source_rays.d), atol=1e-12)
    w = source.bundle_weights(src).numpy()
    np.testing.assert_allclose(w, np.asarray(chain.source_rays.intensity), rtol=1e-9)

    ref = op.trace(src, optics, poses)
    alive = np.asarray(out.alive)
    np.testing.assert_array_equal(ref.alive.numpy(), alive)
    assert 0.4 < alive.mean() < 0.6
    p = np.stack([c.numpy() for c in ref.p], -1)[alive]
    d = np.stack([c.numpy() for c in ref.d], -1)[alive]
    np.testing.assert_allclose(p, np.asarray(out.p)[alive], atol=1e-7)
    np.testing.assert_allclose(d, np.asarray(out.d)[alive], atol=1e-10)
    path = np.asarray(out.opl)[alive] - np.asarray(out.opl_c)[alive]
    np.testing.assert_allclose(ref.opl.numpy()[alive], path, atol=1e-8)


def test_zernike_sum_matches_jax_recurrence():
    rng = np.random.default_rng(3)
    r = np.sqrt(rng.uniform(0, 1, 4096))
    t = rng.uniform(0, 2 * np.pi, 4096)
    x, y = r * np.cos(t), r * np.sin(t)
    Z, _, _ = jzernike.zernike_value_and_grad(x, y, 8)
    for n in range(2, 9):
        for m in range(n + 1):
            got = zernike.zernike_height(((n, m, 1.0),), torch.as_tensor(x), torch.as_tensor(y))
            np.testing.assert_allclose(got.numpy(), np.asarray(Z[(n, m)]), atol=1e-12,
                                       err_msg=f"Z({n},{m})")
