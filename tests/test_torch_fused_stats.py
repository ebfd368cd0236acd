"""PyTorch port vs the JAX package: the per-distance stats pass (kernel K8)
and the host arithmetic around kernels K2 and K8.

* ``fused_source_stats`` on the CPU (K8's plain version) at 1, 8, 9, 20 and
  128 distances against the JAX package's ``pallas_source_detector_stats``
  (its moments kernel in interpret mode), on the flagship of
  tests/test_stats_kernel.py at 8192 rays with Gaussian weights.
* K8's per-block row layout (blocks, J, 7) and ``stats_from_rows``, in numpy.
* ``ray_grid`` at K2's and K8's rays per block (read from ``csrc/``) on the
  cone, extended and square chunk laws.
* What the K8 wrapper refuses.

Tolerances: tests/test_stats_kernel.py's envelopes (sum of weights rel 1e-5,
spot SD rel 2e-3, duration SD 2.5 % or 0.8 fs in quadrature: the float32
delay noise of both packages' traces)."""

import re
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

from attosecondraytracing_tpu.ops import pallas_trace as jpt  # noqa: E402
from attosecondraytracing_tpu_torch import interop  # noqa: E402
from attosecondraytracing_tpu_torch.ops import _cuda  # noqa: E402
from attosecondraytracing_tpu_torch.ops import fused_trace as ft  # noqa: E402
from test_gradients import _grad_setup  # noqa: E402
from test_torch_fused_scan import _block_rays  # noqa: E402

torch.set_num_threads(1)

N = 8192
EDGE = float(np.exp(-2.0))


@pytest.fixture(scope="module")
def flagship():
    """The flagship of tests/test_stats_kernel.py in both packages, its
    detector 10 mm short of the focus."""
    from attosecondraytracing_tpu.models.detector import Detector

    elements = _grad_setup(16)[2]
    spec = jpt.make_source_spec("cone", np.zeros(3), np.array([1.0, 0, 0]), 25e-3)
    det = Detector(np.zeros(3))
    det.autoplace(jpt.pallas_trace_source(spec, elements, N), 490.0)
    tels = interop.elements_from_numpy(jax.tree.map(np.asarray, elements), device="cpu",
                                       dtype=torch.float64)
    return {"spec": spec, "elements": elements, "det": det, "tels": tels,
            "tspec": interop.source_spec_from_numpy(spec)}


def _distances(J):
    return (0.0,) if J == 1 else tuple(float(d) for d in np.linspace(-10, 10, J))


@pytest.mark.parametrize("J", [1, 8, 9, 20, 128])
def test_source_stats_matches_jax_stats(flagship, J):
    """K8's wrapper on the CPU at J distances (a tile edge of the kernel, one
    past it, the bench's 20, the JAX kernel's maximum) against the JAX
    package's per-distance statistics."""
    fl, dist = flagship, _distances(J)
    det = fl["det"]
    ref = jpt.pallas_source_detector_stats(fl["spec"], fl["elements"], N, det.centre, det.normal,
                                           det._plane_rotation(), distances=dist,
                                           gaussian_edge=EDGE)
    opl_ref, offsets, inv_dn = jpt.chief_ray_refs(fl["spec"], fl["elements"], det.centre,
                                                  det.normal, dist)
    tdet = ft.bake_detector(fl["tels"], det.centre, det.normal, det._plane_rotation(),
                            opl_ref=opl_ref, inv_dn_chief=inv_dn, distances=dist,
                            delay_offsets=offsets)
    ft.fused_source_stats.launches = 0
    sums = ft.fused_source_stats(ft.chain_table(fl["tspec"], fl["tels"]), fl["tspec"], tdet,
                                 [(N, 0.0, 0.0)], N, device="cpu", gaussian_edge=EDGE)
    assert sums.shape == (7, J) and sums.dtype == np.float64
    assert ft.fused_source_stats.launches == 0  # the plain version launched nothing
    got = ft.sums_to_stats(dict(zip(ft.STATS_FIELDS, sums)), opl_ref, dist)
    np.testing.assert_allclose(got["sum_w"], np.asarray(ref["sum_w"]), rtol=1e-5)
    np.testing.assert_allclose(got["spot_sd"], np.asarray(ref["spot_sd"]), rtol=2e-3, atol=1e-6)
    for k, r in zip(got["duration_sd"], np.asarray(ref["duration_sd"], np.float64)):
        assert abs(k - r) <= 0.025 * r or abs(k * k - r * r) ** 0.5 <= 0.8, (k, r)


@pytest.mark.parametrize("J", [1, 9, 128])
def test_stats_rows_layout_round_trip(J):
    """K8 writes one row of J x 7 float64 sums per block, distance-major
    (csrc/fused_trace.cu: row[(j0 + t) * 7 + f]), whatever J is against the
    kernel's tile of distances; ``stats_from_rows`` sums the blocks into (7,
    J) in STATS_FIELDS order."""
    rng = np.random.default_rng(J)
    n_blocks = 37
    sums = rng.normal(size=(7, J)) * 10.0 ** rng.integers(-3, 6, size=(7, 1))
    share = rng.dirichlet(np.ones(n_blocks))
    flat = np.zeros((n_blocks, J * 7))
    for b in range(n_blocks):
        for j in range(J):
            for f in range(7):
                flat[b, j * 7 + f] = share[b] * sums[f, j]
    rows = torch.from_numpy(flat).view(n_blocks, J, 7)
    got = ft.stats_from_rows(rows)
    assert got.shape == (7, J) and got.dtype == np.float64
    np.testing.assert_allclose(got, sums, rtol=1e-12, atol=0)


def _rays_per_block(kernel):
    """K2's or K8's rays per block, from the constants of ``csrc/``."""
    def const(name, fname):
        m = re.search(rf"constexpr int {name} = (\d+);", (_cuda.CSRC / fname).read_text())
        assert m, name
        return int(m.group(1))

    return const("MOMENT_THREADS", "trace_common.cuh") * const(f"{kernel}_RAYS_PER_THREAD",
                                                               "fused_trace.cu")


@pytest.mark.parametrize("kernel", ["K2", "K8"])
@pytest.mark.parametrize("kind,extra", [("cone", {"n": 10_000_000}),
                                        ("extended", {"n_each": 333, "n_sources": 30011}),
                                        ("square", {"n_each": 3163})])
def test_ray_grid_of_source_kernels(kernel, kind, extra):
    """The grid K2 and K8 launch, at their own rays per block, on each chunk
    law at ~1e7 rays: every block starts with at least one ray and the blocks
    in order cover every ray of every chunk exactly once."""
    rpb = _rays_per_block(kernel)
    assert rpb % 256 == 0 and 1024 <= rpb <= 8192
    n_each, n_sources = extra.get("n_each", 0), extra.get("n_sources", 0)
    n = {"cone": extra.get("n"), "extended": n_each * n_sources, "square": n_each * n_each}[kind]
    sizes = [c[0] for c in ft.source_chunks(kind, n, n, n_each=n_each, n_sources=n_sources)]
    assert len(sizes) == 2 and sum(sizes) == n
    bpc, n_blocks = ft.ray_grid(sizes, rpb)
    ranges = _block_rays(sizes, rpb)
    assert ranges.shape == (n_blocks, 2) and n_blocks < 2 * bpc
    assert np.all(ranges[:, 1] > ranges[:, 0])  # no block starts without rays
    assert np.all(ranges[:, 1] - ranges[:, 0] <= rpb)
    assert ranges[0, 0] == 0 and ranges[-1, 1] == n
    np.testing.assert_array_equal(ranges[1:, 0], ranges[:-1, 1])  # contiguous, no overlap


@pytest.mark.parametrize("case", ["no distances", "offsets", "too many", "chunks", "long chain"])
def test_source_stats_refuses(flagship, case):
    """What K8's wrapper refuses, on the CPU and (before it allocates or
    launches anything) for a CUDA device."""
    fl = flagship
    table = ft.chain_table(fl["tspec"], fl["tels"])
    det = ft.BakedDetector((0.0, 0.0, -100.0), (0.0, 0.0, 1.0), (1.0, 0.0, 0.0), (0.0, 1.0, 0.0), 0.0, 1.0)
    chunks = [(N, 0.0, 0.0)]
    error = ValueError
    if case == "no distances":
        det = det._replace(distances=(), delay_offsets=())
    elif case == "offsets":
        det = det._replace(distances=(0.0, 1.0), delay_offsets=(0.0,))
    elif case == "too many":
        det = det._replace(distances=(0.0,) * 129, delay_offsets=(0.0,) * 129)
    elif case == "chunks":
        chunks = [(1000, 0.0, 0.0), (N - 1000, 0.0, 0.0)]  # a short chunk before the last
    else:
        table = table._replace(elements=table.elements * 5, maps=table.maps * 5,
                               premasks=table.premasks * 5)
        error = NotImplementedError
    for device in ("cpu", "cuda") if case != "long chain" else ("cuda",):
        with pytest.raises(error):
            ft.fused_source_stats(table, fl["tspec"], det, chunks, N, device=device)
