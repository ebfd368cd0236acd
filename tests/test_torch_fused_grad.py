"""PyTorch port vs the JAX package: the fused alignment-gradient engine and
the per-distance stats pass.

* The pose vector (``chain_scalars`` of tests/torch_pose_oracle.py) and its
  tangent rows against JAX's ``chain_scalars`` / ``jax.jacfwd`` under x64.
* The plain version of kernels K6/K7 (``stats_params_ref``) against the
  Pallas kernels ``_kernel_stats_jvp`` / ``_kernel_stats_primal`` in
  interpret mode, and ``fused_focus_value_and_grad`` against JAX's, on the
  misaligned flagship of tests/test_gradients.py (``_grad_setup``, 8192
  rays). The JAX gradient runs once per module: its three kernel passes are
  recorded as it runs and serve the kernel-level comparison too.
* The plain version of kernel K8 (``fused_source_stats_ref``) against
  ``_pallas_source_stats_padded`` in interpret mode and against the port's
  moments path.

Tolerances: the sum of weights rel 1e-5; the spatial sums (wx, wy, wxx,
wyy) within 1e-4 of their scales (sqrt(w wxx), sqrt(w wyy), wxx, wyy): the
two packages' float32 traces differ per ray by ~1e-5 mm (the K1 envelope of
tests/test_torch_fused_trace.py), which moves these sums by up to 3e-5 of
their scale; the delay sums through the duration SD they give, within
tests/test_stats_kernel.py's envelope (2.5 % or 0.8 fs in quadrature: the
float32 delay noise); tangents within 2e-3 of the
largest tangent of their statistic (the chunked-vs-single envelope of
tests/test_gradients.py:274-278); loss rel 2e-3 and gradients within the
envelope of tests/test_gradients.py:188-192 (the port's loss is evaluated in
float64, JAX's in float32)."""

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
import jax.flatten_util  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from attosecondraytracing_tpu.analysis import alignment as jal  # noqa: E402
from attosecondraytracing_tpu.ops import pallas_grad as jpg  # noqa: E402
from attosecondraytracing_tpu.ops import pallas_trace as jpt  # noqa: E402
from attosecondraytracing_tpu_torch import interop  # noqa: E402
from attosecondraytracing_tpu_torch.ops import fused_grad as fg  # noqa: E402
from attosecondraytracing_tpu_torch.ops import fused_trace as ft  # noqa: E402
from test_gradients import _grad_setup  # noqa: E402
from torch_pose_oracle import chain_scalars  # noqa: E402

torch.set_num_threads(1)

N = 8192


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


def _port_args(args):
    """The port's counterparts of ``_grad_setup``'s arguments."""
    params, spec, elements, src_rot, src_origin, det_c, det_n, det_rot = args
    tels = interop.elements_from_numpy(jax.tree.map(np.asarray, elements), device="cpu",
                                       dtype=torch.float64)
    tspec = fg.FusedLossSpec(
        source_kind=spec.source_kind, source_radius=spec.source_radius,
        elements=tuple(tels), opl_ref=spec.opl_ref, gaussian_edge=spec.gaussian_edge,
        n_rays=spec.n_rays, duration_weight=spec.duration_weight,
        survival_weight=spec.survival_weight, pos_radius=spec.pos_radius, n_each=spec.n_each,
        n_sources=spec.n_sources)
    tparams = interop.alignment_params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    return tparams, tspec, tels, src_rot, src_origin, det_c, det_n, det_rot


@pytest.fixture(scope="module")
def jax_grad():
    """JAX's fused gradient on the flagship (3 K6 passes in interpret mode,
    each pass's inputs and output recorded, and the inputs and output of the
    _stats_and_jacobian that groups them), its primal-only pass, and the
    port's arguments."""
    args = _grad_setup(N)
    passes, jacobians = [], []
    kernel, grouped = jpg._stats_params_padded, jpg._stats_and_jacobian

    def spy(sprimal, stangents, chunk, *rest):
        out = kernel(sprimal, stangents, chunk, *rest)
        passes.append((np.asarray(sprimal), np.asarray(stangents), np.asarray(out, np.float64)))
        return out

    def spy_grouped(sprimal, stangents, *rest, **kw):
        p_stats, t_stats = grouped(sprimal, stangents, *rest, **kw)
        jacobians.append((np.asarray(sprimal), np.asarray(stangents), np.asarray(p_stats, np.float64),
                          np.asarray(t_stats, np.float64)))
        return p_stats, t_stats

    jpg._stats_params_padded, jpg._stats_and_jacobian = spy, spy_grouped
    try:
        loss, grads = jpg.fused_focus_value_and_grad(*args)
        primal_loss = float(jpg.fused_focus_loss(*args))
    finally:
        jpg._stats_params_padded, jpg._stats_and_jacobian = kernel, grouped
    return {"args": args, "port": _port_args(args), "loss": float(loss), "grads": grads,
            "passes": passes, "jacobians": jacobians, "primal_loss": primal_loss}


def test_chain_scalars_and_tangents_match_jax(jax_grad):
    """chain_scalars (torch float64) equals JAX's under x64, and the float32
    tangent rows equal the float32 rounding of JAX's float64 jacfwd within
    1 ulp of float32 (entries that are zero analytically: within float64
    round-off)."""
    params, _spec, elements, src_rot, src_origin, det_c, det_n, det_rot = jax_grad["args"]
    tparams, _tspec, tels, *_ = jax_grad["port"]
    el64 = [e._replace(rot=jnp.asarray(e.rot, jnp.float64), position=jnp.asarray(e.position, jnp.float64))
            for e in elements]
    p64 = jax.tree.map(lambda x: jnp.asarray(x, jnp.float64), params)
    flat, unravel = jax.flatten_util.ravel_pytree(p64)
    geo = (src_rot, src_origin, det_c, det_n, det_rot)
    with jax.default_matmul_precision("highest"):
        ref_t = np.asarray(jax.jacfwd(lambda fp: jnp.concatenate(
            [jnp.ravel(m) for m in _jax_scalars64(el64, unravel(fp), geo)]))(flat)).T
    got_t = fg.scalar_tangents(tels, tparams, *geo)
    assert got_t.shape == ref_t.shape == (18, fg.n_scalars(3)) and got_t.dtype == np.float32
    # 1 ulp of float32, plus float64 round-off (1e-15 of the largest entry)
    # where an entry is zero analytically
    ulp = np.spacing(np.abs(ref_t).astype(np.float32)) + 1e-15 * np.abs(ref_t).max()
    assert np.all(np.abs(got_t.astype(np.float64) - ref_t) <= ulp)

    from attosecondraytracing_tpu_torch.analysis.alignment import apply_params

    got = chain_scalars(apply_params(tels, tparams), *geo).numpy()
    ref = np.concatenate([np.ravel(m) for m in _jax_scalars64(el64, p64, geo)])
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)
    # its float32 rounding is the primal pose vector of the kernels
    primal = fg.chain_scalars_np(fg._apply_params_np(tels, tparams), *geo)
    ulp32 = np.spacing(np.abs(primal)) + 1e-15 * np.abs(ref).max()
    assert np.all(np.abs(got.astype(np.float32) - primal) <= ulp32)


def _jax_scalars64(elements, params, geo):
    """JAX's chain_scalars composition in float64 (its own function casts
    the result to float32)."""
    src_rot, src_origin, det_c, det_n, det_rot = geo
    pert = jal.apply_params(elements, params)
    rots = [el.rot for el in pert]
    poss = [el.position for el in pert]
    cens = [jnp.asarray(el.centre) if hasattr(el, "centre") else jnp.zeros(3) for el in pert]
    maps, (R_K, pos_K) = jpg.compose_chain_jnp(rots, poss, cens)
    M0, _ = maps[0]
    maps[0] = (M0 @ jnp.asarray(src_rot), M0 @ (jnp.asarray(src_origin) - poss[0]) + cens[0])
    parts = [x for M, b in maps for x in (M, b)]
    rot = jnp.asarray(det_rot)
    return parts + [R_K @ (jnp.asarray(det_c) - pos_K), R_K @ jnp.asarray(det_n), R_K @ rot[0],
                    R_K @ rot[1]]


def _assert_sums_close(got, ref, opl_ref):
    w, _, _, wxx, wyy, _, _ = ref
    assert abs(got[0] - w) <= 1e-5 * w
    scale = np.array([np.sqrt(w * wxx), np.sqrt(w * wyy), wxx, wyy])
    assert np.all(np.abs(got[1:5] - ref[1:5]) <= 1e-4 * scale), (got, ref)
    dur_got = _stats(got[:, None], opl_ref, (0.0,))["duration_sd"][0]
    dur_ref = _stats(ref[:, None], opl_ref, (0.0,))["duration_sd"][0]
    assert abs(dur_got - dur_ref) <= 0.025 * dur_ref or abs(dur_got**2 - dur_ref**2) ** 0.5 <= 0.8


@pytest.mark.parametrize("group", [0, 1, 2])
def test_stats_params_ref_matches_pallas_k6(jax_grad, group):
    """K6's plain version against _kernel_stats_jvp (interpret mode), group
    by group on the same float32 pose vector and tangent rows: the primal
    sums within the module's tolerances, tangents within 2e-3 of their
    statistic's largest tangent."""
    _, tspec, *_ = jax_grad["port"]
    svec, tang, out = jax_grad["passes"][group]
    assert tang.shape == (jpg.TANGENT_BATCH, fg.n_scalars(3))
    p, t = fg.stats_params_ref(tspec, svec, tang, [(N, 0.0, 0.0)], device="cpu")
    _assert_sums_close(p, out[:7], tspec.opl_ref)
    ref_t = out[7:].reshape(jpg.TANGENT_BATCH, 7)
    scale = np.maximum(np.abs(ref_t).max(axis=0), 1e-12)
    assert np.all(np.abs(t - ref_t) <= 2e-3 * scale), (t, ref_t)
    assert np.all(t[:, 0] == 0.0)  # the weights do not depend on the poses


def test_stats_params_ref_primal_matches_pallas_k7(jax_grad):
    """K7's plain version (no tangents) against _kernel_stats_primal: the
    sums of JAX's primal-only pass within the module's tolerances, JAX's
    fused_focus_loss equals the port's within the loss tolerance, and K7's
    sums equal K6's primal."""
    tparams, tspec, tels, *geo = jax_grad["port"]
    loss = fg.fused_focus_loss(tparams, tspec, tels, *geo, device="cpu")
    assert loss == pytest.approx(jax_grad["primal_loss"], rel=2e-3)
    svec7, _, out7 = jax_grad["passes"][3]  # fused_focus_loss's primal-only pass
    p7, t7 = fg.stats_params_ref(tspec, svec7, None, [(N, 0.0, 0.0)], device="cpu")
    assert t7.shape == (0, 7) and out7.shape == (7,)
    _assert_sums_close(p7, out7, tspec.opl_ref)
    svec, tang, _ = jax_grad["passes"][0]
    p0, _ = fg.stats_params_ref(tspec, svec, None, [(N, 0.0, 0.0)], device="cpu")
    p6, _ = fg.stats_params_ref(tspec, svec, tang, [(N, 0.0, 0.0)], device="cpu")
    np.testing.assert_allclose(p0, p6, rtol=1e-12)


def test_fused_value_and_grad_matches_jax(jax_grad):
    """fused_focus_value_and_grad (plain K6 on the CPU) against JAX's on the
    misaligned flagship: loss rel 2e-3, gradients within
    tests/test_gradients.py:188-192's envelope; no kernel launch on the
    CPU."""
    fg.fused_stats_params.launches = fg.fused_stats_params.primal_launches = 0
    loss, grads = fg.fused_focus_value_and_grad(*jax_grad["port"], device="cpu")
    assert fg.fused_stats_params.launches == 0 and fg.fused_stats_params.primal_launches == 0
    assert loss == pytest.approx(jax_grad["loss"], rel=2e-3)
    for got, ref in ((grads.angles, jax_grad["grads"].angles), (grads.shifts, jax_grad["grads"].shifts)):
        got, ref = got.numpy(), np.asarray(ref)
        assert got.dtype == np.float32 and np.all(np.isfinite(got))
        scale = max(np.abs(ref).max(), 1e-12)
        np.testing.assert_allclose(got, ref, atol=2e-2 * scale, rtol=2e-2)


def test_fused_grad_chunk_law(jax_grad):
    """Chunks of 2048 rays by the (phase, k_frac) law cover the same global
    spiral as one pass (tests/test_gradients.py:263-278): loss rel 1e-4,
    gradients within 2e-3 of their largest entry."""
    port = jax_grad["port"]
    loss_1, grads_1 = fg.fused_focus_value_and_grad(*port, device="cpu")
    loss_c, grads_c = fg.fused_focus_value_and_grad(*port, chunk_size=2048, device="cpu")
    assert loss_c == pytest.approx(loss_1, rel=1e-4)
    for g_c, g_1 in zip(grads_c, grads_1):
        g_c, g_1 = g_c.numpy(), g_1.numpy()
        scale = max(np.abs(g_1).max(), 1e-12)
        np.testing.assert_allclose(g_c, g_1, atol=2e-3 * scale, rtol=2e-3)
    assert [c[0] for c in fg._ray_chunks(port[1], 2048)] == [2048] * 4


def test_stats_params_wrapper_refusals(jax_grad):
    """The wrapper runs the plain version on the CPU; what K6/K7 do not take
    raises before anything is copied: more tangent rows than the chain has
    pose parameters (one launch takes all of them, 18 here), a pose vector
    of the wrong length, a chain past the kernels' table."""
    _, tspec, *_ = jax_grad["port"]
    svec, tang, _ = jax_grad["passes"][0]
    chunks = [(N, 0.0, 0.0)]
    assert fg.n_params(3) == 18
    with pytest.raises(ValueError):
        fg.fused_stats_params(tspec, svec, np.zeros((19, svec.size), np.float32), chunks, device="cpu")
    with pytest.raises(ValueError):
        fg.fused_stats_params(tspec, svec[:-1], tang, chunks, device="cpu")
    long_spec = tspec._replace(elements=tspec.elements * 3)
    with pytest.raises(NotImplementedError):
        fg.fused_stats_params(long_spec, np.zeros(fg.n_scalars(9), np.float32), None, chunks,
                              device="cuda")


def test_all_tangent_rows_in_one_call_match_jax_stats_and_jacobian(jax_grad):
    """All P = 18 tangent rows of the flagship step in one fused_stats_params
    call (the plain version on the CPU, as one K6 launch takes them on the
    card) against JAX's _stats_and_jacobian on the same float32 pose vector
    and rows, grouped by its TANGENT_BATCH = 6 and run in interpret mode:
    the primal sums within the module's tolerances, every tangent row within
    2e-3 of its statistic's largest tangent."""
    _, tspec, *_ = jax_grad["port"]
    (sprimal, stangents, p_ref, t_ref), = jax_grad["jacobians"]
    assert stangents.shape == (fg.n_params(3), fg.n_scalars(3)) and t_ref.shape == (18, 7)
    assert len(jax_grad["passes"]) - 1 == -(-18 // jpg.TANGENT_BATCH)  # JAX: 3 passes, port: 1
    p, t = fg.fused_stats_params(tspec, sprimal, stangents, fg._ray_chunks(tspec, fg.GRAD_CHUNK),
                                 device="cpu")
    assert t.shape == (18, 7)
    _assert_sums_close(p, p_ref, tspec.opl_ref)
    scale = np.maximum(np.abs(t_ref).max(axis=0), 1e-12)
    assert np.all(np.abs(t - t_ref) <= 2e-3 * scale), (t, t_ref)


@pytest.mark.parametrize("P,G", [(18, 3), (18, 6), (17, 3), (1, 2), (0, 0)])
def test_grouped_rows_round_trip(P, G):
    """K6's rows (groups, blocks, 7 (1 + G)), laid out as the kernel writes
    them (group-major; each group's block rows carry a share of the primal
    sums and of its G tangents' sums; the last group padded with zero
    tangents), unpack through params_from_rows to the primal and the P
    tangent rows. P = 0 is K7's one group of 7 columns."""
    rng = np.random.default_rng(P * 10 + G)
    n_blocks = 5
    primal = rng.normal(size=7)
    tangents = rng.normal(size=(P, 7))
    groups = -(-P // G) if P else 1
    padded = np.zeros((groups * G, 7))
    padded[:P] = tangents
    share = rng.dirichlet(np.ones(n_blocks))  # each block's part of the sums
    rows = np.zeros((groups, n_blocks, 7 * (1 + G)))
    for z in range(groups):
        total = np.concatenate([primal, padded[z * G:(z + 1) * G].reshape(-1)])
        rows[z] = share[:, None] * total[None, :]
    p, t = fg.params_from_rows(torch.from_numpy(rows), P)
    np.testing.assert_allclose(p, primal, rtol=1e-12, atol=1e-12)
    assert t.shape == (P, 7)
    np.testing.assert_allclose(t, tangents, rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# K8: per-distance stats
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def stats_setup():
    """The flagship of tests/test_stats_kernel.py (20000 rays, Gaussian
    weights), its detector 10 mm short of the focus, and 3 distances."""
    from attosecondraytracing_tpu.models.detector import Detector

    args = _grad_setup(16)
    elements = args[2]
    n = 20000
    spec = jpt.make_source_spec("cone", np.zeros(3), np.array([1.0, 0, 0]), 25e-3)
    out = jpt.pallas_trace_source(spec, elements, n)
    det = Detector(np.zeros(3))
    det.autoplace(out, 490.0)
    distances = (-5.0, 0.0, 5.0)
    opl_ref, offsets, inv_dn = jpt.chief_ray_refs(spec, elements, det.centre, det.normal, distances)
    jdet = jpt.bake_detector(elements, det.centre, det.normal, det._plane_rotation(), distances,
                             opl_ref=opl_ref, delay_offsets=offsets, inv_dn_chief=inv_dn)
    baked, maps, final, premasks = jpt._source_maps(spec, elements)
    edge = float(np.exp(-2.0))
    tile = jpt.BLOCK_ROWS * jpt.LANES
    rows = -(-n // tile) * tile // jpt.LANES
    outs = jpt._pallas_source_stats_padded(0.0, 0.0, spec, baked, maps, final, premasks, jdet,
                                           jpt.BLOCK_ROWS, True, n, n, rows, edge)
    ref = np.stack([np.asarray(o, np.float64).sum(axis=0)[:len(distances)] for o in outs])
    tels = interop.elements_from_numpy(jax.tree.map(np.asarray, elements), device="cpu",
                                       dtype=torch.float64)
    tspec = interop.source_spec_from_numpy(spec)
    tdet = ft.bake_detector(tels, det.centre, det.normal, det._plane_rotation(), opl_ref=opl_ref,
                            inv_dn_chief=inv_dn, distances=distances, delay_offsets=offsets)
    return {"n": n, "distances": distances, "edge": edge, "jax": ref, "tels": tels,
            "tspec": tspec, "tdet": tdet, "opl_ref": opl_ref, "det": det}


def _stats(sums, opl_ref, distances):
    return ft.sums_to_stats(dict(zip(ft.STATS_FIELDS, sums)), opl_ref, distances)


def _assert_stats_close(a, b):
    """tests/test_stats_kernel.py's envelopes: sum of weights rel 1e-5,
    spot SD rel 2e-3, duration SD 2.5 % or 0.8 fs in quadrature."""
    np.testing.assert_allclose(a["sum_w"], b["sum_w"], rtol=1e-5)
    np.testing.assert_allclose(a["spot_sd"], b["spot_sd"], rtol=2e-3, atol=1e-6)
    for k, r in zip(a["duration_sd"], b["duration_sd"]):
        assert abs(k - r) <= 0.025 * r or abs(k * k - r * r) ** 0.5 <= 0.8, (k, r)


def test_source_stats_ref_matches_pallas_k8(stats_setup):
    """K8's plain version against _kernel_source_stats (interpret mode) at 3
    distances with per-distance delay offsets: the 7 sums (weights rel 1e-5)
    and the statistics; against the port's moments path (K2's plain
    version) at the same distances; and the wrapper on the CPU."""
    st = stats_setup
    n, dist = st["n"], st["distances"]
    table = ft.chain_table(st["tspec"], st["tels"])
    chunks = [(n, 0.0, 0.0)]
    got = ft.fused_source_stats_ref(table, st["tspec"], st["tdet"], chunks, n, device="cpu",
                                    gaussian_edge=st["edge"])
    assert got.shape == (7, 3)
    np.testing.assert_allclose(got[0], st["jax"][0], rtol=1e-5)
    _assert_stats_close(_stats(got, st["opl_ref"], dist), _stats(st["jax"], st["opl_ref"], dist))

    mom = ft.source_detector_moments(st["tspec"], st["tels"], n, st["det"].centre, st["det"].normal,
                                     st["det"]._plane_rotation(), device="cpu", dtype=torch.float32,
                                     opl_ref=st["opl_ref"], gaussian_edge=st["edge"])
    sums = ft.moments_to_distance_sums(mom["moments"], dist, mom["centre_distance"])
    _assert_stats_close(_stats(got, st["opl_ref"], dist),
                        ft.sums_to_stats(sums, mom["opl_ref"], dist))

    ft.fused_source_stats.launches = 0
    again = ft.fused_source_stats(table, st["tspec"], st["tdet"], chunks, n, device="cpu",
                                  gaussian_edge=st["edge"])
    np.testing.assert_array_equal(again, got)
    assert ft.fused_source_stats.launches == 0
    with pytest.raises(ValueError):  # more distances than one pass takes
        ft.fused_source_stats_ref(table, st["tspec"], st["tdet"]._replace(
            distances=(0.0,) * 129, delay_offsets=(0.0,) * 129), chunks, n, device="cpu")
