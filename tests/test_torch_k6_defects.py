"""The gradient kernel K6 on deformed mirrors: the arithmetic its defect
branch runs on the primal and the tangents it composes at the hit
(``csrc/trace_common.cuh``: the ``Dual<G>`` overloads of
``zernike_height`` / ``zernike_slopes`` / ``grid_height`` / ``grid_slopes``,
with ``at_hit``, ``grid_cell`` and ``zernike_hessian``), held on the CPU
through their plain twins:

* ``ops/zernike.zernike_value_grad_hessian``: the Zernike values, gradients
  and Hessians by the recurrence (the slopes' tangents are the Hessian's
  rows), against ``torch.func.jacfwd`` of the port's
  ``zernike_value_and_grad`` and ``jax.jvp`` of the JAX package's, at
  orders 2-8 on points inside the unit disk and on its edge;
* ``ops/defects._bilinear_multi_cells``: a grid map's bilinear value and
  cell derivatives, zero along a clamped index, against ``torch.func.jacfwd``
  and ``jax.jvp`` of both packages' ``_bilinear_multi``, inside the map and past each of its edges;
* the chain rule at the hit of a mirror with a Zernike table and a grid map
  together: t(h) = h_x t(x) + h_y t(y) and the slopes' rows, against
  ``torch.func.jvp`` / ``jax.jvp`` of both packages' ``defect_offset`` /
  ``defect_slopes`` summed over the mirror's defects;
* K6's plain version (``stats_params_ref``, all 18 tangent rows) on the
  grid flagship with both ``ignore_defects`` against the body of the JAX
  kernel ``_kernel_stats_jvp`` (``jax.linearize`` of ``_stats_of_scalars``,
  the function its ``pallas_call`` differentiates). The JAX package's
  Pallas kernels refuse grid maps (``pallas_trace._bake_defect``), so the
  body runs outside ``pallas_call``, on the same rays;
* ``chip_smoke._k6_effect``, the card's check of the defects' share of K6's
  rows, on the CPU: its defect sizes move every difference it holds.

The kernel itself runs only on the card (``chip_smoke.py``, phases zernike
and grid, both ``ignore_defects``). Tolerances: the twins in float64 within
1e-12 of each quantity's scale (the same operations, another order of
rounding); K6's plain version within tests/test_torch_zernike_trace.py's
envelope (the 7 sums: weights rel 1e-5, the spatial sums 1e-4 of their
scales, durations 2.5 % or 0.8 fs in quadrature; tangents within 2e-3 of
each statistic's largest)."""

import sys

# tests/reference_shims.py leaves stand-in modules in sys.modules whose
# attributes are stubs; importing torch runs inspect.getmodule over them, so
# they are set aside while torch imports (as in tests/test_torch_zernike_trace.py).
_stubs = {name: mod for name, mod in list(sys.modules.items())
          if not isinstance(getattr(mod, "__file__", None), (str, type(None)))}
for _name in _stubs:
    del sys.modules[_name]
import torch  # noqa: E402

sys.modules.update(_stubs)

from functools import partial  # noqa: E402

import jax  # noqa: E402
import jax.flatten_util  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from attosecondraytracing_tpu.models.detector import Detector as JDetector  # noqa: E402
from attosecondraytracing_tpu.ops import defects as jdef  # noqa: E402
from attosecondraytracing_tpu.ops import pallas_grad as jpg  # noqa: E402
from attosecondraytracing_tpu.ops import pallas_trace as jpt  # noqa: E402
from attosecondraytracing_tpu.ops import zernike as jz  # noqa: E402
from attosecondraytracing_tpu_torch import interop  # noqa: E402
from attosecondraytracing_tpu_torch.ops import defects as tdef  # noqa: E402
from attosecondraytracing_tpu_torch.ops import fused_grad as fg  # noqa: E402
from attosecondraytracing_tpu_torch.ops import fused_trace as ft  # noqa: E402
from attosecondraytracing_tpu_torch.ops import zernike as tz  # noqa: E402

torch.set_num_threads(1)

N = 4096
EDGE = float(np.exp(-2.0))


@pytest.fixture(autouse=True, scope="module")
def _no_stub_modules():
    """Set tests/reference_shims.py's stub modules aside while this module's
    tests run: torch.func looks modules up through inspect, which fails on
    them (see the top of this file)."""
    with pytest.MonkeyPatch.context() as mp:
        for name, mod in list(sys.modules.items()):
            if not isinstance(getattr(mod, "__file__", None), (str, type(None))):
                mp.delitem(sys.modules, name)
        yield


def _disk_points(n=40, seed=0):
    """Points inside the unit disk and on its edge (r = 1 and just inside)."""
    rng = np.random.default_rng(seed)
    r = np.sqrt(rng.uniform(0.0, 1.0, n))
    a = rng.uniform(0.0, 2.0 * np.pi, n)
    edge = np.linspace(0.0, 2.0 * np.pi, 8, endpoint=False)
    r = np.concatenate([r, np.ones(8), np.full(8, 1.0 - 1e-9)])
    a = np.concatenate([a, edge, edge + 0.3])
    return r * np.cos(a), r * np.sin(a)


def _diag_jacfwd(fn, x, y):
    """d fn / dx and d fn / dy of an elementwise function of (x, y) by
    ``torch.func.jacfwd`` (the diagonals of its Jacobians)."""
    jx, jy = torch.func.jacfwd(fn, argnums=(0, 1))(x, y)
    return jx.diagonal(dim1=-2, dim2=-1), jy.diagonal(dim1=-2, dim2=-1)


def _jax_partials(fn, x, y):
    """d fn / dx and d fn / dy of an elementwise function of (x, y) by
    ``jax.jvp`` along each coordinate."""
    x, y = jnp.asarray(x), jnp.asarray(y)
    one, zero = jnp.ones_like(x), jnp.zeros_like(x)
    return tuple(np.asarray(jax.jvp(fn, (x, y), t)[1]) for t in ((one, zero), (zero, one)))


def _close(got, ref, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = max(float(np.abs(ref).max()), 1.0)
    assert np.all(np.abs(got - ref) <= 1e-12 * scale), (what, float(np.abs(got - ref).max()), scale)


@pytest.mark.parametrize("order", range(2, 9))
def test_zernike_hessian_twin_matches_both_packages(order):
    """The recurrence's Hessian rows (K6's slope tangents) against
    ``torch.func.jacfwd`` of the port's gradients and ``jax.jvp`` of the
    JAX package's, every (n, m) up to ``order``; values and gradients equal
    the port's own."""
    xs, ys = _disk_points(seed=order)
    x, y = torch.from_numpy(xs), torch.from_numpy(ys)
    Z, DX, DY, DXX, DXY, DYY = tz.zernike_value_grad_hessian(x, y, order)
    Z0, DX0, DY0 = tz.zernike_value_and_grad(x, y, order)
    keys = sorted(Z0)
    assert sorted(Z) == keys == sorted(DXX) and len(keys) == (order + 1) * (order + 2) // 2
    for k in keys:
        assert torch.equal(Z[k], Z0[k]) and torch.equal(DX[k], DX0[k]) and torch.equal(DY[k], DY0[k])

    def port(a, b):  # (values, d/dx, d/dy), each (terms, points)
        return torch.stack([torch.stack([rows[k] for k in keys]) for rows in tz.zernike_value_and_grad(a, b, order)])

    def jax_port(a, b):
        return jnp.stack([jnp.stack([rows[k] for k in keys]) for rows in jz.zernike_value_and_grad(a, b, order)])

    (t_x, t_y), (j_x, j_y) = _diag_jacfwd(port, x, y), _jax_partials(jax_port, xs, ys)
    twin = {"xx": DXX, "xy": DXY, "yy": DYY}
    # d/dx and d/dy of the gradient rows: (row, coordinate) -> the Hessian entry
    for (row, name), which in (((1, "xx"), 0), ((1, "xy"), 1), ((2, "xy"), 0), ((2, "yy"), 1)):
        mine = torch.stack([twin[name][k] for k in keys]).numpy()
        _close(mine, (t_x, t_y)[which][row].numpy(), f"d2/d{name} vs torch.func.jacfwd")
        _close(mine, (j_x, j_y)[which][row], f"d2/d{name} vs jax.jvp")
    # the twin's gradient rows are the values' derivatives
    _close(torch.stack([DX[k] for k in keys]).numpy(), t_x[0].numpy(), "d/dx")
    _close(torch.stack([DY[k] for k in keys]).numpy(), t_y[0].numpy(), "d/dy")


def _grid(seed=3, shape=(9, 6)):
    """Three maps (height, slopes) of one grid from a seed, float64."""
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape) for _ in range(3)], (-4.0, -2.5, 1.1, 0.9)


#: points inside the grid (9 x 6 nodes from (-4, -2.5), spacing 1.1 x 0.9),
#: and past its edges: below and above in x, in y, and in both
GRID_POINTS = {
    "inside": ([-3.7, 0.05, 2.3, 4.4, 4.7], [-2.2, 0.9, 1.3, -0.1, 1.8]),
    "clamped": ([-5.0, 6.2, 0.3, 1.7, -4.6, 7.1], [0.2, -1.1, -3.3, 3.0, -2.9, 2.9]),
}


@pytest.mark.parametrize("where", sorted(GRID_POINTS))
def test_bilinear_cells_twin_matches_both_packages(where):
    """The bilinear's value and cell derivatives (K6's ``grid_cell``)
    against the port's ``torch.func.jacfwd`` and the JAX package's
    ``jax.jvp`` of ``_bilinear_multi``: equal values,
    derivatives within 1e-12; past an edge the clamped index's derivative is
    0 (and the other one's is not)."""
    maps, (x0, y0, dx, dy) = _grid()
    xs, ys = (np.asarray(v, np.float64) for v in GRID_POINTS[where])
    x, y = torch.from_numpy(xs), torch.from_numpy(ys)
    tmaps = [torch.from_numpy(m) for m in maps]
    twin = tdef._bilinear_multi_cells(tmaps, x0, y0, dx, dy, x, y)
    values = tdef._bilinear_multi(tmaps, x0, y0, dx, dy, x, y)
    port = _diag_jacfwd(lambda a, b: torch.stack(tdef._bilinear_multi(tmaps, x0, y0, dx, dy, a, b)), x, y)
    jmaps = [jnp.asarray(m) for m in maps]
    jref = _jax_partials(lambda a, b: jnp.stack(jdef._bilinear_multi(jmaps, x0, y0, dx, dy, a, b)), xs, ys)
    for k, (v, vx, vy) in enumerate(twin):
        assert torch.equal(v, values[k])
        _close(vx.numpy(), port[0][k].numpy(), "d/dx vs torch.func.jacfwd")
        _close(vy.numpy(), port[1][k].numpy(), "d/dy vs torch.func.jacfwd")
        _close(vx.numpy(), jref[0][k], "d/dx vs jax.jvp")
        _close(vy.numpy(), jref[1][k], "d/dy vs jax.jvp")
    nx, ny = maps[0].shape
    ux, uy = (xs - x0) / dx, (ys - y0) / dy
    out_x = (ux <= 0) | (ux >= nx - 1.000001)
    out_y = (uy <= 0) | (uy >= ny - 1.000001)
    assert (where == "clamped") == bool(np.any(out_x | out_y))
    for v, vx, vy in twin:
        assert np.all(vx.numpy()[out_x] == 0) and np.all(vy.numpy()[out_y] == 0)
        assert np.all(vx.numpy()[~out_x] != 0) and np.all(vy.numpy()[~out_y] != 0)


def _mirror_defects(pkg_defects, radius, grid_maps, grid_geo, as_array):
    """A mirror's Zernike defect (order 6, the deformed flagship's terms and
    two more) and grid defect in one package (``radius`` in its form)."""
    coeffs = {(2, 0): 2e-4, (3, 1): -1e-4, (4, 2): 5e-5, (6, 3): 2e-5, (5, 0): 3e-5, (6, 6): -1e-5}
    zk = pkg_defects.ZernikeDefect(coeffs, radius)
    grid = pkg_defects.GridDefect(*(as_array(m) for m in grid_maps), *grid_geo)
    return zk, grid, coeffs


def test_chain_rule_at_a_mirror_with_zernike_and_grid():
    """K6's composition at the hit of a mirror with a Zernike table and a
    grid map: the height's tangent (h_x t(x) + h_y t(y), the table's
    gradient over the radius plus the map's cell derivatives) and the
    slopes' (the table's Hessian rows over the radius squared plus the slope
    maps' cell derivatives), built from the twins as the kernel builds them,
    against the jvp of the sum of both packages' ``defect_offset`` and
    ``defect_slopes`` along random tangents of the hit's support
    coordinates, on points inside the map and past its edges (within the
    Zernike disk's circumscribed radius and on it)."""
    maps, (x0, y0, dx, dy) = _grid(seed=5, shape=(12, 8))
    radius = 9.0
    xs = np.array([-3.7, 0.05, 2.3, 4.4, 8.9, -5.0, 6.2, 0.3, 9.0, -6.0])
    ys = np.array([-2.2, 0.9, 1.3, -0.1, 0.1, 0.2, -1.1, -3.3, 0.0, 4.5])
    rng = np.random.default_rng(11)
    txs, tys = rng.normal(size=xs.size), rng.normal(size=xs.size)
    x, y, tx, ty = (torch.from_numpy(v) for v in (xs, ys, txs, tys))

    zk, grid, coeffs = _mirror_defects(tdef, radius, maps, (x0, y0, dx, dy), torch.from_numpy)

    def port_defects(a, b):
        h = tdef.defect_offset(zk, a, b) + tdef.defect_offset(grid, a, b)
        (zx, zy), (gx, gy) = tdef.defect_slopes(zk, a, b), tdef.defect_slopes(grid, a, b)
        return torch.stack([h, zx + gx, zy + gy])

    _, port_t = torch.func.jvp(port_defects, (x, y), (tx, ty))
    jzk, jgrid, _ = _mirror_defects(jdef, jnp.asarray(radius), maps, (x0, y0, dx, dy), jnp.asarray)

    def jax_defects(a, b):
        h = jdef.defect_offset(jzk, a, b) + jdef.defect_offset(jgrid, a, b)
        (zx, zy), (gx, gy) = jdef.defect_slopes(jzk, a, b), jdef.defect_slopes(jgrid, a, b)
        return jnp.stack([h, zx + gx, zy + gy])

    _, jax_t = jax.jvp(jax_defects, (jnp.asarray(xs), jnp.asarray(ys)), (jnp.asarray(txs), jnp.asarray(tys)))

    # the kernel's form: the table's rows at the unit-disk coordinates
    order = max(n for n, _m in coeffs)
    Z, DX, DY, DXX, DXY, DYY = tz.zernike_value_grad_hessian(x / radius, y / radius, order)

    def table(rows):
        return sum(c * rows[k] for k, c in coeffs.items())

    (hg, hgx, hgy), = tdef._bilinear_multi_cells([grid.height], x0, y0, dx, dy, x, y)
    (_sx, sxx, sxy), (_sy, syx, syy) = tdef._bilinear_multi_cells([grid.slope_x, grid.slope_y], x0, y0, dx, dy,
                                                                  x, y)
    ax, ay = table(DX) / radius + hgx, table(DY) / radius + hgy
    r2 = radius * radius
    mine = torch.stack([ax * tx + ay * ty,
                        (table(DXX) * tx + table(DXY) * ty) / r2 + sxx * tx + sxy * ty,
                        (table(DXY) * tx + table(DYY) * ty) / r2 + syx * tx + syy * ty])
    for k, what in enumerate(("height", "slope x", "slope y")):
        _close(mine[k].numpy(), port_t[k].numpy(), f"{what} tangent vs torch.func.jvp")
        _close(mine[k].numpy(), np.asarray(jax_t[k]), f"{what} tangent vs jax.jvp")


def _grid_flagship(n_rays=N):
    """The flagship (tests/test_torch_grid_kernels.py's) with a Fourier-PSD
    map (RMS 1e-4 mm, smallest wavelength 1 mm, seed 3) on its first
    toroid, in the JAX package."""
    from attosecondraytracing_tpu.models import defects, masks, mirrors, supports
    from attosecondraytracing_tpu.models.placement import OEPlacement

    R, r = mirrors.ReturnOptimalToroidalRadii(500.0, 80.0)
    sup = supports.SupportRectangle(150, 32)
    tor = mirrors.MirrorToroidal(R, r, sup)
    deformed = mirrors.DeformedMirror(tor, [defects.Fourrier(sup, RMS=1e-4, smallest=1.0, seed=3)])
    mask = masks.Mask(supports.SupportRoundHole(Radius=20, RadiusHole=7, CenterHoleX=0, CenterHoleY=0))
    props = {"Divergence": 25e-3, "SourceSize": 0, "Wavelength": 80e-6, "DeltaFT": 0.5, "NumberRays": n_rays}
    return OEPlacement(props, [mask, deformed, tor], [400.0, 100.0, 500.0], [0.0, 80.0, -80.0],
                       [0.0, 0.0, 0.0], "grid flagship")


@pytest.fixture(scope="module")
def grid_problem():
    """The grid flagship's fused loss (tests/test_torch_zernike_trace.py's
    grad_problem on the grid chain): elements in both packages, the
    misaligned pose's scalars and their 18 tangent rows."""
    from attosecondraytracing_tpu.analysis import alignment as al
    from attosecondraytracing_tpu.ops.trace import trace_jit

    chain = _grid_flagship()
    elements = [e.to_device(dtype=jnp.float32) for e in chain.optical_elements]
    info = chain.source_spec
    baked = info.baked()
    det = JDetector(chain.optical_elements[-1].position)
    det.autoplace(trace_jit(jpt.source_bundle(baked, 256, wavelength=80e-6), elements, keep_history=False),
                  495.0)
    opl_ref, _, _ = jpt.chief_ray_refs(baked, elements, det.centre, det.normal, (0.0,))
    params = al.zero_params(len(elements), dtype=jnp.float32)
    params = params._replace(angles=params.angles.at[1, 0].set(2e-4).at[2, 2].set(-1e-4),
                             shifts=params.shifts.at[1, 0].set(0.05))
    geo = (np.asarray(baked.rot), np.asarray(info.origin), det.centre, det.normal, det._plane_rotation())
    sprimal = np.asarray(jpg.chain_scalars_np(jpg._apply_params_np(elements, params), *geo), np.float32)
    flat, unravel = jax.flatten_util.ravel_pytree(params)
    stangents = np.asarray(jax.jacfwd(lambda fp: jpg.chain_scalars(
        al.apply_params(elements, unravel(fp)), *geo))(flat)).T.astype(np.float32)
    tels = interop.elements_from_numpy(jax.tree.map(np.asarray, elements), device="cpu", dtype=torch.float64)
    return {"elements": elements, "tels": tels, "info": info, "baked": baked, "opl_ref": float(opl_ref),
            "sprimal": sprimal, "stangents": stangents}


def _jax_stats_jvp(g, ignore_defects):
    """The body of the JAX kernel ``_kernel_stats_jvp`` on every ray of the
    grid flagship in one chunk: ``jax.linearize`` of ``_stats_of_scalars``
    (its grid maps unbaked: the Pallas call refuses them), the primal rows
    and each tangent row's, summed in float64."""
    spec = jpg.FusedLossSpec(
        source_kind=g["info"].kind, source_radius=float(g["baked"].radius), elements=tuple(g["elements"]),
        element_kinds=("mask", "mirror", "mirror"), opl_ref=g["opl_ref"], gaussian_edge=EDGE, n_rays=N,
        duration_weight=0.0, survival_weight=1.0, ignore_defects=ignore_defects)
    block_rows = N // jpt.LANES
    idx = jnp.arange(N, dtype=jnp.int32).reshape(block_rows, jpt.LANES)
    f = partial(jpg._stats_of_scalars, spec=spec, kf=idx.astype(jnp.float32), idx=idx,
                block_rows=block_rows, n_local=N, phase=0.0, k_frac=0.0)
    n = g["sprimal"].size
    p_rows, lin = jax.linearize(f, tuple(jnp.float32(v) for v in g["sprimal"]))
    primal = np.array([np.asarray(r, np.float64).sum() for r in p_rows])
    tangents = np.array([[np.asarray(r, np.float64).sum() for r in lin(tuple(jnp.float32(t[i]) for i in range(n)))]
                         for t in g["stangents"]])
    return spec, primal, tangents


@pytest.mark.parametrize("ignore_defects", [True, False])
def test_k6_plain_matches_jax_kernel_body_on_grid_flagship(grid_problem, ignore_defects):
    """K6's plain version (all 18 tangent rows in one call, as one K6 launch
    takes them on the card) against the JAX kernel's body
    (:func:`_jax_stats_jvp`) on the grid flagship; with ``ignore_defects``
    False the map's slopes enter the sums and their tangents."""
    g = grid_problem
    jspec, p_ref, t_ref = _jax_stats_jvp(g, ignore_defects)
    tspec = fg.FusedLossSpec(source_kind=jspec.source_kind, source_radius=jspec.source_radius,
                             elements=tuple(g["tels"]), opl_ref=jspec.opl_ref, gaussian_edge=EDGE, n_rays=N,
                             duration_weight=0.0, survival_weight=1.0, ignore_defects=ignore_defects)
    assert g["stangents"].shape == (18, fg.n_scalars(3))
    chunks = fg._ray_chunks(tspec, fg.GRAD_CHUNK)
    assert chunks == [(N, 0.0, 0.0)]
    p, t = fg.fused_stats_params(tspec, g["sprimal"], g["stangents"], chunks, device="cpu")
    w, _, _, wxx, wyy, _, _ = p_ref
    assert abs(p[0] - w) <= 1e-5 * w
    scale = np.array([np.sqrt(w * wxx), np.sqrt(w * wyy), wxx, wyy])
    assert np.all(np.abs(p[1:5] - p_ref[1:5]) <= 1e-4 * scale), (p, p_ref)
    durs = [ft.sums_to_stats(dict(zip(ft.STATS_FIELDS, s[:, None])), jspec.opl_ref, (0.0,))["duration_sd"][0]
            for s in (p, p_ref)]
    assert abs(durs[0] - durs[1]) <= 0.025 * durs[1] or abs(durs[0] ** 2 - durs[1] ** 2) ** 0.5 <= 0.8
    tscale = np.maximum(np.abs(t_ref).max(axis=0), 1e-12)
    assert np.all(np.abs(t - t_ref) <= 2e-3 * tscale), np.abs(t - t_ref).max(axis=0) / tscale
    if not ignore_defects:  # the slopes move the sums and the tangents
        _, p_ig, t_ig = _jax_stats_jvp(g, True)
        assert abs(p_ig[3] - p_ref[3]) > 1e-6 * p_ref[3] and np.abs(t_ig - t_ref).max() > 0


def _csrc_line(name, text):
    """The 1-based line of csrc/``name`` holding ``text``."""
    from attosecondraytracing_tpu_torch.ops import _cuda

    lines = (_cuda.CSRC / name).read_text().splitlines()
    return next(i + 1 for i, line in enumerate(lines) if text in line)


def test_k6_sass_stages_on_a_fixed_listing():
    """kernel_ab's SASS accounting of K6 on deformed mirrors: the defect
    branch's height (the recurrence on the primal, composed at the hit) is
    stage "defects"; what runs only where ignore_defects is False (the
    slope sums inline or out of line, on Dual<G> or the generic form) is
    stage "slopes"; local-memory loads and stores are
    counted per stage; a subroutine the compiler outlined from the body
    (a label that names no slow path) keeps its chains, an IEEE slow path
    does not; a launch's warp passes reach "slopes" only with ignore_defects
    False."""
    from attosecondraytracing_tpu_torch.ops import _cuda
    from attosecondraytracing_tpu_torch.ops import trace as tr
    from attosecondraytracing_tpu_torch.utils import kernel_ab as ab

    tc = "trace_common.cuh"
    zn0 = _csrc_line(tc, "zn[0] = x * z1[0] + y * z1[n - 1];")
    dual_height = _csrc_line(tc, "zernike_sums<true>(zk, (x.v - cx) * zk.inv_r, (y.v - cy) * zk.inv_r, h, hx, hy);")
    height = _csrc_line(tc, "const S dh = zernike_height(zk, h.x, h.y, el.cen[0], el.cen[1]);")
    slopes = _csrc_line(tc, "zernike_slopes(zk, h.x, h.y, el.cen[0], el.cen[1], gx, gy);")
    in_dual_slopes = _csrc_line(tc, "zernike_hessian(zk, (x.v - cx) * zk.inv_r, (y.v - cy) * zk.inv_r, g);")
    generic_slopes = _csrc_line(tc, "zernike_sums<true>(zk, (x - cx) * zk.inv_r, (y - cy) * zk.inv_r, h, gx, gy);")
    mirror_zk = _csrc_line(tc, "if (z >= 0) zernike_hit(el, ch.zk[z], ch.ignore_defects != 0")
    maps_mirror = _csrc_line(tc, "mirror_step<WANT_INCIDENCE, DEFECTS>(ch, i, last")

    def group(*frames):
        lines = [f'        //## File "/r/{tc}", line {n} inlined at "/r/{tc}", line {m}'
                 for n, m in zip(frames, frames[1:])]
        return "\n".join(lines + [f'        //## File "/r/{tc}", line {frames[-1]}'])

    walk = (mirror_zk, maps_mirror)
    listing = "\n".join([
        "\t.text._ZN3art19stats_params_kernelILi6ELi1EEEvNS_6ChainPE:",
        "        /*0000*/                   CALL.REL.NOINC `($_ZN3art19stats_params_kernelILi6ELi1EEEv$loop) ;",
        "        /*0010*/                   EXIT ;",
        "$_ZN3art19stats_params_kernelILi6ELi1EEEv$loop:",
        group(zn0, dual_height, height, *walk),
        "        /*0020*/                   FFMA R1, R2, R3, R4 ;",
        "        /*0030*/                   STL [R1], R2 ;",
        group(in_dual_slopes, slopes, *walk),
        "        /*0040*/                   LDL R2, [R1] ;",
        group(zn0, generic_slopes, slopes, *walk),
        "        /*0050*/                   FMUL R1, R2, R3 ;",
        group(in_dual_slopes),
        "        /*0060*/                   STL [R1], R2 ;",
        "        /*0070*/                   RET.REL.NODEC R2 `(_ZN3art19stats_params_kernelILi6ELi1EEEv) ;",
        "$__internal_12_$__cuda_sm20_rcp_rn_f32_slowpath:",
        "        /*0080*/                   MUFU.RCP R1, R2 ;",
        "        /*0090*/                   RET.REL.NODEC R2 `(_ZN3art19stats_params_kernelILi6ELi1EEEv) ;",
    ])
    instructions = ab.parse_nvdisasm(listing, "stats_params_kernelILi6ELi1E")
    assert [c is None for _op, c in instructions] == [False] * 8 + [True, True]
    src = ab._Sources(_cuda.CSRC)
    stages = ab.stage_counts(instructions, src)
    assert stages["defects"] == ab.pipe_counts(["FFMA", "STL"])
    assert stages["slopes"] == ab.pipe_counts(["LDL", "FMUL", "STL", "RET"])
    assert stages["slow path"]["total"] == 2
    assert ab.stage_local_memory(instructions, src) == {"defects": 1, "slopes": 2}
    assert ab.k6_kernel(6, "zernike") == "stats_params_kernelILi6ELi1E"
    assert ab.k6_kernel(3, "grid") == "stats_params_kernelILi3ELi2E"

    lspec, svec, *_ = _loss_problem("zernike")
    table = fg.pose_table(lspec.elements, svec)
    warps = [10, 10, 8, 8, 7, 7, 6]
    passes = {ignore: ab.stage_warps(table, warps, 4, ignore) for ignore in (True, False)}
    assert "slopes" not in passes[True] and passes[False]["slopes"] == passes[False]["defects"] == 8
    assert passes[True]["defects"] == 8 and passes[True]["toroid"] == 8 + 7
    assert isinstance(table.elements[0], tr.MaskElement)


def _loss_problem(kind, n=N):
    """kernel_ab's ``kind`` flagship's loss spec and pose vector."""
    from attosecondraytracing_tpu_torch.analysis import alignment as al
    from attosecondraytracing_tpu_torch.models.detector import Detector
    from attosecondraytracing_tpu_torch.utils import kernel_ab as ab

    host, spec = ab.flagship(n, kind)
    det = Detector(np.zeros(3))
    det.autoplace(ft.probe_trace(spec, host, 1024, device="cpu", dtype=torch.float32), 490.0)
    geo = (np.asarray(spec.rot, np.float64), np.asarray(spec.origin, np.float64), det.centre, det.normal,
           det._plane_rotation())
    lspec = fg.FusedLossSpec(source_kind="cone", source_radius=float(spec.radius), elements=tuple(host),
                             opl_ref=0.0, gaussian_edge=EDGE, n_rays=n, duration_weight=0.0,
                             survival_weight=1.0)
    return lspec, fg.chain_scalars_np(fg._apply_params_np(host, al.zero_params(len(host))), *geo)


def test_ptxas_fields_and_sass_digests():
    """kernel_ab reads each kernel's registers, stack frame and spills from
    a ptxas log, and compares two builds' SASS function by function with
    offsets, encodings and label numbers left out."""
    from attosecondraytracing_tpu_torch.utils import kernel_ab as ab

    mangled = "_ZN3art19stats_params_kernelILi6ELi2EEEvNS_6ChainPENS_7SourcePEfiiiiPKfiS4_PK6float2Pd"
    log = "\n".join([
        f"ptxas info    : Compiling entry function '{mangled}' for 'sm_90a'",
        f"ptxas info    : Function properties for {mangled}",
        "    528 bytes stack frame, 938 bytes spill stores, 1068 bytes spill loads",
        "ptxas info    : Used 128 registers, used 1 barriers, 528 bytes cumulative stack size, 3024 bytes smem"])
    assert ab.ptxas_fields(log) == {"stats_params_kernel<6, grid>": {
        "registers": 128, "stack_frame": 528, "spill_stores": 938, "spill_loads": 1068}}
    a = {mangled: "1", "_ZN3art19stats_primal_kernelILi0EEEv": "2"}
    assert ab.same_sass_text(a, dict(a)) == "SASS equal to A's in 2 of 2 functions"
    assert ab.same_sass_text(a, {**a, mangled: "3"}) == (
        "SASS equal to A's in 1 of 2 functions; differing: stats_params_kernel<6, grid>")


@pytest.mark.parametrize("kind", ["zernike", "grid"])
def test_effect_check_moves_every_statistic(monkeypatch, kind):
    """chip_smoke's check of the defects' share of K6's rows (``_k6_effect``)
    at 4096 rays on the CPU, where K6's wrapper takes its plain version:
    every gap is 0, and each difference (with ignore_defects True and False
    against the undeformed flagship, False against True) on each chain
    ("zernike"; "grid" and "mixed") moves at least five of the statistics,
    the largest by at least 1e-3 of the undeformed rows' largest, so that
    the card's check holds the defects' tangents to something."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "N_CHECK", N)
    monkeypatch.setattr(chip_smoke, "_launches", lambda: {"K6": 1})
    out = chip_smoke._k6_effect(torch, torch.device("cpu"), kind)
    assert set(out) == ({"zernike"} if kind == "zernike" else {"grid", "mixed"})
    for name, diffs in out.items():
        assert set(diffs) == {"T", "F", "F-T"}
        for d, r in diffs.items():
            assert r["gap"] == 0.0 and r["moved"] >= 5 and r["size"] >= 1e-3, (name, d, r)
