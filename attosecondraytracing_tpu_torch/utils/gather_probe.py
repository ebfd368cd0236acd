"""The gather probes P4 and P5 on the card, and what a grid defect's lookup
costs there.

Counterpart of the JAX package's ``scripts/exp_mosaic_gather.py``, which
asked whether Mosaic lowers the gathers of a grid map's bilinear lookup on
the TPU (it did not, so the JAX package sends grid maps to its XLA engine).
Here a gather is a load at a computed address, and the kernels of
``csrc/gather_probe.cu`` (built with the others, ``ops/_cuda.py``) compute
what the script's Pallas bodies compute:

* **P4** :func:`gather` — ``row_gather``, ``gather_2d``, ``flat_take`` and
  ``bilinear`` on the script's (512, 512) float32 map at its (8, 128)
  points;
* **P5** :func:`take_along` — ``take_along_axis`` along axis 1 on (8, 128)
  and (8, 512) operands, along axis 0 on (128, 128) and (512, 128);
* the trace's own lookup (``grid_sums`` of ``csrc/trace_common.cuh``)
  over many points of a packed map, :func:`lookup`, timed by
  :func:`lookup_timings` on maps in L2 and in HBM, in two point orders.

Each wrapper takes its plain version for CPU tensors and launches its
kernel for CUDA tensors, counting launches in ``launches``. Run on a card::

    python -m attosecondraytracing_tpu_torch.utils.gather_probe
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..ops import fused_trace as ft
from ..ops.defects import GridDefect, _bilinear_multi

#: the script's map side and the tolerance of its check (``np.allclose``)
N = 512
ATOL = 1e-5
GATHER_FORMS = ("row_gather", "gather_2d", "flat_take", "bilinear")
#: P5's cases: (name, operand shape, axis)
TAKE_CASES = (("taa_axis1_8x128", (8, 128), 1), ("taa_axis1_8x512", (8, 512), 1),
              ("taa_axis0_128x128", (128, 128), 0), ("taa_axis0_512x128", (512, 128), 0))
#: the lookup timings: points per launch, and the maps (nodes): the
#: script's, the grid flagship's Fourrier map (31 MB packed, in L2) and
#: examples/CONFIG_deformed.py's (1 GB packed, in HBM)
N_POINTS = 10_000_000
LOOKUP_MAPS = (("512 x 512", (512, 512)), ("grid flagship 3000 x 640", (3000, 640)),
               ("CONFIG_deformed 8000 x 8000", (8000, 8000)))
#: HBM rate of the H100 SXM data sheet [B/s], for sectors reckoned from a time
HBM_BYTES_PER_S = 3.35e12


def script_inputs():
    """The script's inputs from its seed, drawn in its order: the map, X
    and Y, then P5's four operands."""
    rng = np.random.default_rng(0)
    grid = rng.standard_normal((N, N)).astype(np.float32)
    x = rng.uniform(0, 1, (8, 128)).astype(np.float32)
    y = rng.uniform(0, 1, (8, 128)).astype(np.float32)
    operands = [rng.standard_normal(shape).astype(np.float32) for _name, shape, _axis in TAKE_CASES]
    return grid, x, y, operands


_bound_lib = None


def _lib():
    """The kernel library with the probes' entry points bound (once)."""
    global _bound_lib
    from ..ops import _cuda

    lib = _cuda.library()
    if _bound_lib is not lib:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.art_grid_params_size.argtypes = []
        lib.art_grid_params_size.restype = ctypes.c_size_t
        if lib.art_grid_params_size() != ft._GRID_T.itemsize:
            raise RuntimeError(f"GridP is {lib.art_grid_params_size()} B, the numpy record "
                               f"{ft._GRID_T.itemsize} B: layouts disagree")
        lib.art_launch_gather_forms.argtypes = [ci, vp, ci, vp, vp, vp, ci, vp]
        lib.art_launch_take_along.argtypes = [vp, ci, ci, ci, vp, vp]
        lib.art_launch_grid_lookup.argtypes = [vp, vp, vp, ci, vp, vp]
        for name in ("art_launch_gather_forms", "art_launch_take_along", "art_launch_grid_lookup"):
            getattr(lib, name).restype = ci
        _bound_lib = lib
    return lib


def _launch(name, status):
    from ..ops import _cuda

    _cuda._check(_lib(), status, name)


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_f32(name, *ts):
    dev = ts[0].device
    for t in ts:
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"{name} takes contiguous float32 tensors on one device, got "
                             f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})")


# ---------------------------------------------------------------------------
# P4
# ---------------------------------------------------------------------------


def _index(a, n):
    """The script's idx: clip(floor(a (n - 1)), 0, n - 2)."""
    return torch.clamp(torch.floor(a * (n - 1)).to(torch.int64), 0, n - 2)


def gather_ref(form: str, g, x, y):
    """Plain version of P4: the script's kernel body ``k_<form>``."""
    n = g.shape[0]
    ix, iy = _index(x, n), _index(y, n)
    if form == "row_gather":
        return g[ix, torch.zeros_like(ix)]
    if form == "gather_2d":
        return g[ix, iy]
    if form == "flat_take":
        return g.reshape(-1)[ix * n + iy]
    if form != "bilinear":
        raise ValueError(f"P4 forms are {GATHER_FORMS}, got {form!r}")
    wx = x * (n - 1) - ix
    wy = y * (n - 1) - iy
    return (g[ix, iy] * (1 - wx) * (1 - wy) + g[ix + 1, iy] * wx * (1 - wy)
            + g[ix, iy + 1] * (1 - wx) * wy + g[ix + 1, iy + 1] * wx * wy)


def gather(form: str, g, x, y):
    """P4 (replaces ``scripts/exp_mosaic_gather.py::run`` of the JAX
    package): the gather ``form`` of the square map ``g`` at points (x, y)
    in [0, 1). CPU tensors take :func:`gather_ref`; CUDA tensors launch
    ``gather_forms_kernel``."""
    if form not in GATHER_FORMS:
        raise ValueError(f"P4 forms are {GATHER_FORMS}, got {form!r}")
    if g.ndim != 2 or g.shape[0] != g.shape[1] or g.shape[0] < 2 or x.shape != y.shape:
        raise ValueError(f"P4 takes a square map and points of one shape, got {tuple(g.shape)}, "
                         f"{tuple(x.shape)}, {tuple(y.shape)}")
    if g.device.type == "cpu":
        return gather_ref(form, g, x, y)
    _check_f32("P4", g, x, y)
    out = torch.empty_like(x)
    with torch.cuda.device(g.device):
        _launch("gather_forms launch", _lib().art_launch_gather_forms(
            GATHER_FORMS.index(form), g.data_ptr(), g.shape[0], x.data_ptr(), y.data_ptr(),
            out.data_ptr(), x.numel(), _stream(g)))
    gather.launches += 1
    return out


gather.launches = 0


# ---------------------------------------------------------------------------
# P5
# ---------------------------------------------------------------------------


def take_along_ref(op, axis: int):
    """Plain version of P5: ``op[s, (l 7 + s) % ncols]`` (axis 1) or
    ``op[(s 13 + l) % nrows, l]`` (axis 0) at output row s, column l."""
    rows, cols = op.shape
    s, l = torch.meshgrid(torch.arange(rows, device=op.device), torch.arange(cols, device=op.device),
                          indexing="ij")
    if axis == 1:
        return op[s, (l * 7 + s) % cols]
    return op[(s * 13 + l) % rows, l]


def take_along(op, axis: int):
    """P5 (replaces ``scripts/exp_mosaic_gather.py::probe_take_along``'s
    ``try_one``): ``take_along_axis`` with the script's index pattern. CPU
    tensors take :func:`take_along_ref`; CUDA tensors launch
    ``take_along_kernel``."""
    if op.ndim != 2 or axis not in (0, 1):
        raise ValueError(f"P5 takes a 2-D operand and axis 0 or 1, got {tuple(op.shape)}, {axis}")
    if op.device.type == "cpu":
        return take_along_ref(op, axis)
    _check_f32("P5", op)
    out = torch.empty_like(op)
    with torch.cuda.device(op.device):
        _launch("take_along launch", _lib().art_launch_take_along(
            op.data_ptr(), op.shape[0], op.shape[1], axis, out.data_ptr(), _stream(op)))
    take_along.launches += 1
    return out


take_along.launches = 0


# ---------------------------------------------------------------------------
# the trace's lookup
# ---------------------------------------------------------------------------


def lookup_ref(defect: GridDefect, x, y):
    """Plain version of the lookup: ``ops/defects._bilinear_multi`` of the
    height and slope maps at (x, y), summed (h + dh/dx + dh/dy)."""
    h, gx, gy = _bilinear_multi((defect.height, defect.slope_x, defect.slope_y),
                                defect.x0, defect.y0, defect.dx, defect.dy, x, y)
    return h + gx + gy


def prepare_lookup(defect: GridDefect, x, y):
    """The lookup's host work on a card: the grid's record and packed rows
    (``ops/fused_trace.grid_rows``) and the output. Returns ``(out,
    launch)``; each ``launch()`` runs ``grid_lookup_kernel`` once."""
    _check_f32("lookup", x, y)
    if x.shape != y.shape or x.device.type != "cuda":
        raise ValueError("the lookup takes points of one shape on a CUDA device")
    rec = np.zeros((), dtype=ft._GRID_T)
    ft._pack_grid(rec, defect, ft._check_grid(defect))
    rows = ft.grid_rows(defect, x.device)
    out = torch.empty_like(x)

    def launch():
        rec["rows"] = rows.data_ptr()  # the closure holds the rows
        with torch.cuda.device(x.device):
            _launch("grid_lookup launch", _lib().art_launch_grid_lookup(
                rec.ctypes.data, x.data_ptr(), y.data_ptr(), x.numel(), out.data_ptr(),
                _stream(x)))
        lookup.launches += 1

    return out, launch


def lookup(defect: GridDefect, x, y):
    """The trace's bilinear lookup (``grid_sums``) of a grid map at (x, y):
    h + dh/dx + dh/dy per point. CPU tensors take :func:`lookup_ref`; CUDA
    tensors launch ``grid_lookup_kernel``."""
    if x.device.type == "cpu":
        return lookup_ref(defect, x, y)
    out, launch = prepare_lookup(defect, x, y)
    launch()
    return out


lookup.launches = 0


def probe_points(shape, n_points: int, order: str, *, device, seed=0):
    """(x, y) float32 points over a map of ``shape`` nodes (origin 0,
    spacing 1): ``order`` "uniform" draws them at random, "spiral" takes
    K1's source law (a Vogel spiral, ``ops/fused_trace._vogel_unit``) over the
    ellipse inscribed in the map, so neighbouring lanes of a warp land as
    K1's rays land on a mirror."""
    nx, ny = shape
    if order == "uniform":
        gen = torch.Generator(device=device).manual_seed(seed)
        u = torch.rand((2, n_points), generator=gen, device=device)
        return (u[0] * (nx - 1)).contiguous(), (u[1] * (ny - 1)).contiguous()
    if order != "spiral":
        raise ValueError(f"point orders are 'uniform' and 'spiral', got {order!r}")
    k = torch.arange(n_points, dtype=torch.int64, device=device)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    ux, uy = ft._vogel_unit(k, n_points, zero, zero)
    return (0.5 * (nx - 1) * (1 + ux)).contiguous(), (0.5 * (ny - 1) * (1 + uy)).contiguous()


def random_grid(shape, *, device, seed=0) -> GridDefect:
    """A grid of normal random float32 maps on ``device`` (origin 0,
    spacing 1): the lookup's cost does not depend on the values."""
    gen = torch.Generator(device=device).manual_seed(seed)
    h, gx, gy = torch.randn((3, *shape), generator=gen, device=device)
    return GridDefect(height=h, slope_x=gx, slope_y=gy, x0=0.0, y0=0.0, dx=1.0, dy=1.0)


def time_ms(fn, reps=5, inner=5):
    """Per-call time [ms] of ``fn`` on the card after a warm-up: the median
    of ``reps`` CUDA-event windows of ``inner`` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    return sorted(times)[len(times) // 2]


def lookup_timings(*, device, n_points=N_POINTS, maps=LOOKUP_MAPS):
    """Launch-only time of the trace's lookup over ``n_points`` points of
    each map of ``maps``, in both point orders, with the 32-byte sectors per
    point reckoned from the time at the HBM rate (an upper bound of what
    came from HBM; a map in L2 is read from there). Returns a list of
    dicts."""
    out = []
    for name, shape in maps:
        grid = random_grid(shape, device=device)
        for order in ("uniform", "spiral"):
            x, y = probe_points(shape, n_points, order, device=device)
            _, launch = prepare_lookup(grid, x, y)
            ms = time_ms(launch)
            out.append({"map": name, "nodes": list(shape), "map_mb": shape[0] * shape[1] * 16 / 1e6,
                        "order": order, "points": n_points, "ms": ms,
                        "sectors_per_point": ms * 1e-3 * HBM_BYTES_PER_S / 32 / n_points})
        del grid
    return out


def probe(*, device):
    """The probe's run at the script's shapes: every P4 form and every P5
    case once on ``device``. Returns ``({form or case: output}, inputs)``."""
    grid, x, y, operands = script_inputs()
    g, tx, ty = (torch.from_numpy(a).to(device) for a in (grid, x, y))
    ops = [torch.from_numpy(op).to(device) for op in operands]
    outs = {form: gather(form, g, tx, ty) for form in GATHER_FORMS}
    for (name, _shape, axis), op in zip(TAKE_CASES, ops):
        outs[name] = take_along(op, axis)
    return outs, (g, tx, ty, ops)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("the gather probe runs on a CUDA card")
    dev = torch.device("cuda", 0)
    outs, (g, x, y, operands) = probe(device=dev)
    for form in GATHER_FORMS:
        ref = gather_ref(form, g, x, y)
        print(f"P4 {form}: max |kernel - plain| {float((outs[form] - ref).abs().max()):.3g}")
    for (name, _shape, axis), op in zip(TAKE_CASES, operands):
        print(f"P5 {name}: equal {bool(torch.equal(outs[name], take_along_ref(op, axis)))}")
    for row in lookup_timings(device=dev):
        print(f"lookup {row['map']} ({row['map_mb']:.1f} MB), {row['order']} order: {row['ms']:.4f} ms "
              f"per {row['points']} points, {row['sectors_per_point']:.3f} sectors per point")


if __name__ == "__main__":
    main()
