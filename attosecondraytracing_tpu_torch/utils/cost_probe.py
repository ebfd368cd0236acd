"""The cost probes P1-P3 on the card: launch cost, cost per arithmetic
operation, and the memory floor of the fresh-bundle trace.

Counterparts of the JAX package's probe kernels, which measured the TPU:
``bench.py::warmup_mosaic`` (P1, Mosaic's one-time warm-up on an add-one
kernel), ``scripts/diag_vpu_ops.py`` (P2, the VPU's cost per operation) and
``scripts/diag_kernel_cost.py`` (P3, the fresh-bundle trace against a copy
kernel that moves the same streams). The kernels of ``csrc/cost_probe.cu``
(built with the others, ``ops/_cuda.py``) compute what the scripts' Pallas
bodies compute:

* **P1** :func:`add_one` — an (8, 128) float32 tile plus 1; measured as the
  seconds from loading a fresh copy of the kernel library to the first
  finished launch (:func:`first_launch_seconds`), the steady launch
  latency (:func:`launch_latency_us`), the launch's device time with
  the host's work hidden behind a busy stream (:func:`queued_us`), and the
  wrapper's host time taken apart (:func:`add_one_split`);
* **P2** :func:`op_chain` — ``n_ops`` dependent applications of one of the
  script's nine :data:`OPS` to every element of a (78336, 128) float32
  array, slope-timed over ``n_ops`` (:func:`op_costs`);
* **P3** :func:`copy_streams` — the fresh-bundle trace's streams copied
  (6 float32 in; 6 float32, 3 float32 zero and one int8 ones stream out,
  61 B per ray), against kernel K4 (``ops/fused_trace.streamed_trace``,
  fresh) on four subsets of the flagship chain (:func:`kernel_cost`).

Each wrapper takes its plain version for CPU tensors and launches its
kernel for CUDA tensors, counting launches in ``launches``. Run on a card::

    python -m attosecondraytracing_tpu_torch.utils.cost_probe
"""

from __future__ import annotations

import ctypes
import os
import shutil
import sys
import time

import numpy as np
import torch

from ..ops import _cuda
from .gather_probe import _check_f32, _stream, time_ms

#: P1's tile
TILE = (8, 128)
#: P2's array: the script's rows x lanes, about 1e7 lanes
OP_SHAPE = (78336, 128)
#: the script's OPS, in its order (the kernel's template argument is the index)
OPS = ("fma", "mul", "div", "sqrt", "rsqrt", "recip", "recip_approx", "select", "abs_cmp")
#: the script's op counts (its slope is taken between them), and the larger
#: counts that leave the memory floor on this card
SCRIPT_N_OPS = (8, 40)
N_OPS_SWEEP = (0, 8, 40, 200, 400)
#: P3's rays (the script's N) and its bytes per ray: 6 float32 in, 9 float32
#: and one int8 out (the script's 6 * 4 + 8 * 4 + 1 + 4)
N_RAYS = 10_000_000
COPY_BYTES_PER_RAY = 6 * 4 + 9 * 4 + 1
#: K4's chain subsets of the script (:59-64): element slices of the flagship
SUBSETS = (("full (mask + 2 toroids)", slice(0, 3)), ("mask only", slice(0, 1)),
           ("1 toroid", slice(1, 2)), ("2 toroids", slice(1, 3)))

#: the script's constants as float32 values (the kernel's literals)
_A = float(np.float32(1.0000001))
_B = float(np.float32(1e-7))

_bound_lib = None


def _bind(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.art_cost_op_count.argtypes = []
    lib.art_cost_op_count.restype = ci
    if lib.art_cost_op_count() != len(OPS):
        raise RuntimeError(f"the library's P2 has {lib.art_cost_op_count()} ops, this module "
                           f"{len(OPS)}")
    lib.art_launch_add_one.argtypes = [vp, vp, ci, vp]
    lib.art_launch_op_chain.argtypes = [ci, vp, vp, ci, ci, vp]
    lib.art_launch_copy_streams.argtypes = [vp, vp, ci, vp]
    for name in ("art_launch_add_one", "art_launch_op_chain", "art_launch_copy_streams"):
        getattr(lib, name).restype = ci
    return lib


def _lib():
    """The kernel library with the probes' entry points bound (once)."""
    global _bound_lib
    lib = _cuda.library()
    if _bound_lib is not lib:
        _bound_lib = _bind(lib)
    return lib


# ---------------------------------------------------------------------------
# P1
# ---------------------------------------------------------------------------


def add_one_ref(x):
    """Plain version of P1: ``x + 1``."""
    return x + 1.0


def _add_one_on(lib, x):
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        _cuda._check(lib, lib.art_launch_add_one(
            x.data_ptr(), out.data_ptr(), x.numel(), _stream(x)), "add_one launch")
    add_one.launches += 1
    return out


def add_one(x):
    """P1 (replaces ``bench.py::warmup_mosaic``'s ``add_one``): ``x + 1``.
    CPU tensors take :func:`add_one_ref`; CUDA tensors launch
    ``add_one_kernel``."""
    if x.device.type == "cpu":
        return add_one_ref(x)
    _check_f32("P1", x)
    return _add_one_on(_lib(), x)


add_one.launches = 0


def first_launch_seconds(*, device):
    """Seconds from loading a fresh copy of the built kernel library to the
    first finished launch of P1 on ``device`` (the counterpart of the
    one-time warm-up the JAX probe absorbed; the build is not included: see
    ``ops/_cuda.build_seconds``). Returns ``(seconds, input, output)``."""
    built = _cuda._build()
    x = torch.zeros(TILE, dtype=torch.float32, device=device)
    torch.cuda.synchronize(device)
    copy = built.with_name(f"probe_{os.getpid()}_{time.perf_counter_ns()}.so")
    shutil.copyfile(built, copy)
    try:
        t0 = time.perf_counter()
        lib = _bind(ctypes.CDLL(str(copy)))
        out = _add_one_on(lib, x)
        torch.cuda.synchronize(device)
        seconds = time.perf_counter() - t0
    finally:
        copy.unlink()
    return seconds, x, out


def launch_latency_us(x, reps=5, inner=20):
    """Steady launch latency of P1 [µs]: the median over ``reps`` CUDA-event
    windows of ``inner`` back-to-back launches on ``x``."""
    return time_ms(lambda: add_one(x), reps=reps, inner=inner) * 1e3


def add_one_split(x, n=2000) -> dict:
    """P1's wrapper call on the CUDA tensor ``x`` taken apart: the host
    time per call [µs] of each of its pieces, each run ``n`` times alone
    after a warm-up, and of the whole wrapper and of ``x + 1`` (its plain
    version, one PyTorch call): the tensor checks (``_check_f32``), the
    output's allocation (``torch.empty_like``), the library lookup, the
    current stream's handle (``torch.cuda.current_stream(...).cuda_stream``),
    the device context (``torch.cuda.device``), the pointers' reads
    (``data_ptr``, ``numel``), the ctypes call into ``art_launch_add_one``
    with its arguments ready (the CUDA launch's own host work inside it) and
    the status check."""
    if x.device.type != "cuda":
        raise ValueError("add_one_split times the CUDA launch path: give it a CUDA tensor")
    lib = _lib()
    out = torch.empty_like(x)
    args = (x.data_ptr(), out.data_ptr(), x.numel(), _stream(x))

    def device_context():
        with torch.cuda.device(x.device):
            pass

    pieces = {
        "checks": lambda: _check_f32("P1", x),
        "allocation": lambda: torch.empty_like(x),
        "library": _lib,
        "stream": lambda: _stream(x),
        "device context": device_context,
        "pointers": lambda: (x.data_ptr(), out.data_ptr(), x.numel()),
        "ctypes launch": lambda: lib.art_launch_add_one(*args),
        "status check": lambda: _cuda._check(lib, 0, "add_one launch"),
        "wrapper": lambda: add_one(x),
        "x + 1": lambda: add_one_ref(x),
    }
    times = {}
    for name, fn in pieces.items():
        fn()
        torch.cuda.synchronize(x.device)
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        times[name] = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize(x.device)
    return times


def queued_us(fn, n=200, hold_ms=20.0):
    """Device time per call of ``fn`` [µs] with the host's work hidden: the
    stream is held busy (``torch.cuda._sleep``, ``hold_ms``) while ``n``
    calls are queued behind it, so CUDA events around them read the card
    running the calls back to back, without the host's binding and enqueue
    between them. Raises if the queueing outlasted the hold (the reading
    would then be the host's)."""
    fn()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    torch.cuda._sleep(1 << 20)
    stop.record()
    stop.synchronize()
    cycles = int((1 << 20) * hold_ms / start.elapsed_time(stop))
    torch.cuda._sleep(cycles)
    start.record()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    stop.record()
    stop.synchronize()
    if host_ms > 0.8 * hold_ms:
        raise RuntimeError(f"queueing {n} calls took {host_ms:.1f} ms of a {hold_ms} ms hold")
    return start.elapsed_time(stop) / n * 1e3


# ---------------------------------------------------------------------------
# P2
# ---------------------------------------------------------------------------


def _fma_ref(v):
    # one rounding, as fmaf: the float32 product is exact in float64
    return (v.double() * _A + _B).float()


_OP_REFS = {
    "fma": _fma_ref,
    "mul": lambda v: v * _A,
    "div": lambda v: v / (v + 1.0),
    "sqrt": lambda v: torch.sqrt(v + 1.0),
    "rsqrt": lambda v: torch.rsqrt(v + 1.0),
    "recip": lambda v: torch.reciprocal(v + 1.0),
    # the exact reciprocal: the kernel's approximate one is within 1e-5 of it
    "recip_approx": lambda v: torch.reciprocal(v + 1.0),
    "select": lambda v: torch.where(v > 0.5, v * _A, v + _B),
    "abs_cmp": lambda v: torch.abs(v) + (v > 1.0).to(v.dtype),
}


def _check_op(op, n_ops):
    if op not in OPS or n_ops < 0:
        raise ValueError(f"P2 takes an op of {OPS} and n_ops >= 0, got {op!r}, {n_ops}")


def op_chain_ref(op: str, x, n_ops: int):
    """Plain version of P2: ``n_ops`` dependent applications of the script's
    ``op`` to every element of ``x`` (float32)."""
    _check_op(op, n_ops)
    v, fn = x, _OP_REFS[op]
    for _ in range(n_ops):
        v = fn(v)
    return v.clone() if n_ops == 0 else v


def op_chain(op: str, x, n_ops: int, out=None):
    """P2 (replaces ``scripts/diag_vpu_ops.py::make_kernel``'s body):
    :func:`op_chain_ref` of ``x``. CPU tensors take the plain version; CUDA
    tensors launch ``op_chain_kernel<op>`` (into ``out`` if given)."""
    _check_op(op, n_ops)
    if x.device.type == "cpu":
        return op_chain_ref(op, x, n_ops)
    out = torch.empty_like(x) if out is None else out
    _check_f32("P2", x, out)
    lib = _lib()
    with torch.cuda.device(x.device):
        _cuda._check(lib, lib.art_launch_op_chain(
            OPS.index(op), x.data_ptr(), out.data_ptr(), x.numel(), int(n_ops), _stream(x)),
            "op_chain launch")
    op_chain.launches += 1
    return out


op_chain.launches = 0


def op_inputs(shape=OP_SHAPE, *, device, seed=0):
    """P2's input: uniform in [0, 2), so the selects of ``select`` and
    ``abs_cmp`` take both sides (the script fills 1.234)."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(0.0, 2.0, shape).astype(np.float32)).to(device)


def _slope_time(step_fn, arg, k_lo=1, k_hi=5, rounds=6):
    """Slope-only timing (``bench.py::_slope_time``): per-call seconds =
    (min t(k_hi) - min t(k_lo)) / (k_hi - k_lo), each ``t(k)`` the host
    clock around ``step_fn(arg, k)``, which runs k calls and waits for them,
    the minima taken separately before subtracting."""

    def timed(reps: int) -> float:
        t0 = time.perf_counter()
        v = float(step_fn(arg, reps))
        assert np.isfinite(v)
        return time.perf_counter() - t0

    timed(k_lo)
    timed(k_hi)
    lo = min(timed(k_lo) for _ in range(rounds))
    hi = min(timed(k_hi) for _ in range(rounds))
    return (hi - lo) / (k_hi - k_lo)


def _op_seconds(op, n_ops, x, out, rounds):
    """Per-launch seconds of P2 at ``n_ops``, slope-timed over launches."""
    def step(arg, reps):
        for _ in range(reps):
            op_chain(op, arg, n_ops, out=out)
        torch.cuda.synchronize(arg.device)
        return out[0, 0]

    return _slope_time(step, x, rounds=rounds)


def op_costs(*, device, ops=OPS, n_ops_sweep=N_OPS_SWEEP, rounds=4):
    """P2 timed as the script times it, on ``device``: per op and per
    ``n_ops`` of ``n_ops_sweep`` the slope-timed seconds of one launch over
    :data:`OP_SHAPE`; per op the script's slope [ms per op over the array]
    between its two op counts, the slope between the two largest counts,
    and the 0-op memory floor [ms]. Returns a dict by op."""
    x = op_inputs(device=device)
    out = torch.empty_like(x)
    res = {}
    for op in ops:
        t = {n: _op_seconds(op, n, x, out, rounds) for n in n_ops_sweep}
        lo, hi = SCRIPT_N_OPS
        big = sorted(n_ops_sweep)[-2:]
        res[op] = {
            "ms_at": {n: s * 1e3 for n, s in t.items()},
            "ms_per_op": (t[hi] - t[lo]) / (hi - lo) * 1e3,
            "ms_per_op_large": (t[big[1]] - t[big[0]]) / (big[1] - big[0]) * 1e3,
            "floor_ms": t[0] * 1e3 if 0 in t else None,
        }
    return res


# ---------------------------------------------------------------------------
# P3
# ---------------------------------------------------------------------------


def copy_streams_ref(ins):
    """Plain version of P3: the six input streams copied, then opl, opl_c
    (float32 zeros), alive (int8 ones) and incidence (float32 zeros)."""
    zeros = torch.zeros_like(ins[0])
    return (*(x.clone() for x in ins), zeros, zeros.clone(),
            torch.ones(ins[0].shape, dtype=torch.int8, device=ins[0].device), zeros.clone())


def prepare_copy_streams(ins):
    """P3's host work on a card: the outputs and the pointer tables.
    Returns ``(outputs, launch)``; each ``launch()`` runs
    ``copy_streams_kernel`` once."""
    if len(ins) != 6:
        raise ValueError(f"P3 copies 6 streams, got {len(ins)}")
    _check_f32("P3", *ins)
    n = ins[0].numel()
    if any(x.shape != ins[0].shape for x in ins):
        raise ValueError("P3's streams must share one shape")
    like = ins[0]
    outs = (*(torch.empty_like(like) for _ in range(8)),
            torch.empty(like.shape, dtype=torch.int8, device=like.device), torch.empty_like(like))
    in_ptrs = (ctypes.c_void_p * 6)(*(x.data_ptr() for x in ins))
    out_ptrs = (ctypes.c_void_p * 10)(*(x.data_ptr() for x in outs))
    lib = _lib()

    def launch():
        with torch.cuda.device(ins[0].device):
            _cuda._check(lib, lib.art_launch_copy_streams(
                ctypes.addressof(in_ptrs), ctypes.addressof(out_ptrs), n, _stream(ins[0])),
                "copy_streams launch")
        copy_streams.launches += 1

    return outs, launch


def copy_streams(ins):
    """P3 (replaces ``scripts/diag_kernel_cost.py::copy_kernel``): CPU
    tensors take :func:`copy_streams_ref`; CUDA tensors launch
    ``copy_streams_kernel``. Returns (px, py, pz, dx, dy, dz, opl, opl_c,
    alive, incidence)."""
    if ins[0].device.type == "cpu":
        return copy_streams_ref(ins)
    outs, launch = prepare_copy_streams(ins)
    launch()
    return outs


copy_streams.launches = 0


def source_streams(n_rays=N_RAYS, *, device):
    """The flagship's fresh source bundle of ``n_rays`` on ``device`` and its
    six component streams (P3's inputs)."""
    from ..ops import fused_trace as ft
    from .kernel_ab import flagship

    _els, spec = flagship()
    bundle = ft.source_bundle(spec, n_rays, device=device)
    streams = tuple(c.contiguous() for c in (*bundle.p.unbind(1), *bundle.d.unbind(1)))
    return bundle, streams


def kernel_cost(*, device, n_rays=N_RAYS):
    """The script's decomposition on ``device``: launch-only times [ms] of K4
    (fresh bundle) on the flagship chain's :data:`SUBSETS` and of the copy
    floor P3 over the same rays, the floor's rate, and K4's compute share
    ``(K4 - copy) / K4`` on the full chain. Returns a dict."""
    from ..ops import fused_trace as ft
    from .kernel_ab import flagship

    els, _spec = flagship()
    bundle, streams = source_streams(n_rays, device=device)
    times = {}
    for name, sl in SUBSETS:
        _, launch = ft.prepare_streamed_trace(ft.chain_table(None, els[sl]), bundle, fresh=True,
                                              device=device)
        times[name] = time_ms(launch)
    _, launch = prepare_copy_streams(streams)
    copy_ms = time_ms(launch)
    full = times[SUBSETS[0][0]]
    return {"k4_ms": times, "copy_ms": copy_ms,
            "copy_gb_per_s": COPY_BYTES_PER_RAY * n_rays / (copy_ms * 1e-3) / 1e9,
            "compute_share": (full - copy_ms) / full,
            "mask_ms": times["mask only"] - copy_ms, "toroid_ms": times["1 toroid"] - copy_ms,
            "second_toroid_ms": times["2 toroids"] - times["1 toroid"]}


def probe(*, device, op_shape=(128, 128), n_rays=4096):
    """The probes' run: P1 on its tile, P2 every op at the script's op
    counts on an ``op_shape`` array (the script's: :data:`OP_SHAPE`), P3 on
    ``n_rays`` rays of the flagship's source (the script's: :data:`N_RAYS`).
    Returns ``{name: (inputs, output)}`` for holding each against its plain
    version."""
    x1 = torch.arange(TILE[0] * TILE[1], dtype=torch.float32, device=device).reshape(TILE)
    runs = {"P1": ((x1,), add_one(x1))}
    x2 = op_inputs(op_shape, device=device)
    for op in OPS:
        for n in SCRIPT_N_OPS:
            runs[f"P2 {op} {n}"] = ((op, x2, n), op_chain(op, x2, n))
    _bundle, streams = source_streams(n_rays, device=device)
    runs["P3"] = (streams, copy_streams(streams))
    return runs


def main():
    if not torch.cuda.is_available():
        raise SystemExit("the cost probes run on a CUDA card")
    dev = torch.device("cuda", 0)
    seconds, x, out = first_launch_seconds(device=dev)
    print(f"P1 first launch from a fresh library load: {seconds:.4f} s, equal "
          f"{bool(torch.equal(out, add_one_ref(x)))}; steady launch "
          f"{launch_latency_us(x):.2f} us; on the card, queued: {queued_us(lambda: add_one(x)):.2f} us "
          f"(x + 1: {queued_us(lambda: add_one_ref(x)):.2f} us)")
    for op, row in op_costs(device=dev).items():
        print(f"P2 {op:12s}: {row['ms_per_op']:8.5f} ms per op over {OP_SHAPE[0] * OP_SHAPE[1]} lanes "
              f"(n_ops {SCRIPT_N_OPS}), {row['ms_per_op_large']:8.5f} (n_ops {N_OPS_SWEEP[-2:]}); "
              + ", ".join(f"{n}: {ms:.4f} ms" for n, ms in row["ms_at"].items()))
    cost = kernel_cost(device=dev)
    for name, ms in cost["k4_ms"].items():
        print(f"K4 {name:24s}: {ms:.4f} ms per {N_RAYS} rays")
    print(f"P3 copy floor: {cost['copy_ms']:.4f} ms ({cost['copy_gb_per_s']:.0f} GB/s at "
          f"{COPY_BYTES_PER_RAY} B/ray); K4 compute share {cost['compute_share'] * 100:.1f} %")


if __name__ == "__main__":
    sys.exit(main())
