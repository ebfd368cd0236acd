"""The cost probes P1-P3 of the port (``utils/cost_probe.py``) against the
JAX package's probe kernels: each script's Pallas body runs through
``pl.pallas_call(..., interpret=True)`` on the CPU (P1 and P3 as the scripts
call them, recorded as they run; P2 on a (128, 128) tile of seeded inputs),
and the port's plain version on the same inputs. P1 and P3 must be equal;
P2 within 1e-6 relative per op at the script's 8 ops (the plain "fma" rounds
once, as the kernel's fmaf does, the interpreted body may round twice: 8
half-ulp steps stay below 1e-6), except ``recip_approx``: interpreted,
``pl.reciprocal(approx=True)`` rounds its input and its result to bfloat16
(jax/_src/pallas/primitives.py, the reciprocal's lowering), about 2^-8 per
op, which the contraction of 1 / (v + 1) (0.38 per op) bounds by 1e-2; the
plain version is the exact reciprocal, and the kernel's ``rcp.approx`` is
held within 1e-5 of it on the card (chip_smoke.py phase cost)."""

import importlib.util
import sys
from pathlib import Path

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
from jax.experimental import pallas as pl  # noqa: E402

from attosecondraytracing_tpu.ops import warmup as jwarmup  # noqa: E402
from attosecondraytracing_tpu_torch.utils import cost_probe as cp  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _load(path, name):
    """A script of the repository as a module (its ``from bench import``
    resolves against the repository root)."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _recording(calls):
    """A stand-in for ``pl.pallas_call`` that runs the kernel in interpret
    mode and records (kernel name, inputs, outputs) of each call as it runs
    (the scripts call it under ``jax.jit``: a debug callback sees the
    values)."""
    real = pl.pallas_call

    def pallas_call(kernel, **kw):
        kw["interpret"] = True
        call = real(kernel, **kw)

        def run(*args):
            out = call(*args)
            outs = out if isinstance(out, tuple) else (out,)

            def record(*vals):
                vals = [np.asarray(v) for v in vals]
                calls.append((kernel.__name__, vals[:len(args)], vals[len(args):]))

            jax.debug.callback(record, *args, *outs)
            return out

        return run

    return pallas_call


def test_p1_plain_matches_bench_add_one(monkeypatch):
    """bench.py's warm-up kernel as bench.py runs it (recorded, the module
    state it marks left untouched) against P1's plain version and its
    wrapper on the CPU (no launch)."""
    bench = _load(ROOT / "bench.py", "bench_for_p1")
    calls = []
    monkeypatch.setattr(pl, "pallas_call", _recording(calls))
    monkeypatch.setattr(jwarmup, "mark_warm", lambda: None)
    bench.warmup_mosaic(verbose=False)
    ((name, (x,), (ref,)),) = calls
    assert name == "add_one" and x.shape == cp.TILE
    cp.add_one.launches = 0
    got = cp.add_one(torch.from_numpy(x.copy())).numpy()
    assert cp.add_one.launches == 0
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(cp.add_one_ref(torch.from_numpy(x.copy())).numpy(), ref)


@pytest.fixture(scope="module")
def vpu_script():
    return _load(ROOT / "scripts" / "diag_vpu_ops.py", "diag_vpu_ops_for_p2")


@pytest.mark.parametrize("op", cp.OPS)
def test_p2_plain_matches_script_kernel(vpu_script, op):
    """The script's make_kernel(OPS[op], 8) on a (128, 128) tile of seeded
    inputs in [0, 2) (both sides of the selects), interpreted, against P2's
    plain version: within 1e-6 relative."""
    assert tuple(vpu_script.OPS) == cp.OPS
    n_ops = cp.SCRIPT_N_OPS[0]
    x = cp.op_inputs((vpu_script.BLOCK, vpu_script.LANES), device="cpu", seed=1).numpy()
    spec = pl.BlockSpec((vpu_script.BLOCK, vpu_script.LANES), lambda i: (i, 0))
    ref = np.asarray(pl.pallas_call(
        vpu_script.make_kernel(vpu_script.OPS[op], n_ops), grid=(1,), in_specs=[spec],
        out_specs=spec, out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
        interpret=True)(jnp.asarray(x)))
    cp.op_chain.launches = 0
    got = cp.op_chain(op, torch.from_numpy(x), n_ops).numpy()
    assert cp.op_chain.launches == 0 and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-2 if op == "recip_approx" else 1e-6, atol=0)
    assert not np.array_equal(got, x)


def test_p3_plain_matches_script_copy_kernel(monkeypatch):
    """diag_kernel_cost.py's copy kernel, recorded as the script's main()
    runs it at a small N (its device chain and K4 calls stubbed out, its
    slope timing one step), against P3's plain version: equal."""
    script = _load(ROOT / "scripts" / "diag_kernel_cost.py", "diag_kernel_cost_for_p3")
    n = 2000
    rng = np.random.default_rng(3)
    p = rng.normal(size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)

    class Source:
        pass

    source = Source()
    source.p, source.d = jnp.asarray(p), jnp.asarray(d)

    class Chain:  # stands in for ops/pallas_trace: no K4 runs here
        BLOCK_ROWS, LANES = 8, 128

        @staticmethod
        def _static_chain(els):
            return None, None, None, None

        @staticmethod
        def _pallas_trace_padded(*args, **kwargs):
            return ()

    def one_step(step_fn, arg, **kwargs):
        float(step_fn(arg, 1))
        return 1.0

    calls = []
    monkeypatch.setattr(pl, "pallas_call", _recording(calls))
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(script, "N", n)
    monkeypatch.setattr(script, "pt", Chain)
    monkeypatch.setattr(script, "build_device", lambda n_rays: (source, [0, 1, 2]))
    monkeypatch.setattr(script, "_slope_time", one_step)
    script.main()
    ((name, ins, outs),) = calls
    assert name == "copy_kernel" and len(ins) == 6 and len(outs) == 10
    cp.copy_streams.launches = 0
    got = cp.copy_streams([torch.from_numpy(a.reshape(-1).copy()) for a in ins])
    assert cp.copy_streams.launches == 0
    for g, r in zip(got, outs):
        assert g.numpy().dtype == r.dtype
        np.testing.assert_array_equal(g.numpy(), r.reshape(-1))
    np.testing.assert_array_equal(ins[0].reshape(-1)[:n], p[:, 0])  # the streams the script copies


def test_probe_runs_every_probe_on_the_cpu():
    """probe() runs P1, every P2 op at the script's op counts and P3 (plain
    versions here, no launch); an op or a stream count the probes do not
    know raises."""
    runs = cp.probe(device="cpu")
    assert set(runs) == {"P1", "P3"} | {f"P2 {op} {n}" for op in cp.OPS for n in cp.SCRIPT_N_OPS}
    assert cp.add_one.launches == cp.op_chain.launches == cp.copy_streams.launches == 0
    (x,), out = runs["P1"]
    assert torch.equal(out, x + 1)
    streams, outs = runs["P3"]
    assert len(outs) == 10 and outs[8].dtype == torch.int8 and bool((outs[8] == 1).all())
    with pytest.raises(ValueError):
        cp.op_chain("exp", streams[0], 8)
    with pytest.raises(ValueError):
        cp.op_chain("fma", streams[0], -1)
    assert cp.COPY_BYTES_PER_RAY == 61


def test_slope_time_is_the_bench_law(monkeypatch):
    """The module's copy of bench.py's _slope_time: (min t(k_hi) - min
    t(k_lo)) / (k_hi - k_lo) over the host clock, as bench.py's own gives
    on a step whose time is known (0.25 s of overhead, 0.5 s per call)."""
    bench = _load(ROOT / "bench.py", "bench_for_slope")

    class Clock:
        t = 0.0

        @classmethod
        def perf_counter(cls):
            return cls.t

    def step(arg, reps):
        Clock.t += 0.25 + 0.5 * reps
        return 1.0

    monkeypatch.setattr(cp, "time", Clock)
    monkeypatch.setattr(bench, "time", Clock)
    assert cp._slope_time(step, None) == pytest.approx(0.5)
    assert bench._slope_time(step, None, verbose=False) == pytest.approx(0.5)


def test_add_one_split_takes_the_launch_path_apart(monkeypatch):
    """P1's wrapper taken apart (cost_probe.add_one_split): on a CPU tensor
    it refuses (it times the CUDA launch path); with the card's pieces
    stood in for, it times each piece, the whole wrapper and x + 1, in µs
    per call on the host clock."""
    x = torch.zeros(cp.TILE, dtype=torch.float32)
    with pytest.raises(ValueError):
        cp.add_one_split(x)

    class Lib:
        def art_launch_add_one(self, *args):
            return 0

    fake = torch.zeros(cp.TILE, dtype=torch.float32)
    monkeypatch.setattr(type(fake), "device", property(lambda self: torch.device("cuda", 0)))
    monkeypatch.setattr(cp, "_lib", lambda: Lib())
    monkeypatch.setattr(cp, "_stream", lambda t: 0)
    monkeypatch.setattr(cp.torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(cp.torch.cuda, "device", lambda d: __import__("contextlib").nullcontext())
    monkeypatch.setattr(cp, "add_one", lambda t: t)
    times = cp.add_one_split(fake, n=3)
    assert list(times) == ["checks", "allocation", "library", "stream", "device context", "pointers",
                           "ctypes launch", "status check", "wrapper", "x + 1"]
    assert all(v >= 0 for v in times.values())
