"""The benchmark harness: one run of one cell of ``BENCHMARK.json``.

Everything that belongs to one configuration, traffic mix or metric sits
in a file of its own, found by the name ``BENCHMARK.json`` gives it:

* ``benchmark/configs/<config>.json`` (the entry's ``file``): the chain;
* ``benchmark/traffic/<traffic>.json``: the request kind, its fixed
  parameters, the draws the generator makes from the seed, and optionally
  the warm-up request's parameters (``warm``) and the host's thread count
  (``host_threads``);
* ``benchmark/kinds/<kind>.py``: the program's side of a kind of request
  (``Kind``) and the numbers its check compares (``compare``);
* ``benchmark/optics/<kind>.py``, ``benchmark/defects/<kind>.py``,
  ``benchmark/sources/<kind>.py``: what one kind of optic, defect or source
  that a configuration names brings to the port's chain, the reference and
  the work model;
* ``benchmark/metrics/<metric>.py``: one reader per metric, ``read(run)``
  returning a number, or None where it finds nothing to read;
* ``benchmark/limits/<cell>.json``: the limit of every number that decides
  ``correct``.

A run: set-up (the program loaded, the chain placed, every shape warmed up
by one request), then a closed loop of one request in flight for
``--seconds``, each request drawn from the seed, of which a sample drawn
from the seed is kept (``Kind.keep``); then the memory peak, each kept
request's answer (``Kind.answer``: what needs no timing, such as a read of
the source, is deferred to here), its check against the plain reference,
and one JSON line. ``--trace 1`` records the device's activity over the
window with ``torch.profiler`` and reports the per-layer metrics instead of
the end-to-end ones.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import os
import statistics
import sys
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np

#: top-level module names that may not be loaded once the window closes
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "attosecondraytracing_tpu", "matplotlib")
#: a share of a roofline or of a peak above this is a fault of the count
PEAK_SHARE_LIMIT = 105.0
MARKER = "spin_kernel"
#: marker kernels at each end of a traced window
MARKS_PER_END = 3


class Benchmark(NamedTuple):
    root: Path
    spec: dict

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise SystemExit(f"no configuration {name!r} in BENCHMARK.json")

    def bench_file(self, *parts) -> Path:
        return self.root / "benchmark" / Path(*parts)

    def metrics_of(self, cell: str, section: str) -> list:
        """The metrics of ``section`` this cell reports: those listing it,
        and those without a ``workloads`` key."""
        return [m for m in self.spec[section] if cell in m.get("workloads", [cell])]


def load_benchmark(root) -> Benchmark:
    root = Path(root)
    return Benchmark(root, json.loads((root / "BENCHMARK.json").read_text()))


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_kind(kind: str):
    """``benchmark/kinds/<kind>.py`` (the kinds import the reference relative
    to the ``benchmark`` package): its ``Kind`` class and ``compare``."""
    from . import kinds

    return kinds.kind(kind)


# ---------------------------------------------------------------------------
# the traffic generator
# ---------------------------------------------------------------------------


def draw_requests(traffic: dict, cfg: dict, rng):
    """Endless requests of a traffic file: its ``fixed`` parameters and one
    draw per ``draw`` entry: ``{"uniform": [lo, hi]}``,
    ``{"uniform_from_config": key}`` over the range the configuration's
    ``key`` ends in, or ``{"choice": [v, ...]}``, one of the values."""
    fixed = dict(traffic.get("fixed", {}))
    while True:
        req = dict(fixed)
        for key, law in traffic.get("draw", {}).items():
            if "choice" in law:
                req[key] = law["choice"][int(rng.integers(0, len(law["choice"])))]
                continue
            if "uniform" in law:
                lo, hi = law["uniform"]
            else:
                lo, hi = cfg[law["uniform_from_config"]][-1]
            req[key] = float(rng.uniform(lo, hi))
        yield req


class Reservoir:
    """A uniform sample of ``k`` items of a stream of unknown length, drawn
    from its own generator (so the sample follows from the seed)."""

    def __init__(self, k: int, rng):
        self.k, self.rng, self.items, self.seen = k, rng, [], 0

    def wants(self) -> int | None:
        """The slot the next item takes, or None; call once per item."""
        i = self.seen
        self.seen += 1
        if i < self.k:
            return i
        j = int(self.rng.integers(0, i + 1))
        return j if j < self.k else None

    def put(self, slot: int, item) -> None:
        if slot == len(self.items):
            self.items.append(item)
        else:
            self.items[slot] = item


# ---------------------------------------------------------------------------
# spans and the device trace
# ---------------------------------------------------------------------------


class Spans:
    """Host spans (name, start, end) on ``time.perf_counter``."""

    def __init__(self):
        self.records = []

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.records.append((name, t0, time.perf_counter()))


class DeviceWindow(NamedTuple):
    """What the device did over the traced window, on the host's clock:
    ``events`` (name, start, end) of every kernel and copy, ``window``
    (start, end)."""

    events: list
    window: tuple

    def busy_intervals(self) -> list:
        """The union of the events' intervals inside the window."""
        lo, hi = self.window
        spans = sorted((max(s, lo), min(e, hi)) for _n, s, e in self.events if e > lo and s < hi)
        merged = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [tuple(m) for m in merged]

    def busy_seconds(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def window_seconds(self) -> float:
        return self.window[1] - self.window[0]

    def gaps(self) -> list:
        """Idle intervals (start, end) of the window."""
        lo, hi = self.window
        out, t = [], lo
        for s, e in self.busy_intervals():
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if hi > t:
            out.append((t, hi))
        return out


def clock_offset(host_marks, device_marks, inside: float) -> tuple:
    """(offset, drift) [s] that put device times on the host's clock.
    ``host_marks``: the host times of the marker kernels launched at the
    window's start and at its end (two lists); ``device_marks``: the start
    times of the marker kernels the trace holds; ``inside``: a device time
    between the two ends. The markers found before ``inside`` belong to the
    start, the others to the end, each end's last found matched with its
    last launched. The offset is the start's, else the end's; the drift the
    end's less the start's, 0 where only one end holds a marker."""
    if not device_marks:
        raise RuntimeError("the device trace holds no marker kernel")
    ends = ([d for d in device_marks if d < inside], [d for d in device_marks if d >= inside])
    offsets = [host[-1] - max(found) for host, found in zip(host_marks, ends) if found]
    return offsets[0], offsets[-1] - offsets[0]


class DeviceTrace:
    """``torch.profiler`` over the window with the card's activity only
    (the host's op events would cost the host-bound paths more than they
    measure). Its timestamps are put on the host's clock by marker kernels
    launched on an idle device at known host times, ``MARKS_PER_END`` at
    each end of the window: the trace has been seen to lose one."""

    def __init__(self, torch):
        self.torch = torch
        self.prof = None
        self.marks = []

    def _mark(self):
        torch = self.torch
        torch.cuda.synchronize()
        times = []
        for _ in range(MARKS_PER_END):
            times.append(time.perf_counter())
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        self.marks.append(times)

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self._mark()
        return self

    def __exit__(self, *exc):
        self._mark()
        self.prof.__exit__(*exc)
        return False

    def window(self, t0: float, t1: float) -> DeviceWindow:
        """The device's events between host times ``t0`` and ``t1``."""
        cuda = self.torch.autograd.DeviceType.CUDA
        events, marks = [], []
        # the raw kineto events: the profiler's own event tree would cost
        # minutes on a window of a million launches
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != cuda:
                continue
            start, end = e.start_ns() * 1e-9, e.end_ns() * 1e-9
            if MARKER in e.name():
                marks.append(start)
            else:
                events.append((e.name(), start, end))
        # every kernel of the window runs after the start's markers and
        # before the end's: each end synchronizes around its own
        inside = events[0][1] if events else 0.5 * (min(marks, default=0.0)
                                                    + max(marks, default=0.0))
        offset, drift = clock_offset(self.marks, marks, inside)
        print(f"[bench] device trace: {len(events)} device events, {len(marks)} of "
              f"{2 * MARKS_PER_END} marker kernels, clock offset drift {drift * 1e6:.1f} us "
              "over the window", file=sys.stderr, flush=True)
        return DeviceWindow([(n, s + offset, e + offset) for n, s, e in events], (t0, t1))


def short_name(name: str) -> str:
    """A kernel's name without its argument list."""
    return name.split("(", 1)[0][:160]


def breakdown(device: DeviceWindow, spans: list, request_span: str) -> dict:
    """The ten device operations that took most time, and the ten longest
    idle gaps, each labelled by what the host was doing: the layer span
    covering at least half of the gap and most of it, else the span that
    overlaps it most (the request's own, ``request_span``)."""
    per_op = {}
    lo, hi = device.window
    for name, s, e in device.events:
        if e > lo and s < hi:
            key = short_name(name)
            per_op[key] = per_op.get(key, 0.0) + (min(e, hi) - max(s, lo))
    ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:10]

    def label(g0, g1):
        overlap = [(min(e, g1) - max(s, g0), e - s, n) for n, s, e in spans if s < g1 and e > g0]
        if not overlap:
            return "between requests"
        inner = [o for o in overlap if o[2] != request_span and o[0] >= 0.5 * (g1 - g0)]
        return max(inner or overlap, key=lambda o: (o[0], -o[1]))[2]

    gaps = sorted(device.gaps(), key=lambda g: g[0] - g[1])[:10]
    return {"device_ops": [[n, v] for n, v in ops],
            "idle_gaps": [[label(s, e), e - s] for s, e in gaps]}


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------


class Request(NamedTuple):
    start: float
    end: float
    units: int


class Run(NamedTuple):
    """What a metric reader reads: the cell, the finished requests of the
    window, the set-up seconds, the host spans, and in a traced run the
    device's window and each request's least seconds of the work model."""

    cell: str
    kind: str
    requests: list
    setup_s: float
    spans: list
    device: DeviceWindow | None
    least_seconds: list | None


def read_metrics(bench: Benchmark, cell: str, section: str, run: Run) -> dict:
    """Each metric of ``section`` for this cell, from its reader; a metric
    whose reader finds nothing is left out. A share of a roofline or of a
    peak above 105 % is an error of the work count or of the time."""
    out = {}
    for m in bench.metrics_of(cell, section):
        path = bench.bench_file("metrics", m["name"] + ".py")
        module = "benchmark_metric_" + m["name"].replace(".", "_").replace("-", "_")
        reader = load_module(path, module)
        value = reader.read(run)
        if value is None:
            continue
        value = float(value)
        if m["unit"] == "%" and ("roofline" in m["name"] or "mfu" in m["name"]) \
                and not value <= PEAK_SHARE_LIMIT:
            raise ValueError(f"{m['name']} reads {value} %: above {PEAK_SHARE_LIMIT} % of the "
                             "peak, the work is counted too high or the time leaves work out")
        out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


class Cell(NamedTuple):
    """A cell's entry, configuration, traffic and limits, as one run uses
    them."""

    entry: dict
    cfg: dict
    traffic: dict
    limits: dict


def load_cell(bench: Benchmark, cell_name: str, overrides: dict | None = None) -> Cell:
    """The cell's files; ``overrides`` replace top-level keys of the
    configuration (``"config"``), keys of its source (``"source"``) and the
    traffic's ``fixed`` parameters (``"fixed"``)."""
    overrides = overrides or {}
    entry = bench.cell(cell_name)
    cfg = bench.config(entry["config"])
    cfg.update(overrides.get("config", {}))
    if "source" in overrides:
        cfg["source"] = dict(cfg["source"], **overrides["source"])
    traffic = json.loads(bench.bench_file("traffic", entry["traffic"] + ".json").read_text())
    traffic["fixed"] = dict(traffic.get("fixed", {}), **overrides.get("fixed", {}))
    limits = json.loads(bench.bench_file("limits", cell_name + ".json").read_text())
    return Cell(entry, cfg, traffic, limits)


def start_kind(cell: Cell, device, rng):
    """The traffic's kind set up on ``device`` and warmed up by one request
    drawn from ``rng``, with the traffic's ``warm`` parameters (the same
    shapes, fewer repeats) over it."""
    kind = load_kind(cell.traffic["kind"]).Kind(cell.cfg, cell.traffic, device=device, rng=rng)
    warm = dict(next(draw_requests(cell.traffic, cell.cfg, rng)), **cell.traffic.get("warm", {}))
    kind.serve(warm, None)
    return kind


class GcPauses:
    """Seconds the host spent in Python's garbage collector while on."""

    def __init__(self):
        self.seconds, self.count, self._t = 0.0, 0, None

    def __call__(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.seconds += time.perf_counter() - self._t
            self.count += 1
            self._t = None


def forbidden_modules(names=None) -> list:
    """The forbidden top-level names among ``names`` (default: the loaded
    modules), each compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({name.split(".", 1)[0] for name in names} & set(FORBIDDEN_MODULES))


def run_cell(bench: Benchmark, cell_name: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", t_process: float | None = None, chips: int = 1,
             overrides: dict | None = None) -> dict:
    """One run of a cell; returns the result line's dict. ``overrides``
    replace top-level keys of the configuration and the traffic's
    ``fixed`` parameters (the CPU tests' small sizes)."""
    import torch

    import gc

    t_process = time.perf_counter() if t_process is None else t_process
    cell = load_cell(bench, cell_name, overrides)
    cfg, traffic, limits = cell.cfg, cell.traffic, cell.limits
    dev = torch.device(device)
    on_card = dev.type == "cuda"

    seeds = np.random.SeedSequence(int(seed)).spawn(3)
    requests_rng, sample_rng, setup_rng = (np.random.default_rng(s) for s in seeds)
    torch.manual_seed(int(seed) % (1 << 63))
    if "host_threads" in traffic:
        torch.set_num_threads(int(traffic["host_threads"]))
    kind = start_kind(cell, dev, setup_rng)
    if on_card:
        from attosecondraytracing_tpu_torch.ops import _cuda

        torch.cuda.synchronize()
        print(f"[bench] library build in this process: {_cuda.build_seconds:.3f} s",
              file=sys.stderr, flush=True)

    spans = Spans()
    done = []
    kept = Reservoir(int(traffic.get("checked_requests", 1)), sample_rng)
    gen = draw_requests(traffic, cfg, requests_rng)
    tracer = DeviceTrace(torch) if (trace and on_card) else None
    launches0 = _launch_count() if on_card else 0
    pauses = GcPauses()
    gc.callbacks.append(pauses)
    with tracer if tracer is not None else contextlib.nullcontext():
        t0 = time.perf_counter()
        setup_s = t0 - t_process
        while time.perf_counter() < t0 + seconds:
            req = next(gen)
            start = time.perf_counter()
            with spans.span(kind.span):
                raw = kind.serve(req, spans)
            end = time.perf_counter()
            done.append(Request(start, end, kind.units(raw)))
            slot = kept.wants()
            if slot is not None:
                kept.put(slot, (len(done) - 1, req, kind.keep(req, raw)))
            del raw
        t1 = time.perf_counter()
    gc.callbacks.remove(pauses)
    launches = (_launch_count() - launches0) if on_card else 0
    print(f"[bench] {len(done)} requests in {t1 - t0:.3f} s; kernel launches per request "
          f"{launches / max(len(done), 1):.3f}", file=sys.stderr, flush=True)
    print(f"[bench] host: {torch.get_num_threads()} torch threads on "
          f"{len(os.sched_getaffinity(0))} cores; garbage collector {pauses.count} passes, "
          f"{pauses.seconds:.3f} s in the window; {_walls(done)}", file=sys.stderr, flush=True)

    device_window = tracer.window(t0, t1) if tracer is not None else None
    if device_window is not None:
        print(f"[bench] {_launch_intervals(device_window)}", file=sys.stderr, flush=True)
    memory_peak = int(torch.cuda.max_memory_allocated()) if on_card else 0
    if on_card:
        torch.cuda.empty_cache()
    least = least_seconds(kind, traffic, cfg, seed, len(done)) if trace else None

    checks, failed = {}, 0
    judge = load_kind(traffic["kind"]).compare
    for index, req, item in kept.items:
        answer = kind.answer(req, item)
        expect = traffic.get("expect_engine")
        if on_card and expect is not None and answer.get("engine") != expect:
            checks[f"r{index}.engine_is_{expect}"] = {"value": 1.0, "limit": 0.0}
            failed += 1
            continue
        ref = kind.reference(req, answer, dtype=torch.float64, host_dtype=torch.float64,
                             device=dev)
        numbers = judge(answer, ref)
        bad = False
        for key, value in numbers.items():
            limit = float(limits[key])
            checks[f"r{index}.{key}"] = {"value": value, "limit": limit}
            bad |= not value <= limit
        failed += int(bad)
    correct = failed == 0 and bool(kept.items)

    run = Run(cell_name, traffic["kind"], done, setup_s, spans.records, device_window, least)
    section = "per_layer" if trace else "end_to_end"
    metrics = read_metrics(bench, cell_name, section, run)
    result = {"correct": correct, "attempted": len(done), "failed": failed, "metrics": metrics}
    name = torch.cuda.get_device_name(0) if on_card else "cpu"
    result["device"] = {"platform": "gpu" if on_card else "cpu", "kind": name, "count": chips,
                        "memory_peak_bytes": memory_peak}
    if device_window is not None:
        result["device"]["busy_s"] = device_window.busy_seconds()
        result["device"]["window_s"] = device_window.window_seconds()
        result["breakdown"] = breakdown(device_window, spans.records, kind.span)
    for key, c in checks.items():
        print(f"[check] {key} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    result["checks"] = checks
    return result


def _quartiles(values) -> str:
    if len(values) < 2:
        return "n/a"
    q = statistics.quantiles(values, n=4)
    return f"{q[0]:.4g} / {q[1]:.4g} / {q[2]:.4g}"


def _walls(done) -> str:
    """Quartiles of the requests' walls per unit [ms] and of the host's
    time between requests [ms]: where a run's time goes outside its
    requests."""
    per_unit = [1e3 * (r.end - r.start) / max(r.units, 1) for r in done]
    between = [1e3 * (b.start - a.end) for a, b in zip(done, done[1:])]
    return (f"request wall per unit quartiles {_quartiles(per_unit)} ms, between requests "
            f"{_quartiles(between)} ms")


def _launch_intervals(device: DeviceWindow) -> str:
    """Quartiles of the intervals [ms] between the starts of the kernel
    that took most device time (one launch per step or per request)."""
    totals = {}
    for name, s, e in device.events:
        totals[name] = totals.get(name, 0.0) + (e - s)
    if not totals:
        return "no device events"
    top = max(totals, key=totals.get)
    starts = sorted(s for n, s, _e in device.events if n == top)
    gaps = [1e3 * (b - a) for a, b in zip(starts, starts[1:])]
    return (f"{short_name(top)}: {len(starts)} launches, start-to-start quartiles "
            f"{_quartiles(gaps)} ms")


def least_seconds(kind, traffic, cfg, seed, n, most=8) -> list:
    """The work model's least seconds of each of the window's ``n``
    requests (as the seed drew them): exact for up to ``most`` of them,
    evenly spread, and their mean for the rest (a request's work moves
    with its draws only through the rays it loses)."""
    rng = np.random.default_rng(np.random.SeedSequence(int(seed)).spawn(3)[0])
    gen = draw_requests(traffic, cfg, rng)
    reqs = [next(gen) for _ in range(n)]
    picked = sorted({int(i) for i in np.linspace(0, n - 1, min(n, most))}) if n else []
    exact = {i: kind.least_seconds(reqs[i]) for i in picked}
    mean = float(np.mean(list(exact.values()))) if exact else 0.0
    return [exact.get(i, mean) for i in range(n)]


def _launch_count() -> int:
    from attosecondraytracing_tpu_torch.ops import fused_grad as fg
    from attosecondraytracing_tpu_torch.ops import fused_scan as fs
    from attosecondraytracing_tpu_torch.ops import fused_trace as ft

    counters = (ft.fused_source_trace, ft.prepare_fused_source_image, ft.fused_source_moments,
                ft.streamed_trace, fs.fused_scan_moments, fg.fused_stats_params,
                ft.fused_source_stats)
    total = sum(getattr(f, "launches", 0) for f in counters)
    return total + getattr(ft.streamed_trace, "fresh_launches", 0) \
        + getattr(fg.fused_stats_params, "primal_launches", 0)


def main(argv, t_process: float) -> int:
    parser = argparse.ArgumentParser(description="One run of one benchmark cell on the card.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    bench = load_benchmark(Path.cwd())
    cell = bench.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"[bench] this cell needs {cell['chips']} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}", file=sys.stderr)
        return 2
    with contextlib.redirect_stdout(sys.stderr):
        result = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                          t_process=t_process, chips=int(cell["chips"]))
    found = forbidden_modules()
    if found:
        print(f"[bench] modules that may not be loaded are loaded: {', '.join(found)}",
              file=sys.stderr, flush=True)
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0

