"""Small sizes at which the CPU tests drive the cells: the configuration's
ray count and the traffic's fixed parameters replaced, the port's kernel
engines taken on the CPU (their plain versions) as they are on the card."""

from __future__ import annotations

import contextlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

OVERRIDES = {
    "design": {"source": {"NumberRays": 20000}},
    "align": {"source": {"NumberRays": 20000}, "fixed": {"iters": 3}},
    "image": {"source": {"NumberRays": 20000},
              "fixed": {"n_total": 1 << 17, "bins": [16, 16], "probe_rays": 1 << 17}},
    "scan": {"source": {"NumberRays": 20000}},
}


def overrides(cell: dict) -> dict:
    return OVERRIDES[cell["traffic"]]


def bench():
    """``BENCHMARK.json`` with the parked cells' entries
    (``benchmark/parked/<cell>.json``: a cell whose files are in place and
    tested, left out of ``BENCHMARK.json`` until its runs are steady) added
    to it, so that the tests drive those cells too."""
    from benchmark import harness

    loaded = harness.load_benchmark(ROOT)
    spec = json.loads(json.dumps(loaded.spec))
    for path in sorted((ROOT / "benchmark" / "parked").glob("*.json")):
        parked = json.loads(path.read_text())
        for section, entries in parked.items():
            names = {e["name"] for e in spec[section]}
            spec[section] += [e for e in entries if e["name"] not in names]
    return harness.Benchmark(loaded.root, spec)


@contextlib.contextmanager
def kernel_engines():
    """The port's fused engines for chains of any ray count (on the card they
    take the 1e7-ray chains; here their plain versions run)."""
    from attosecondraytracing_tpu_torch.models import chain

    saved = chain.PALLAS_MIN_RAYS
    chain.PALLAS_MIN_RAYS = 0
    try:
        yield
    finally:
        chain.PALLAS_MIN_RAYS = saved
