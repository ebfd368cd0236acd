#!/usr/bin/env python3
"""The readings a cell's limits are set from, in one process on the card:

    python3 benchmark/control.py --workload fxf.design --seeds 1-12 --control-seeds 1-3

For each of ``--seeds``: the seed's first request served by the program
through the cell's timed path at the cell's own size, and the numbers of its
kind's ``compare`` (``benchmark/kinds/<kind>.py``) against the float64
reference (the lower readings). For each of ``--control-seeds``: the
control, the reference put in the program's place and computed one
precision below the configuration's (its rays in bfloat16, its host scene
and statistics in float32), held the same way (the upper readings). Prints
one JSON line per reading, and the largest program reading and smallest
control reading of every number with the cell's limit."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import harness  # noqa: E402

#: the control's precisions, one step below the configurations' own: the
#: rays' trace in bfloat16 (the program traces in float32), the host scene,
#: the detector and the statistics in float32 (the program's are float64)
CONTROL_DTYPE = torch.bfloat16
CONTROL_HOST_DTYPE = torch.float32


def _seeds(text: str) -> list:
    out = []
    for part in text.split(","):
        if "-" in part:
            lo, hi = part.split("-")
            out.extend(range(int(lo), int(hi) + 1))
        elif part:
            out.append(int(part))
    return out


def first_request(traffic, cfg, seed):
    rng = np.random.default_rng(np.random.SeedSequence(int(seed)).spawn(3)[0])
    return next(harness.draw_requests(traffic, cfg, rng))


def readings(bench, cell_name, seeds, control_seeds, *, device="cuda", overrides=None,
             log=print) -> dict:
    """``{"program": [numbers per seed], "control": [numbers per seed]}``."""
    cell = harness.load_cell(bench, cell_name, overrides)
    cfg, traffic = cell.cfg, cell.traffic
    judge = harness.load_kind(traffic["kind"]).compare
    dev = torch.device(device)
    rng = np.random.default_rng(np.random.SeedSequence(int(seeds[0])).spawn(3)[2])
    kind = harness.start_kind(cell, dev, rng)
    out = {"program": [], "control": []}
    for seed in seeds:
        req = first_request(traffic, cfg, seed)
        t0 = time.perf_counter()
        answer = kind.answer(req, kind.keep(req, kind.serve(req, None)))
        t1 = time.perf_counter()
        numbers = judge(answer, kind.reference(req, answer, dtype=torch.float64,
                                               host_dtype=torch.float64, device=dev))
        log(json.dumps({"cell": cell_name, "side": "program", "seed": seed, "request": req,
                        "serve_s": t1 - t0, "reference_s": time.perf_counter() - t1,
                        "numbers": numbers}))
        out["program"].append(numbers)
    for seed in control_seeds:
        req = first_request(traffic, cfg, seed)
        t0 = time.perf_counter()
        try:
            low = kind.reference(req, None, dtype=CONTROL_DTYPE, host_dtype=CONTROL_HOST_DTYPE,
                                 device=dev)
            numbers = judge(low, kind.reference(req, low, dtype=torch.float64,
                                                host_dtype=torch.float64, device=dev))
        except (RuntimeError, ValueError, ZeroDivisionError) as exc:
            numbers = {"crashed": repr(exc)}
        log(json.dumps({"cell": cell_name, "side": "control", "seed": seed, "request": req,
                        "seconds": time.perf_counter() - t0, "numbers": numbers}))
        out["control"].append(numbers)
    return out


def summary(bench, cell_name, got: dict) -> dict:
    limits = json.loads(bench.bench_file("limits", cell_name + ".json").read_text())
    rows = {}
    for key, limit in limits.items():
        lower = [r[key] for r in got["program"] if key in r]
        upper = [r[key] for r in got["control"] if key in r]
        rows[key] = {"lower": max(lower) if lower else None,
                     "upper": min(upper) if upper else None, "limit": limit}
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control-seeds", default="")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("control readings are taken on the card", file=sys.stderr)
        return 2
    bench = harness.load_benchmark(os.getcwd())
    got = readings(bench, args.workload, _seeds(args.seeds), _seeds(args.control_seeds))
    print(json.dumps({"cell": args.workload, "summary": summary(bench, args.workload, got)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
