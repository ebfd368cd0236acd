#!/usr/bin/env python3
"""One run of one cell of BENCHMARK.json on the card:

    python3 benchmark/run.py --workload fxf.design --seed 7 --seconds 30 --trace 0

Run from the root of a checkout. The last line of standard output is the
result, one JSON object; everything else goes to standard error."""

import time

T_PROCESS = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_PROCESS))
