"""The control, the reference put in the program's place one precision
below the configurations' (rays in bfloat16, host scene and statistics in
float32), fails every cell's check at a small size; ``benchmark/control.py``
takes the same readings on the card at the cells' own sizes."""

import json

import pytest

from cells_small import ROOT, bench as load_bench, kernel_engines, overrides
from benchmark import control, harness


@pytest.mark.parametrize("cell", ["fxf.design", "fxf.align", "fxf.image", "fxf.scan"])
def test_control_fails_the_check(cell):
    bench = load_bench()
    limits = json.loads((ROOT / "benchmark" / "limits" / f"{cell}.json").read_text())
    with kernel_engines():
        got = control.readings(bench, cell, [7], [7, 8], device="cpu",
                               overrides=overrides(bench.cell(cell)), log=lambda _s: None)
    assert all(not v > limits[k] for k, v in got["program"][0].items()), got["program"]
    for numbers in got["control"]:
        assert "crashed" not in numbers
        assert any(v > limits[k] for k, v in numbers.items()), numbers
