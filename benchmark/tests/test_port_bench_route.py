"""The route by name leaves the three cells' checks as they were: each cell
driven on the CPU at the small size, on a fixed seed, for one request (a
window far shorter than one request), reads every check number exactly as
the harness before the route gave it (recorded at commit 408de3a, where the
harness built every optic as a toroid or a mask itself and took the
comparisons from one table)."""

import pytest

from cells_small import ROOT, kernel_engines, overrides
from benchmark import harness

SEEDS = {"fxf.design": 11, "fxf.align": 12, "fxf.image": 13}

#: ``checks`` values of ``harness.run_cell(bench, cell, SEEDS[cell], 1e-3,
#: False, device="cpu", overrides=...)`` at commit 408de3a
RECORDED = {
    "fxf.design": {
        "r0.placement": 3.979039320256561e-12,
        "r0.source": 2.8299090230454044e-13,
        "r0.rays_alive": 0.0,
        "r0.rays_position": 0.0013959730083351884,
        "r0.rays_direction": 5.179604598448684e-06,
        "r0.rays_path": 2.3623417168753424,
        "r0.transmission": 5.0914366056531435e-09,
        "r0.distance": 0.003887986107258712,
        "r0.spot": 0.0006000695890331365,
        "r0.duration": 0.0004946240769131416,
    },
    "fxf.align": {
        "r0.loss": 4.972959911864194e-06,
        "r0.poses": 2.8873840293487715e-05,
    },
    "fxf.image": {
        "r0.extent": 0.0888520872329234,
        "r0.sum_w": 1.5469045822058547e-08,
        "r0.image": 0.0017690527368417826,
        "r0.delay": 0.022803870933665427,
    },
}


@pytest.mark.parametrize("cell", sorted(RECORDED))
def test_check_numbers_unchanged(cell):
    bench = harness.load_benchmark(ROOT)
    with kernel_engines():
        res = harness.run_cell(bench, cell, SEEDS[cell], 1e-3, False, device="cpu",
                               overrides=overrides(bench.cell(cell)))
    assert res["attempted"] == 1
    assert res["correct"]
    assert {k: c["value"] for k, c in res["checks"].items()} == RECORDED[cell]
