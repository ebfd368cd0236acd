"""A --trace 0 run of each traffic mix, in a fresh interpreter, leaves no
module loaded whose whole top-level name is jax, jaxlib, flax, matplotlib
or the JAX package (the port's name begins with the JAX package's, so
names are compared whole)."""

import json
import subprocess
import sys

import pytest

from cells_small import ROOT, OVERRIDES

SCRIPT = """
import json, sys
sys.path.insert(0, {root!r}); sys.path.insert(0, {tests!r})
from cells_small import bench as load_bench, kernel_engines
from benchmark import harness
bench = load_bench()
with kernel_engines():
    res = harness.run_cell(bench, {cell!r}, 9, 0.3, False, device="cpu", overrides={ov!r})
print(json.dumps({{"correct": res["correct"], "found": harness.forbidden_modules(),
                  "port": "attosecondraytracing_tpu_torch" in sys.modules}}))
"""


@pytest.mark.parametrize("cell,mix", [("fxf.design", "design"), ("fxf.align", "align"),
                                      ("fxf.image", "image"), ("fxf.scan", "scan")])
def test_run_imports_no_jax(cell, mix):
    code = SCRIPT.format(root=str(ROOT), tests=str(ROOT / "benchmark" / "tests"), cell=cell,
                         ov=OVERRIDES[mix])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["port"] and got["correct"]
    assert got["found"] == []


def test_top_level_names_compared_whole():
    from benchmark import harness

    names = ["attosecondraytracing_tpu_torch", "attosecondraytracing_tpu_torch.ops.trace",
             "jaxtyping", "flaxen.x"]
    assert harness.forbidden_modules(names) == []
    assert harness.forbidden_modules(names + ["jax._src.core"]) == ["jax"]
    assert harness.forbidden_modules(["attosecondraytracing_tpu.ops"]) == [
        "attosecondraytracing_tpu"]
