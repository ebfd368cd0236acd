"""A later change adds a cell as files and entries only: a traffic mix
(data), a per-layer metric (its reader), the cell's limits and its entries
in BENCHMARK.json; the harness finds and runs them by name, with no file
it already had edited."""

import hashlib
import json
import shutil

from cells_small import ROOT, kernel_engines
from benchmark import harness


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "benchmark").rglob("*")) if p.is_file()}


def test_cell_added_as_files(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = _digests(tmp_path)

    bench_dir = tmp_path / "benchmark"
    traffic = json.loads((bench_dir / "traffic" / "design.json").read_text())
    traffic["draw"] = {"second_distance_mm": {"uniform": [480.0, 520.0]}}
    (bench_dir / "traffic" / "design_near_focus.json").write_text(json.dumps(traffic))
    (bench_dir / "metrics" / "placement_share.design_near.py").write_text(
        "from benchmark import readers\n\n\n"
        "def read(run):\n"
        "    place = readers.span_ms(run, 'placement')\n"
        "    wall = readers.window_per_unit_s(run)\n"
        "    return None if place is None else 100.0 * place / (1e3 * wall)\n")
    shutil.copy(bench_dir / "limits" / "fxf.design.json",
                bench_dir / "limits" / "fxf.design_near.json")
    spec["workloads"].append({"name": "fxf.design_near", "config": "fxf_flagship",
                              "traffic": "design_near_focus", "chips": 1,
                              "why": "designs near the focal distance"})
    spec["per_layer"].append({"name": "placement_share.design_near", "unit": "%",
                              "better": "lower", "source": "program_span", "layer": "placement",
                              "moves": "design_s", "workloads": ["fxf.design_near"]})
    spec["end_to_end"][0]["workloads"].append("fxf.design_near")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    after = _digests(tmp_path)
    assert all(after[k] == v for k, v in before.items())
    bench = harness.load_benchmark(tmp_path)
    ov = {"source": {"NumberRays": 20000}}
    with kernel_engines():
        timed = harness.run_cell(bench, "fxf.design_near", 3, 0.3, False, device="cpu",
                                 overrides=ov)
        traced = harness.run_cell(bench, "fxf.design_near", 4, 0.3, True, device="cpu",
                                  overrides=ov)
    assert timed["correct"] and traced["correct"]
    assert set(timed["metrics"]) == {"design_s", "setup_s"}
    assert "placement_share.design_near" in traced["metrics"]
    assert 0.0 < traced["metrics"]["placement_share.design_near"]["value"] <= 100.0
