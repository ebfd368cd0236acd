"""A later change adds a cell as files and entries only: a traffic mix
(data), a per-layer metric (its reader), the cell's limits and its entries
in BENCHMARK.json; or, beside them, a new kind of optic and a new kind of
request as modules of their own. The harness finds and runs them by name,
with no file it already had edited."""

import hashlib
import json
import shutil
import subprocess
import sys
import textwrap

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


#: a plane mirror, a kind of optic the benchmark does not have: the port's
#: MirrorPlane, the plane z = 0 of its vertex frame in the reference
PLANE = """
import math

import torch

from ..reference import optics as op
from ..work import model

#: the normal's tilt [rad] about the frame's x axis (a planted fault)
TILT = {tilt!r}
STEP_OPS = 20


def port(spec, support):
    from attosecondraytracing_tpu_torch.models import mirrors

    return mirrors.MirrorPlane(support)


def reference(spec, support):
    return op.Optic("plane", support)


def normal(optic, point):
    x = point[0]
    return (torch.zeros_like(x), torch.full_like(x, math.sin(TILT)),
            torch.full_like(x, math.cos(TILT)))


def hit(optic, q, u):
    t = -q[2] / u[2]
    x, y = q[0] + t * u[0], q[1] + t * u[1]
    valid = (t > op.T_MIN) & op.on_support(optic.support, x, y)
    point = (x, y, torch.zeros_like(x))
    return t, valid, point, normal(optic, point)


def step_ops(optic):
    return model.OPS["affine"] + STEP_OPS
"""

#: a kind of request the benchmark does not have: the chain's final rays,
#: a sample of them held against the reference's
FINAL_RAYS = """
import numpy as np
import torch

from .. import sources
from ..reference import optics as op
from ..work import model
from . import RequestKind, alive_by_stage, host_span, place, port_optics, pose_rows


def compare(got, ref):
    both = got["alive"] & ref["alive"]
    return {"placement": float(np.abs(got["poses"] - ref["poses"]).max()),
            "rays_alive": float(np.mean(got["alive"] != ref["alive"])),
            "rays_position": float(np.abs(got["p"][both] - ref["p"][both]).max()),
            "rays_direction": float(np.abs(got["d"][both] - ref["d"][both]).max())}


class Kind(RequestKind):
    span = "final_rays"

    def __init__(self, cfg, traffic, *, device, rng):
        self.cfg, self.device = cfg, device
        self.optics = port_optics(cfg)
        n = int(cfg["source"]["NumberRays"])
        self.sample = np.sort(rng.choice(n, size=int(traffic["checked_rays"]), replace=False))

    def serve(self, request, spans):
        with host_span(spans, "trace"):
            chain = place(self.cfg, self.optics, request["second_distance_mm"]).to(self.device)
            return {"chain": chain, "out": chain.trace_final()}

    def units(self, raw):
        return 1

    def keep(self, request, raw):
        idx = torch.as_tensor(self.sample)
        out = raw["out"]
        return {"poses": pose_rows(raw["chain"]),
                "p": out.p[idx].double().cpu().numpy(), "d": out.d[idx].double().cpu().numpy(),
                "alive": out.alive[idx].cpu().numpy().astype(bool)}

    def reference(self, request, answer, *, dtype, host_dtype, device):
        optics = op.optics_from_config(self.cfg)
        distances = list(self.cfg["distances_mm"][:-1]) + [request["second_distance_mm"]]
        poses = op.place(optics, distances, self.cfg["incidence_deg"],
                         self.cfg["incidence_plane_deg"], dtype=host_dtype, device=device)
        n = int(self.cfg["source"]["NumberRays"])
        rays = op.trace(sources.of(self.cfg).rays(0, n, n, dtype=dtype, device=device), optics,
                        [op.Pose(*(t.to(dtype) for t in p)) for p in poses])
        idx = torch.as_tensor(self.sample)
        rows = [np.concatenate([t.double().cpu().numpy() for t in p]) for p in poses]
        return {"poses": np.stack(rows),
                "p": torch.stack([c[idx] for c in rays.p], -1).double().cpu().numpy(),
                "d": torch.stack([c[idx] for c in rays.d], -1).double().cpu().numpy(),
                "alive": rays.alive[idx].cpu().numpy()}

    def least_seconds(self, request):
        n = int(self.cfg["source"]["NumberRays"])
        source, optics, alive = alive_by_stage(self.cfg, request, n, self.device)
        return model.least_seconds(model.trace_ops(source, optics, alive, folded=True),
                                   model.RAY_OUTPUT_BYTES * n)
"""

RUN = """
import json, sys
sys.path.insert(0, {tests!r})
from cells_small import kernel_engines
sys.path.insert(0, {root!r})
from benchmark import harness
assert harness.__file__.startswith({root!r})
bench = harness.load_benchmark({root!r})
out = {{}}
with kernel_engines():
    for trace in {traces!r}:
        out[trace] = harness.run_cell(bench, "fold.final", 3 + trace, 0.3, bool(trace),
                                      device="cpu")
print(json.dumps(out))
"""


def _run(root, traces):
    code = RUN.format(tests=str(ROOT / "benchmark" / "tests"), root=str(root),
                      traces=list(traces))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=root)
    assert out.returncode == 0, out.stderr[-3000:]
    return {int(k): v for k, v in json.loads(out.stdout.strip().splitlines()[-1]).items()}


def test_optic_and_request_kind_added_as_files(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = _digests(tmp_path)

    bench_dir = tmp_path / "benchmark"
    (bench_dir / "optics" / "plane.py").write_text(textwrap.dedent(PLANE.format(tilt=0.0)))
    (bench_dir / "kinds" / "final_rays.py").write_text(FINAL_RAYS)
    cfg = json.loads((bench_dir / "configs" / "fxf_flagship.json").read_text())
    cfg.update(name="fold", optics=cfg["optics"][:2] + [
        {"kind": "plane", "support": {"kind": "rectangle", "dimX": 150, "dimY": 60}}],
        distances_mm=[400, 100, [80, 120]], incidence_deg=[0, 80, 45])
    cfg["source"] = dict(cfg["source"], kind="point_cone", NumberRays=20000)
    (bench_dir / "configs" / "fold.json").write_text(json.dumps(cfg))
    (bench_dir / "traffic" / "final_rays.json").write_text(json.dumps({
        "kind": "final_rays", "draw": {"second_distance_mm": {"uniform_from_config":
                                                              "distances_mm"}},
        "checked_requests": 2, "checked_rays": 4096}))
    (bench_dir / "limits" / "fold.final.json").write_text(json.dumps({
        "placement": 1e-10, "rays_alive": 2e-4, "rays_position": 0.01, "rays_direction": 5e-5}))
    (bench_dir / "metrics" / "final_s.py").write_text(
        "from benchmark import readers\n\n\ndef read(run):\n"
        "    return readers.window_per_unit_s(run)\n")
    (bench_dir / "metrics" / "trace_ms.final.py").write_text(
        "from benchmark import readers\n\n\ndef read(run):\n"
        "    return readers.span_ms(run, 'trace')\n")
    spec["configs"].append({"name": "fold", "source": "a folded f-x-f test chain",
                            "file": "benchmark/configs/fold.json", "reduced": [],
                            "why": "a plane mirror after the first toroid"})
    spec["workloads"].append({"name": "fold.final", "config": "fold", "traffic": "final_rays",
                              "chips": 1, "why": "final rays of a folded chain"})
    spec["end_to_end"].insert(0, {"name": "final_s", "unit": "s", "better": "lower",
                                  "bound": 0.25, "source": "host_clock",
                                  "workloads": ["fold.final"]})
    spec["per_layer"].append({"name": "trace_ms.final", "unit": "ms", "better": "lower",
                              "source": "program_span", "layer": "driver", "moves": "final_s",
                              "workloads": ["fold.final"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    after = _digests(tmp_path)
    assert all(after[k] == v for k, v in before.items())
    got = _run(tmp_path, (0, 1))
    assert got[0]["correct"] and got[1]["correct"], (got[0]["checks"], got[1]["checks"])
    assert set(got[0]["metrics"]) == {"final_s", "setup_s"}
    assert set(got[1]["metrics"]) == {"trace_ms.final"}
    # the step of the new optic runs: rays reflected off the plane are held
    assert all(c["value"] <= c["limit"] for c in got[0]["checks"].values())

    (bench_dir / "optics" / "plane.py").write_text(textwrap.dedent(PLANE.format(tilt=1e-3)))
    faulty = _run(tmp_path, (0,))
    assert not faulty[0]["correct"], faulty[0]["checks"]


def test_parked_cells_join_by_entries_alone():
    """A parked cell (``benchmark/parked/<cell>.json``) has every file it
    names in place, and its entries join BENCHMARK.json with no name taken
    twice: adding the cell later edits BENCHMARK.json and nothing else."""
    from cells_small import bench as load_bench

    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    merged = load_bench().spec
    parked = sorted((ROOT / "benchmark" / "parked").glob("*.json"))
    assert parked
    for section in ("workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in merged[section]]
        assert len(names) == len(set(names))
    e2e = {m["name"] for m in merged["end_to_end"]}
    for path in parked:
        entries = json.loads(path.read_text())
        for cell in entries["workloads"]:
            assert cell["name"] == path.stem
            assert cell["name"] not in {w["name"] for w in spec["workloads"]}
            assert (ROOT / "benchmark" / "traffic" / f"{cell['traffic']}.json").is_file()
            assert (ROOT / "benchmark" / "limits" / f"{cell['name']}.json").is_file()
            assert cell["config"] in {c["name"] for c in spec["configs"]}
        for m in entries.get("end_to_end", []) + entries.get("per_layer", []):
            assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()
            assert m.get("moves", m["name"]) in e2e
