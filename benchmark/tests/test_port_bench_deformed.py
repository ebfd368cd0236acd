"""The cells of the deformed parabola (``deformed.design``,
``deformed.image``) driven on the CPU at a small size: the configuration's
map cut to ``smallest`` 1 mm (80 x 80 nodes), 20,000 rays, a 2^17-ray
16 x 16 image. A sound run is correct; the control fails; a map shifted by
one node, a height of the other sign and a focal length 1 % long each read
``correct`` false, and so does the control's map, synthesized in bfloat16; a --trace 0 run imports no JAX; the upload counters'
metric reads 0 on the program and is left out where the program has no
counters."""

import copy
import json
import subprocess
import sys

import numpy as np
import pytest

from cells_small import ROOT, kernel_engines
from benchmark import control, harness

CELLS = ("deformed.design", "deformed.image")


def _small_optics():
    cfg = json.loads((ROOT / "benchmark" / "configs" / "deformed_parabola.json").read_text())
    optics = copy.deepcopy(cfg["optics"])
    optics[0]["defects"][0]["smallest"] = 1.0
    return optics


OVERRIDES = {
    "deformed.design": {"config": {"optics": _small_optics()}, "source": {"NumberRays": 20000}},
    "deformed.image": {"config": {"optics": _small_optics()}, "source": {"NumberRays": 20000},
                       "fixed": {"n_total": 1 << 17, "bins": [16, 16], "probe_rays": 1 << 17}},
}


def _run(cell, seed=5, seconds=0.5, trace=False):
    bench = harness.load_benchmark(ROOT)
    with kernel_engines():
        return harness.run_cell(bench, cell, seed, seconds, trace, device="cpu",
                                overrides=OVERRIDES[cell])


def _map_shifted(monkeypatch):
    """The synthesized map rolled by one node along x."""
    from attosecondraytracing_tpu_torch.models import defects

    init = defects.Fourrier.__init__

    def shifted(self, *args, **kwargs):
        init(self, *args, **kwargs)
        self._height = np.roll(self._height, 1, axis=0)

    monkeypatch.setattr(defects.Fourrier, "__init__", shifted)


def _height_flipped(monkeypatch):
    """The hit moved along the ray by minus the height."""
    from attosecondraytracing_tpu_torch.models import defects

    init = defects.Fourrier.__init__

    def flipped(self, *args, **kwargs):
        init(self, *args, **kwargs)
        self._height = -self._height

    monkeypatch.setattr(defects.Fourrier, "__init__", flipped)


def _focal_long(monkeypatch):
    """The parabola built with its focal length 1 % long."""
    from attosecondraytracing_tpu_torch.models import mirrors

    init = mirrors.MirrorParabolic.__init__

    def longer(self, FocalEffective, OffAxisAngle, Support):
        init(self, 1.01 * FocalEffective, OffAxisAngle, Support)

    monkeypatch.setattr(mirrors.MirrorParabolic, "__init__", longer)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res = _run(cell)
    assert res["attempted"] >= 1
    assert res["correct"], res["checks"]
    assert {"design_s" if "design" in cell else "image_ms", "setup_s"} <= set(res["metrics"])


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS
                                        for f in (_map_shifted, _height_flipped, _focal_long)],
                         ids=lambda x: x if isinstance(x, str) else x.__name__.strip("_"))
def test_fault_reads_incorrect(cell, fault, monkeypatch):
    fault(monkeypatch)
    res = _run(cell)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_check(cell):
    bench = harness.load_benchmark(ROOT)
    limits = json.loads((ROOT / "benchmark" / "limits" / f"{cell}.json").read_text())
    with kernel_engines():
        got = control.readings(bench, cell, [7], [7, 8], device="cpu", overrides=OVERRIDES[cell],
                               log=lambda _s: None)
    assert all(not v > limits[k] for k, v in got["program"][0].items()), got["program"]
    for numbers in got["control"]:
        assert "crashed" not in numbers
        assert any(v > limits[k] for k, v in numbers.items()), numbers
        # the control's map, synthesized one step below the program's
        # float32, fails its own number
        assert "map" not in limits or numbers["map"] > 10 * limits["map"], numbers


SCRIPT = """
import json, sys
sys.path.insert(0, {root!r}); sys.path.insert(0, {tests!r})
from cells_small import kernel_engines
from benchmark import harness
bench = harness.load_benchmark({root!r})
with kernel_engines():
    res = harness.run_cell(bench, {cell!r}, 9, 0.3, False, device="cpu", overrides={ov!r})
print(json.dumps({{"correct": res["correct"], "found": harness.forbidden_modules(),
                  "port": "attosecondraytracing_tpu_torch" in sys.modules}}))
"""


@pytest.mark.parametrize("cell", CELLS)
def test_run_imports_no_jax(cell):
    code = SCRIPT.format(root=str(ROOT), tests=str(ROOT / "benchmark" / "tests"), cell=cell,
                         ov=OVERRIDES[cell])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["port"] and got["correct"]
    assert got["found"] == []


def test_upload_counters_read_zero_inside_the_window(monkeypatch):
    """The traced design reports its span and the upload counters' metric:
    0 MB a design once the map is on the device; a program without the
    counters (the attributes absent) leaves the metric out."""
    from attosecondraytracing_tpu_torch.ops import defects, fused_trace

    res = _run("deformed.design", trace=True)
    assert res["correct"], res["checks"]
    assert res["metrics"]["grid_upload_mb.through_focus"]["value"] == 0.0
    assert res["metrics"]["driver_ms.through_focus"]["value"] > 0.0
    assert res["metrics"]["placement_ms.through_focus"]["value"] > 0.0
    from benchmark.kinds import fixed_design

    # a program whose functions carry no counters reads as None ...
    with monkeypatch.context() as m:
        m.setattr(fused_trace, "grid_rows", lambda *a, **k: None)
        assert fixed_design.uploaded_bytes() is None
    with monkeypatch.context() as m:
        m.setattr(defects, "grid_to", lambda *a, **k: None)
        assert fixed_design.uploaded_bytes() is None
    # ... and its run leaves the metric out
    monkeypatch.setattr(fixed_design, "uploaded_bytes", lambda: None)
    res = _run("deformed.design", trace=True)
    assert res["correct"], res["checks"]
    assert "grid_upload_mb.through_focus" not in res["metrics"]
    assert {"driver_ms.through_focus", "placement_ms.through_focus"} <= set(res["metrics"])


def test_work_model_of_the_design():
    """The work model's least seconds of a design at the configuration's
    ray count: bound by its bytes (the stored rays, the summary's read and
    the map's touched nodes, at most the whole map)."""
    import torch

    from benchmark.kinds import fixed_design
    from benchmark.work import model

    bench = harness.load_benchmark(ROOT)
    cell = harness.load_cell(bench, "deformed.design")
    kind = harness.load_kind("fixed_design")
    optics = OVERRIDES["deformed.design"]["config"]["optics"]
    cfg = dict(cell.cfg, optics=optics)
    k = kind.Kind.__new__(kind.Kind)
    k.cfg, k.device, k.props = cfg, torch.device("cpu"), dict(cfg["source"])
    from benchmark.reference import fixed_design as ref_fixed

    k.map_defects = ref_fixed.map_defects(cfg)
    req = {"second_distance_mm": 15, "detector_distance_mm": 25.4}
    least = k.least_seconds(req)
    n = cfg["source"]["NumberRays"]
    stored = (model.RAY_OUTPUT_BYTES + fixed_design.SUMMARY_BYTES) * n
    whole_map = stored + 16 * 80 * 80
    assert stored / model.PEAK_HBM_BYTES_PER_S < least <= whole_map / model.PEAK_HBM_BYTES_PER_S
