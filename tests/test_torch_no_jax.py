"""The port never imports JAX: in a fresh interpreter where ``import jax``
fails, the package imports, builds the flagship chain, traces it on the CPU
through the plain, fused-source and streamed engines, takes alignment steps
through both gradient engines, runs the per-distance stats pass, and runs a
two-chain scan through the scan engine, traces a Zernike-deformed chain
(``models/defects``, ``ops/defects``, ``ops/zernike``) and a grid-deformed
one (``ops/xla_source``), runs the gather probes (``utils/gather_probe``),
bins detector images (``analysis/histogram``, ``analysis/gigascan``, K1i's
plain version ``ops/fused_trace.fused_source_image_ref`` with its record) and
runs the cost probes (``utils/cost_probe``), runs a scan through the batched
trace and a sharded stats pass (``parallel/mesh``), and computes every
plot's data (``analysis/plots``) and the CLI's plot dispatch
(``main._plot_calls``), without importing matplotlib."""

import os
import subprocess
import sys

SCRIPT = r"""
import sys
sys.modules["jax"] = None  # any "import jax" now raises ImportError
import torch
torch.set_num_threads(1)
import attosecondraytracing_tpu_torch as art
from attosecondraytracing_tpu_torch import main, interop  # noqa: F401
from attosecondraytracing_tpu_torch.models import defects
from attosecondraytracing_tpu_torch.ops import defects as op_defects, zernike  # noqa: F401
from attosecondraytracing_tpu_torch.models import masks, mirrors, supports
from attosecondraytracing_tpu_torch.models import chain as mchain

R, r = mirrors.ReturnOptimalToroidalRadii(500.0, 80.0)
tor = mirrors.MirrorToroidal(R, r, supports.SupportRectangle(150, 32))
mask = masks.Mask(supports.SupportRoundHole(20, 7, 0, 0))
props = {"Divergence": 25e-3, "SourceSize": 0, "Wavelength": 80e-6, "NumberRays": 4096}
chain = art.OEPlacement(props, [mask, tor, tor], [400, 100, 500], [0, 80, -80], [0, 0, 0])
streamed = chain.to("cpu").trace_final(engine="trace")
fused = chain.trace_final(engine="fused")
assert chain.last_trace_engine == "torch-source"
a, b = int(streamed.alive.sum()), int(fused.alive.sum())
assert 1000 < a and abs(a - b) <= 2, (a, b)
# the gradient engines (K6's plain version and autograd) and K8's plain version
from attosecondraytracing_tpu_torch.analysis import alignment
from attosecondraytracing_tpu_torch.models.detector import Detector
from attosecondraytracing_tpu_torch.ops import fused_trace as ft
det = Detector(chain.optical_elements[-1].position)
det.autoplace(streamed, 500.0)
for engine, name in (("fused", "torch-grad"), ("autograd", "autograd")):
    _, hist = alignment.gradient_align(chain, det, iters=2, lr=1e-5, engine=engine)
    assert alignment.gradient_align.last_engine == name and hist[1] == hist[1], hist
spec = chain.source_spec.baked()
els = chain.device_elements(torch.float64)
bdet = ft.bake_detector(els, det.centre, det.normal, det._plane_rotation(), opl_ref=900.0,
                        distances=(-1.0, 0.0, 1.0))
sums = ft.fused_source_stats(ft.chain_table(spec, els), spec, bdet, [(4096, 0.0, 0.0)], 4096,
                             device="cpu")
assert sums.shape == (7, 3) and sums[0, 0] == sums[0, 2] > 1000
# the streamed kernels' and the scan kernel's plain versions
from attosecondraytracing_tpu_torch.ops import fused_grad, fused_scan  # noqa: F401
from attosecondraytracing_tpu_torch.utils import kernel_ab  # noqa: F401
chain.source_rays = chain.source_rays  # a user bundle
user = chain.trace_final(engine="fused")
assert chain.last_trace_engine == "torch-streamed" and abs(int(user.alive.sum()) - a) <= 2
mchain.PALLAS_MIN_RAYS = 1024
scan = art.OEPlacement(props, [mask, tor, tor], [400, 100, [450.0, 500.0]], [0, 80, -80], [0, 0, 0])
kept = main.main(scan, props, {"DistanceDetector": 500.0, "AutoDetectorDistance": True,
                               "OptFor": "spotsize"}, {"verbose": False, "save_results": False},
                 device="cpu")
assert [c.last_trace_engine for c in kept["OpticalChain"]] == ["torch-scan"] * 2
assert 0 < kept["ETransmission"][0] <= 100
# the batched trace of a scan, the sharded passes (parallel/mesh) on a CPU
# mesh, and the API names of bundle, surfaces and optimizer
from attosecondraytracing_tpu_torch.parallel import mesh as pm
from attosecondraytracing_tpu_torch.ops.bundle import to_host, total_path  # noqa: F401
from attosecondraytracing_tpu_torch.ops.surfaces import intersect, normal_at  # noqa: F401
from attosecondraytracing_tpu_torch.analysis.optimizer import (  # noqa: F401
    _scan_fitness, delay_stats_for_shift, optimal_shift_closed_form)
import os
os.environ["ART_TPU_ENGINE"] = "trace"  # every chain takes the plain trace: the scan is batched
batched = main.main(scan, props, {"DistanceDetector": 500.0, "AutoDetectorDistance": True,
                                  "OptFor": "spotsize"}, {"verbose": False, "save_results": False},
                    device="cpu", scan_engine="off")
del os.environ["ART_TPU_ENGINE"]
assert [c.last_trace_engine for c in batched["OpticalChain"]] == ["trace-scan"] * 2
st = pm.source_stats_sharded(spec, els, 4096, pm.make_mesh(devices=["cpu"] * 4), det.centre,
                             det.normal, det._plane_rotation())
assert st["sum_w"][0] > 1000
# a Zernike-deformed flagship through the fused engine and the plain trace
zdef = defects.Zernike(supports.SupportRectangle(150, 32), {(2, 0): 2e-4, (4, 2): 5e-5})
bent = art.OEPlacement(props, [mask, mirrors.DeformedMirror(tor, [zdef]), tor], [400, 100, 500],
                       [0, 80, -80], [0, 0, 0]).to("cpu")
mchain.PALLAS_MIN_RAYS = 1024
z_fused = bent.trace_final(False)
assert bent.last_trace_engine == "torch-source"
z_plain = bent.trace_final(False, engine="trace")
assert abs(int(z_fused.alive.sum()) - int(z_plain.alive.sum())) <= 2
# a grid-deformed flagship through the fused engine (ops/xla_source's names)
# and the gather probes' plain versions
from attosecondraytracing_tpu_torch.ops import xla_source
from attosecondraytracing_tpu_torch.utils import gather_probe
gdef = defects.Fourrier(supports.SupportRectangle(150, 32), RMS=1e-4, smallest=1.0, seed=3)
gridded = art.OEPlacement(props, [mask, mirrors.DeformedMirror(tor, [gdef]), tor], [400, 100, 500],
                          [0, 80, -80], [0, 0, 0]).to("cpu")
g_fused = gridded.trace_final(False)
assert gridded.last_trace_engine == "torch-source"
g_xla = xla_source.xla_trace_source(gridded.source_spec.baked(), gridded.device_elements(), 4096,
                                    ignore_defects=False)
assert abs(int(g_fused.alive.sum()) - int(g_xla.alive.sum())) <= 2
outs, _ = gather_probe.probe(device="cpu")
assert len(outs) == 8
# detector images (analysis/histogram), the giga-ray image loop
# (analysis/gigascan) and the cost probes (utils/cost_probe), none of which
# may bring in matplotlib: the card's machine has none
from attosecondraytracing_tpu_torch.analysis import gigascan, histogram  # noqa: F401
from attosecondraytracing_tpu_torch.utils import cost_probe
img, _ = det.get_Image(streamed, bins=(16, 16))
mean, w_img, _ = det.get_DelayMap(streamed, bins=(16, 16))
assert float(img.sum()) > 0 and torch.isfinite(mean).any()
res = gigascan.fused_source_images(gridded.source_spec, gridded.device_elements(), det,
                                   n_total=4096, bins=(16, 16), chunk=1024, ignore_defects=False)
assert res["sum_w"] > 0 and res["image"].shape == (16, 16)
# K1i's plain version with a per-ray record (ops/fused_trace.fused_source_image_ref)
gbaked = gridded.source_spec.baked()
rot = det._plane_rotation()
idet = ft.ImageDetector(tuple(det.centre), tuple(det.normal), tuple(map(tuple, rot[:2])), 900.0)
record = ft.image_record(1, 2, 1024, device="cpu")
imgs = tuple(torch.zeros(256, dtype=torch.float64) for _ in range(2))
ft.fused_source_image_ref(ft.chain_table(gbaked, gridded.device_elements()), gbaked,
                          ft.source_chunks(gbaked.kind, 4096, 4096, 1024), 4096, idet,
                          res["extent"], (16, 16), imgs, device="cpu",
                          gaussian_edge=gridded.source_spec.gaussian_edge, ignore_defects=False,
                          record=record)
assert abs(float(imgs[0].sum()) - res["sum_w"]) <= 1e-9 * res["sum_w"]
assert int((record.flat >= 0).sum()) > 0
assert len(cost_probe.probe(device="cpu")) == 2 + 2 * len(cost_probe.OPS)
# the plots' data half (analysis/plots) and the CLI's plot dispatch
# (main._plot_calls, with image_rays through K1i's plain version)
from attosecondraytracing_tpu_torch.analysis import plots
records = [plots.spot_diagram_data(streamed, det, True, "Delay"),
           plots.spot_diagram_image_data(streamed, det, True, "Incidence", bins=16),
           plots.delay_map_image_data(streamed, det, 0.5, bins=16),
           plots.giga_ray_images_data(res, "grid"),
           plots.delay_graph_data(streamed, det, 0.5, True),
           plots.mirror_projection_data(chain, -1, det, "Delay"),
           plots.ray_render_graph_data(chain, maxRays=20, OEpoints=100)]
assert records[0].navigator.key("right") is not None and len(records[-1].segment_sets) == 4
sp, do, ao = main.complete_defaults({}, {"DistanceDetector": 500.0}, {
    "plot_SpotDiagram": True, "plot_IncidenceSpotDiagram": True, "image_rays": 4096,
    "image_bins": 16})
calls = list(main._plot_calls(gridded, g_fused, det, sp, do, ao))
assert [name for name, _ in calls] == ["GigaRayImages", "SpotDiagramImage"], calls
assert "matplotlib" not in sys.modules
assert art.defects is defects
assert not any(name == "jax" or name.startswith(("jax.", "jaxlib", "attosecondraytracing_tpu."))
               for name, mod in sys.modules.items() if mod is not None)
print("\nOK", a, b)
"""


def test_port_runs_without_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.splitlines()[-1].startswith("OK")
