"""The port never imports JAX: in a fresh interpreter where ``import jax``
fails, the package imports, builds the flagship chain, traces it on the CPU
through the plain, fused-source and streamed engines, and runs a two-chain
scan through the scan engine."""

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
# the streamed kernels' and the scan kernel's plain versions
from attosecondraytracing_tpu_torch.ops import fused_grad, fused_scan  # noqa: F401
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
