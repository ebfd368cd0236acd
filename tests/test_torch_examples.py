"""The five example CONFIGs no other test runs, through both CLIs on the
CPU in float64 at their own ray counts, chain by chain.

The three scans (CONFIG_toroidal2f-2f.py, CONFIG_2toroidals_twisted.py,
CONFIG_tolerancing.py; 1000 rays, below ``PALLAS_MIN_RAYS``) take both
packages' batched trace (``main._batched_final_bundles``); the telescope
and the template are single chains on the plain trace. Transmission, spot
SD, duration SD and the detector distance agree within 1e-8 relative (the
float64 traces differ at 1e-10). CONFIG_tolerancing.py draws its random
rotation axes from the global NumPy RNG (``rotate_random_by``), so the RNG
is seeded just before each package's run: both then build the same 16
chains."""

import sys

# tests/reference_shims.py leaves stand-in modules (pyvista, colorcet, ...)
# in sys.modules whose every attribute is a stub object. Importing torch runs
# inspect.getmodule, which reads each module's __file__ and fails on them, so
# they are set aside while torch imports.
_stubs = {name: mod for name, mod in list(sys.modules.items())
          if not isinstance(getattr(mod, "__file__", None), (str, type(None)))}
for _name in _stubs:
    del sys.modules[_name]
import torch  # noqa: E402

sys.modules.update(_stubs)

import os  # noqa: E402

import matplotlib  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

matplotlib.use("Agg", force=True)

from attosecondraytracing_tpu import main as jmain  # noqa: E402
from attosecondraytracing_tpu_torch import main as tmain  # noqa: E402

torch.set_num_threads(1)

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")
SCANS = {"CONFIG_toroidal2f-2f.py": 11, "CONFIG_2toroidals_twisted.py": 10, "CONFIG_tolerancing.py": 16}


def _spy(monkeypatch, module, seen):
    """Record whether ``module._batched_final_bundles`` returned bundles."""
    real = module._batched_final_bundles

    def spy(chains):
        out = real(chains)
        seen.append(out is not None)
        return out

    monkeypatch.setattr(module, "_batched_final_bundles", spy)


@pytest.mark.parametrize("name", ["CONFIG_toroidal2f-2f.py", "CONFIG_2toroidals_twisted.py",
                                  "CONFIG_tolerancing.py", "CONFIG_CollimatingTelescope.py",
                                  "CONFIG__template.py"])
def test_example_config_through_both_clis(monkeypatch, name):
    monkeypatch.setenv("ART_TPU_DTYPE", "float64")
    path = os.path.join(EXAMPLES, name)
    seen = {"jax": [], "port": []}
    _spy(monkeypatch, jmain, seen["jax"])
    _spy(monkeypatch, tmain, seen["port"])
    np.random.seed(2024)
    jk = jmain.run_config_file(path)
    import matplotlib.pyplot as plt

    plt.close("all")
    np.random.seed(2024)
    tk = tmain.run_config_file(path, device="cpu")
    n = SCANS.get(name, 1)
    assert len(jk["OpticalChain"]) == len(tk["OpticalChain"]) == n
    if name in SCANS:
        assert seen == {"jax": [True], "port": [True]}
        assert all(c.last_trace_engine == "trace-scan" for c in tk["OpticalChain"])
    else:
        assert seen == {"jax": [], "port": []}
        assert tk["OpticalChain"][0].last_trace_engine == "trace"
    for key in ("ETransmission", "SpotSizeSD", "DurationSD"):
        np.testing.assert_allclose(np.asarray(tk[key], np.float64), np.asarray(jk[key], np.float64),
                                   rtol=1e-8, err_msg=key)
    for d_t, d_j in zip(tk["Detector"], jk["Detector"]):
        assert d_t.get_distance() == pytest.approx(d_j.get_distance(), rel=1e-8)
