"""The port on the deformed parabola of upstream ART's
``examples/CONFIG_deformed.py`` (an on-axis parabola, f 25.4 mm, with a
Fourier-PSD figure error, lit by a 100 mm plane wave, the detector fixed
25.4 mm away), held against the benchmark's plain float64 reference
(``benchmark/reference``: it imports nothing of the port), and the counters
of grid maps put on a device.

Sizes: the map cut to ``smallest`` 1 mm (80 x 80 nodes), 8192 rays.
Tolerances, against the float64 reference: the port traces in float32, and
its source law rounds a ray's azimuth to ~3e-5 turns (the golden-angle
phase summed in float32), so the rays meet the detector plane within
~3e-4 mm and their paths within ~1 fs; the transmission is summed in
float64 (~1e-8 percentage points), the spot and duration SDs over the
float32 bundle (~1e-6 relative, ~1e-3 fs). The map synthesized by the port
in float32 against the reference's float64 synthesis: ~1e-6 of its RMS."""

import sys
from pathlib import Path

_stubs = {name: mod for name, mod in list(sys.modules.items())
          if not isinstance(getattr(mod, "__file__", None), (str, type(None)))}
for _name in _stubs:
    del sys.modules[_name]
import torch  # noqa: E402

sys.modules.update(_stubs)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from attosecondraytracing_tpu_torch import main as art  # noqa: E402
from attosecondraytracing_tpu_torch.models import chain as tchain  # noqa: E402
from attosecondraytracing_tpu_torch.models import defects as tdef  # noqa: E402
from attosecondraytracing_tpu_torch.models import mirrors as tmirror  # noqa: E402
from attosecondraytracing_tpu_torch.models import supports as tsupp  # noqa: E402
from attosecondraytracing_tpu_torch.models.placement import OEPlacement  # noqa: E402
from attosecondraytracing_tpu_torch.ops import defects as todef  # noqa: E402
from attosecondraytracing_tpu_torch.ops import fused_trace as ft  # noqa: E402
from benchmark.defects import fourier  # noqa: E402
from benchmark.reference import compare as judge  # noqa: E402
from benchmark.reference import fixed_design as ref_fixed  # noqa: E402

torch.set_num_threads(1)

N_RAYS = 8192
PROPS = {"kind": "plane_wave", "Divergence": 0, "SourceSize": 100, "Wavelength": 8e-4,
         "DeltaFT": 0, "NumberRays": N_RAYS}
DETECTOR = {"ReflectionNumber": -1, "ManualDetector": False, "DistanceDetector": 25.4,
            "AutoDetectorDistance": False, "OptFor": "intensity"}
DEFECT = {"kind": "fourier", "RMS": 0.1, "slope": -2, "smallest": 1.0, "seed": 12345}
CFG = {"name": "deformed_parabola", "source": PROPS,
       "optics": [{"kind": "parabolic", "focal": 25.4, "off_axis": 0,
                   "support": {"kind": "rectangle", "dimX": 40, "dimY": 40},
                   "defects": [DEFECT]}],
       "distances_mm": [15], "incidence_deg": [0], "incidence_plane_deg": [0],
       "detector": DETECTOR}
SUPPORT = ("rectangle", 40.0, 40.0)


def _port_chain(defect=None):
    support = tsupp.SupportRectangle(40, 40)
    defect = defect or tdef.Fourrier(support, RMS=0.1, smallest=1.0, seed=12345)
    mirror = tmirror.DeformedMirror(tmirror.MirrorParabolic(25.4, 0, support), [defect])
    return OEPlacement(PROPS, [mirror], [15], [0], [0], "deformed parabola"), defect


@pytest.mark.parametrize("min_rays", [0, None], ids=["source_engine", "plain_trace"])
@pytest.mark.parametrize("distance", [25.0, 25.4])
def test_fixed_detector_design_matches_the_reference(min_rays, distance, monkeypatch):
    """``main.main`` with the CONFIG's fixed detector on the port's plain
    paths (K1's plain version, or the plain streamed trace below
    ``PALLAS_MIN_RAYS``): the rays on the reference's detector plane, the
    transmission, the spot SD and the duration SD there."""
    if min_rays is not None:
        monkeypatch.setattr(tchain, "PALLAS_MIN_RAYS", min_rays)
    chain, _ = _port_chain()
    kept = art.main(chain, PROPS, dict(DETECTOR, DistanceDetector=distance),
                    {"verbose": False, "save_results": False}, device=torch.device("cpu"))
    out = chain.trace_final()
    sample = np.arange(0, N_RAYS, 3)
    idx = torch.as_tensor(sample)
    got = {"poses": np.stack([np.concatenate([e.position, e.normal, e.majoraxis])
                              for e in chain.optical_elements]),
           "source": {"p": chain.source_rays.p[idx].double().numpy(),
                      "d": chain.source_rays.d[idx].double().numpy(),
                      "intensity": chain.source_rays.intensity[idx].double().numpy()},
           "bundle": {"p": out.p[idx].double().numpy(), "d": out.d[idx].double().numpy(),
                      "opl": (out.opl[idx].double() - out.opl_c[idx].double()).numpy(),
                      "alive": out.alive[idx].numpy().astype(bool)},
           "transmission": kept["ETransmission"][0], "distance": distance,
           "spot": kept["SpotSizeSD"][0], "duration": kept["DurationSD"][0]}
    ref = ref_fixed.design(CFG, {"second_distance_mm": 15, "detector_distance_mm": distance},
                           sample, [], device="cpu")
    gaps = judge.design(got, ref)
    assert kept["Detector"][0].get_distance() == pytest.approx(distance, abs=1e-9)
    assert gaps["placement"] < 1e-12
    assert gaps["source"] < 1e-9
    assert gaps["rays_alive"] == 0.0
    assert gaps["rays_position"] < 3e-3
    assert gaps["rays_direction"] < 5e-4
    assert gaps["rays_path"] < 10.0
    assert gaps["transmission"] < 1e-6
    assert gaps["spot"] < 1e-5
    assert gaps["duration"] < 1e-2
    assert ref["spot"] > 1.0 and ref["duration"] > 500.0  # the figure error's blur shows


@pytest.mark.parametrize("smallest,seed", [(1.0, 12345), (0.1, 12345), (0.1, 7)])
def test_port_fourier_map_matches_the_reference_synthesis(smallest, seed):
    """The port's float32 map against the reference's own float64 synthesis
    from the seed, node for node, and the grid's origin and spacing."""
    port = tdef.Fourrier(tsupp.SupportRectangle(40, 40), RMS=0.1, smallest=smallest, seed=seed)
    ref_defect = fourier.reference(dict(DEFECT, smallest=smallest, seed=seed), SUPPORT)
    g = fourier.grid(ref_defect)
    ref = fourier.synthesize(ref_defect, dtype=torch.float64, device="cpu").numpy()
    assert port.deformation.shape == ref.shape == (g["ny"], g["nx"])
    assert (g["nx"], g["ny"]) == ((80, 80) if smallest == 1.0 else (800, 800))
    assert (port._x0, port._y0, port._dx, port._dy) == pytest.approx(
        (g["x0"], g["y0"], g["dx"], g["dy"]), rel=1e-15)
    assert np.abs(port.deformation - ref).max() / 0.1 < 1e-5
    assert np.std(ref) == pytest.approx(0.1, rel=1e-12)
    x, y = np.random.default_rng(seed).uniform(-21.0, 21.0, size=(2, 512))
    heights = fourier.height(ref_defect, torch.from_numpy(x), torch.from_numpy(y)).numpy()
    assert np.abs(port.offset_at(x, y) - heights).max() / 0.1 < 1e-5


def test_grid_maps_are_put_on_a_device_once_per_map():
    """Two placements of one chain over one Fourrier pack the map's rows
    once (16 bytes a node), whichever copy of its maps the element records
    hold, and copy its maps once per device and dtype (the host maps are
    float32 CPU tensors: float64 elements take a copy); a second map counts
    again."""
    rows0, bytes0 = ft.grid_rows.packed, ft.grid_rows.packed_bytes
    copies0, copied0 = todef.grid_to.copies, todef.grid_to.copied_bytes
    cpu = torch.device("cpu")
    chain, defect = _port_chain()
    nx, ny = defect._height.shape
    for _ in range(2):
        chain, _ = _port_chain(defect)
        ft.launch_grids(chain.to(cpu).device_elements(torch.float32), cpu)
        ft.launch_grids(chain.device_elements(torch.float64), cpu)
    assert ft.grid_rows.packed - rows0 == 1
    assert ft.grid_rows.packed_bytes - bytes0 == 16 * nx * ny
    assert todef.grid_to.copies - copies0 == 1
    assert todef.grid_to.copied_bytes - copied0 == 3 * 8 * nx * ny
    other = tdef.Fourrier(tsupp.SupportRectangle(40, 40), RMS=0.1, smallest=1.0, seed=7)
    chain, _ = _port_chain(other)
    ft.launch_grids(chain.to(cpu).device_elements(torch.float32), cpu)
    ft.launch_grids(chain.device_elements(torch.float64), cpu)
    assert ft.grid_rows.packed - rows0 == 2
    assert ft.grid_rows.packed_bytes - bytes0 == 2 * 16 * nx * ny
    assert todef.grid_to.copies - copies0 == 2


def test_a_collected_map_leaves_no_entry():
    """A map's entry, and its copies' that share it, go when the map is
    collected: the copies and rows a chain made are freed with it."""
    import gc

    gc.collect()
    before = set(todef._DERIVED)
    cpu = torch.device("cpu")
    chain, defect = _port_chain()
    ft.launch_grids(chain.to(cpu).device_elements(torch.float64), cpu)
    assert len(set(todef._DERIVED) - before) == 2  # the map and its float64 copy
    del chain, defect
    gc.collect()
    assert set(todef._DERIVED) == before
