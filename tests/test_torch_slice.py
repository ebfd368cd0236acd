"""The slice end to end, PyTorch port vs the JAX package, on the CPU.

* ``run_ART`` on the flagship (round mask + two grazing toroids) at 4096
  rays with the detector-distance optimizer: both packages take their fused
  engines (the JAX Pallas kernels in interpret mode, the port's K1/K2 plain
  versions) once ``PALLAS_MIN_RAYS`` is lowered to 1024.
* ``run_config_file`` on example CONFIGs through both CLIs: both take the
  streamed trace (below the threshold).
* The port's API faults against the JAX package's, repaired (F1-F6): the
  signatures of ``RayTracingCalculation``, ``get_output_rays`` and
  ``trace_final``, the JAX engine names, ``FindOptimalDistancePallas``, the
  CONFIG module's registration and the CLI's ``--rays`` / ``--scan-engine``.

tests/conftest.py runs JAX in float64; the port is asked for float64 the
same way a user would (``ART_TPU_DTYPE=float64``, read by both packages)."""

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

import os

import matplotlib

matplotlib.use("Agg", force=True)

import pytest  # noqa: E402

from attosecondraytracing_tpu import main as jmain  # noqa: E402
from attosecondraytracing_tpu.models import chain as jchain  # noqa: E402
from attosecondraytracing_tpu_torch import main as tmain  # noqa: E402
from attosecondraytracing_tpu_torch.models import chain as tchain  # noqa: E402
from attosecondraytracing_tpu_torch.ops import fused_trace as ft  # noqa: E402

torch.set_num_threads(1)

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")


def _flagship(pkg, n_rays):
    from importlib import import_module

    mirrors = import_module(f"{pkg}.models.mirrors")
    masks = import_module(f"{pkg}.models.masks")
    supports = import_module(f"{pkg}.models.supports")
    placement = import_module(f"{pkg}.models.placement")
    R, r = mirrors.ReturnOptimalToroidalRadii(500.0, 80.0)
    tor = mirrors.MirrorToroidal(R, r, supports.SupportRectangle(150, 32))
    mask = masks.Mask(supports.SupportRoundHole(Radius=20, RadiusHole=7, CenterHoleX=0, CenterHoleY=0))
    props = {"Divergence": 25e-3, "SourceSize": 0, "Wavelength": 80e-6, "DeltaFT": 0.5,
             "NumberRays": n_rays}
    return placement.OEPlacement(props, [mask, tor, tor], [400.0, 100.0, 500.0], [0.0, 80.0, -80.0],
                                 [0.0, 0.0, 0.0], "flagship"), props


@pytest.mark.parametrize("opt_for", ["intensity", "spotsize"])
def test_run_art_flagship_matches_jax(monkeypatch, opt_for):
    monkeypatch.setenv("ART_TPU_DTYPE", "float64")
    monkeypatch.setattr(jchain, "PALLAS_MIN_RAYS", 1024)
    monkeypatch.setattr(jchain.OpticalChain, "_pallas_eligible", lambda self, els: True)
    monkeypatch.setattr(tchain, "PALLAS_MIN_RAYS", 1024)
    do = {"AutoDetectorDistance": True, "DistanceDetector": 500.0, "OptFor": opt_for}
    ao = {"verbose": False, "save_results": False}

    jc, props = _flagship("attosecondraytracing_tpu", 4096)
    _, jdet, jT, jspot, jdur = jmain.run_ART(jc, *jmain.complete_defaults(props, do, ao))
    assert jc.last_trace_engine == "pallas-source"

    tc, _ = _flagship("attosecondraytracing_tpu_torch", 4096)
    ft.fused_source_trace.launches = ft.fused_source_moments.launches = 0
    _, tdet, tT, tspot, tdur = tmain.run_ART(tc, *tmain.complete_defaults(props, do, ao), device="cpu")
    assert tc.last_trace_engine == "torch-source"
    assert ft.fused_source_trace.launches == 0 and ft.fused_source_moments.launches == 0

    assert 0 < tT <= 100
    assert tT == pytest.approx(jT, abs=0.1)
    assert tdet.get_distance() == pytest.approx(jdet.get_distance(), abs=0.05)
    assert tspot == pytest.approx(jspot, rel=5e-3)
    assert abs(tdur - jdur) <= 0.025 * jdur or abs(tdur**2 - jdur**2) ** 0.5 <= 0.8, (tdur, jdur)


def test_run_art_extended_source_matches_jax(monkeypatch):
    """run_ART on an extended source through both packages' fused engines
    (K1 and K2 plain versions against the Pallas kernels)."""
    monkeypatch.setenv("ART_TPU_DTYPE", "float64")
    monkeypatch.setattr(jchain, "PALLAS_MIN_RAYS", 1024)
    monkeypatch.setattr(jchain.OpticalChain, "_pallas_eligible", lambda self, els: True)
    monkeypatch.setattr(tchain, "PALLAS_MIN_RAYS", 1024)
    do = {"AutoDetectorDistance": True, "DistanceDetector": 500.0, "OptFor": "spotsize"}
    ao = {"verbose": False, "save_results": False}
    jc, props = _extended("attosecondraytracing_tpu", 4000)
    _, jdet, jT, jspot, _ = jmain.run_ART(jc, *jmain.complete_defaults(props, do, ao))
    assert jc.last_trace_engine == "pallas-source"
    tc, _ = _extended("attosecondraytracing_tpu_torch", 4000)
    _, tdet, tT, tspot, _ = tmain.run_ART(tc, *tmain.complete_defaults(props, do, ao), device="cpu")
    assert tc.last_trace_engine == "torch-source" and tc.source_spec.kind == "extended"
    assert 0 < tT <= 100
    assert tT == pytest.approx(jT, abs=0.1)
    assert tdet.get_distance() == pytest.approx(jdet.get_distance(), abs=0.05)
    assert tspot == pytest.approx(jspot, rel=5e-3)


def test_engine_choice(monkeypatch):
    monkeypatch.setenv("ART_TPU_DTYPE", "float64")
    chain, _ = _flagship("attosecondraytracing_tpu_torch", 2048)
    assert chain.device is None
    with pytest.raises(RuntimeError):  # no hidden default device
        chain.trace_final()
    chain.to("cpu")
    chain.trace_final()
    assert chain.last_trace_engine == "trace"  # below PALLAS_MIN_RAYS
    monkeypatch.setattr(tchain, "PALLAS_MIN_RAYS", 1024)
    out = chain.trace_final()
    assert chain.last_trace_engine == "torch-source" and out.p.dtype == torch.float32
    chain.trace_final(engine="trace")
    assert chain.last_trace_engine == "trace"
    chain.source_rays = chain.source_rays  # a user bundle: no fused source
    chain.trace_final()
    assert chain.last_trace_engine == "torch-streamed"  # the streamed kernels' engine
    monkeypatch.setattr(tchain, "PALLAS_MIN_RAYS", 4096)
    chain.trace_final()
    assert chain.last_trace_engine == "trace"
    chain.trace_final(engine="fused")  # forces the engine that fits the source
    assert chain.last_trace_engine == "torch-streamed"
    with pytest.raises(ValueError):
        chain.trace_final(engine="mosaic")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):  # no silent CPU fallback
            chain.to("cuda")
    history = chain.get_output_rays()
    assert len(history) == 3 and chain.get_output_rays() is history  # hash-gated
    chain.to("cpu:0")  # another device: the cached trace is dropped and redone
    assert chain.device == torch.device("cpu", 0)
    again = chain.get_output_rays()
    assert again is not history and torch.equal(again[-1].p, history[-1].p)


def _extended(pkg, n_rays):
    """The flagship's optics behind an extended source (0.4 mm disk of
    10 mrad cones)."""
    chain, props = _flagship(pkg, n_rays)
    props = dict(props, Divergence=10e-3, SourceSize=0.4)
    placement = __import__(f"{pkg}.models.placement", fromlist=["OEPlacement"])
    return placement.OEPlacement(props, [el.type for el in chain.optical_elements],
                                 [400.0, 100.0, 500.0], [0.0, 80.0, -80.0], [0.0, 0.0, 0.0]), props


def test_engine_rule_is_the_jax_one(monkeypatch):
    """engine="auto" takes the fused engine for every factory source kind
    at PALLAS_MIN_RAYS, whatever the chain; on a CUDA device a chain the
    kernels do not take raises instead of running another engine."""
    from attosecondraytracing_tpu_torch.models import masks, supports
    from attosecondraytracing_tpu_torch.models.placement import OEPlacement

    monkeypatch.setattr(tchain, "PALLAS_MIN_RAYS", 1024)
    chain, _ = _extended("attosecondraytracing_tpu_torch", 4000)
    assert chain.source_spec.kind == "extended" and chain.fused_eligible()
    fused = chain.to("cpu").trace_final()
    assert chain.last_trace_engine == "torch-source"
    streamed = chain.trace_final(engine="trace")
    both = fused.alive & streamed.alive
    assert int(both.sum()) > 1000 and int((fused.alive != streamed.alive).sum()) <= 2
    assert float((fused.p[both] - streamed.p[both].float()).abs().max()) < 5e-2
    assert tmain._fused_optimizer_available(chain)

    hole = supports.SupportRoundHole(Radius=30, RadiusHole=1, CenterHoleX=0, CenterHoleY=0)
    props = {"Divergence": 5e-3, "SourceSize": 0, "Wavelength": 80e-6, "NumberRays": 2048}
    long_chain = OEPlacement(props, [masks.Mask(hole) for _ in range(10)], [10.0] * 10, [0.0] * 10)
    assert long_chain.fused_eligible()
    long_chain.device = torch.device("cuda")  # a CUDA device, without touching a card
    with pytest.raises(NotImplementedError):
        long_chain.trace_final()
    assert long_chain.last_trace_engine is None


def _alignment_losses(text):
    """(first, last) of the ``alignment loss: a -> b`` line, and the
    first verbose ``align iter 0: loss x`` value."""
    import re

    first, last = re.findall(r"alignment loss: (\S+) -> (\S+)", text)[-1]
    iter0 = re.findall(r"align iter 0: loss (\S+)", text)[-1]
    return float(first), float(last), float(iter0)


@pytest.mark.parametrize("name", ["CONFIG_singleparabola.py", "CONFIG_toroidal2f-2f_byhand.py",
                                  "CONFIG_gradient_alignment.py", "CONFIG_deformed.py"])
def test_config_file_through_both_clis(monkeypatch, capsys, name):
    """An example CONFIG (1000-2000 rays, streamed trace) gives the same
    transmission, spot SD and duration SD from both CLIs, and the port runs
    it under the JAX package's module names without touching that package.
    CONFIG_gradient_alignment.py traces and aligns its chain while it loads
    (the chains a CONFIG builds take the CLI's device); both CLIs print its
    loss history: the first loss agrees within 1e-6 relative, the last
    within 5 % (float32 parameters, Adam wandering near its floor). Both
    CLIs draw the figures a CONFIG requests (CONFIG_singleparabola.py's
    delay spot diagram) on Agg, with the same title, legend and arrays."""
    import sys

    import matplotlib.pyplot as plt
    import numpy as np

    monkeypatch.setenv("ART_TPU_DTYPE", "float64")
    path = os.path.join(EXAMPLES, name)
    capsys.readouterr()
    plt.close("all")
    jk = jmain.run_config_file(path)
    jout = capsys.readouterr().out
    jfigs = [plt.figure(n) for n in plt.get_fignums()]
    plt.close("all")
    jax_modules = {k: v for k, v in sys.modules.items()
                   if k.split(".")[0] == "attosecondraytracing_tpu"}
    tk = tmain.run_config_file(path, device="cpu")
    tfigs = [plt.figure(n) for n in plt.get_fignums()]
    plt.close("all")
    assert len(tfigs) == len(jfigs)
    assert {k: v for k, v in sys.modules.items()
            if k.split(".")[0] == "attosecondraytracing_tpu"} == jax_modules  # aliases restored
    chain = tk["OpticalChain"][0]
    assert type(chain).__module__ == "attosecondraytracing_tpu_torch.models.chain"
    assert chain.last_trace_engine == "trace"
    for key in ("ETransmission", "SpotSizeSD", "DurationSD"):
        assert float(tk[key][0]) == pytest.approx(float(jk[key][0]), rel=1e-6), key
    if name == "CONFIG_gradient_alignment.py":
        j_first, j_last, j_iter0 = _alignment_losses(jout)
        t_first, t_last, t_iter0 = _alignment_losses(capsys.readouterr().out)
        assert t_iter0 == pytest.approx(j_iter0, rel=1e-6)
        assert t_first == pytest.approx(j_first, rel=1e-6)
        assert t_last == pytest.approx(j_last, rel=0.05)
        assert t_last < 0.1 * t_first
        # the descent leaves the chain the report traces as the CONFIG built it
        assert tk["ETransmission"][0] == pytest.approx(100.0)
    if name == "CONFIG_deformed.py":
        # a Fourier-PSD defect map (RMS 0.1 mm) on a parabola, traced below
        # PALLAS_MIN_RAYS on the plain trace: ~38 % transmission, a mm-scale
        # spot, as the JAX CLI reports for this CONFIG
        assert 37 < tk["ETransmission"][0] < 39 and 1.0 < tk["SpotSizeSD"][0] < 3.0
    if name == "CONFIG_singleparabola.py":
        # its plot_DelaySpotDiagram, drawn from each package's own float64
        # trace of the 1000 rays (read: points within 8.5e-11 µm, delays
        # within 4.8e-10 fs; their rounding is relative to the 300 mm path)
        assert len(tfigs) == 1
        tax, jax_ax = tfigs[0].axes[0], jfigs[0].axes[0]
        assert tax.get_title() == jax_ax.get_title()
        assert ([t.get_text() for t in tax.get_legend().get_texts()]
                == [t.get_text() for t in jax_ax.get_legend().get_texts()])
        assert tfigs[0].axes[1].get_ylabel() == jfigs[0].axes[1].get_ylabel() == "Delay (fs)"
        np.testing.assert_allclose(tax.collections[0].get_offsets(),
                                   jax_ax.collections[0].get_offsets(), rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(tax.collections[0].get_array(),
                                   jax_ax.collections[0].get_array(), rtol=0, atol=1e-8)
        np.testing.assert_allclose(tax.get_xlim(), jax_ax.get_xlim(), rtol=1e-9)
        np.testing.assert_allclose(tax.lines[0].get_xydata(), jax_ax.lines[0].get_xydata(),
                                   rtol=1e-9, atol=1e-9)
        # the ~94 % / ~77 um of the verify notes
        assert 90 < tk["ETransmission"][0] < 97 and 0.07 < tk["SpotSizeSD"][0] < 0.085


def test_cli_arguments(monkeypatch, tmp_path, capsys):
    """The CLI's options reach run_config_file; F9: as the JAX CLI does, it
    runs its first argument when more are given (``CONFIG.py extra``), here
    CONFIG_singleparabola.py through both CLIs in float64, with the same
    results."""
    real = {"jax": jmain.run_config_file, "port": tmain.run_config_file}
    calls = []
    monkeypatch.setattr(tmain, "run_config_file", lambda path, n_rays=None, device="cuda",
                        scan_engine="auto": calls.append((path, n_rays, device)))
    monkeypatch.delenv("ART_TPU_SCAN_ENGINE", raising=False)
    tmain.cli(["--rays", "1e5", "--device", "cpu", "cfg.py"])
    tmain.cli(["cfg.py"])
    # the profiler imports more of torch, which fails on the stub modules
    # (see the top of this file): set them aside for the call
    for name, mod in list(sys.modules.items()):
        if not isinstance(getattr(mod, "__file__", None), (str, type(None))):
            monkeypatch.delitem(sys.modules, name)
    tmain.cli(["--device", "cpu", "--profile", str(tmp_path / "prof"), "cfg.py"])
    assert calls == [("cfg.py", 100000, "cpu"), ("cfg.py", None, "cuda"), ("cfg.py", None, "cpu")]
    assert (tmp_path / "prof" / "trace.json.gz").exists()
    assert "[profile] wall" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        tmain.cli([])
    with pytest.raises(SystemExit):
        tmain.cli(["cfg.py", "--rays"])

    monkeypatch.setenv("ART_TPU_DTYPE", "float64")
    kept = {}
    for pkg, module in (("jax", jmain), ("port", tmain)):
        monkeypatch.setattr(module, "run_config_file",
                            lambda *a, pkg=pkg, **kw: kept.setdefault(pkg, real[pkg](*a, **kw)))
    path = os.path.join(EXAMPLES, "CONFIG_singleparabola.py")
    jmain.cli([path, "extra"])
    import matplotlib.pyplot as plt

    plt.close("all")
    tmain.cli(["--device", "cpu", path, "extra"])
    assert set(kept) == {"jax", "port"}
    for key in ("ETransmission", "SpotSizeSD", "DurationSD"):
        assert float(kept["port"][key][0]) == pytest.approx(float(kept["jax"][key][0]), rel=1e-6), key


# ---------------------------------------------------------------------------
# the port's API faults against the JAX package (ROADMAP queue 3, F1-F6)
# ---------------------------------------------------------------------------


def _deformed_parabola(n_rays=512):
    """A parabola at normal incidence with Zernike defects (the chain of
    tests/test_pallas.py:77-120), built with the port's names."""
    from attosecondraytracing_tpu_torch.models import defects, mirrors, supports
    from attosecondraytracing_tpu_torch.models.placement import OEPlacement

    support = supports.SupportRound(20)
    deformed = mirrors.DeformedMirror(mirrors.MirrorParabolic(100, 90, support),
                                      [defects.Zernike(support, {(2, 0): 2e-4, (3, 1): -1e-4})])
    props = {"Divergence": 0, "SourceSize": 30, "Wavelength": 50e-6, "NumberRays": n_rays}
    return OEPlacement(props, [deformed], [200.0], [0.0])


def test_f1_ray_tracing_calculation_signature():
    """F1: RayTracingCalculation(source_rays, optical_elements,
    IgnoreDefects=True, *, device=None, dtype=None), as the JAX package's:
    IgnoreDefects reaches the trace, and device=None takes the device of the
    CONFIG being run, and raises the chain's error outside one."""
    from attosecondraytracing_tpu_torch import processing

    chain = _deformed_parabola()
    src, els = chain.source_rays, chain.optical_elements
    with pytest.raises(RuntimeError, match="no device yet"):
        processing.RayTracingCalculation(src, els)
    with tchain.config_device("cpu"):
        base = processing.RayTracingCalculation(src, els)
        sloped = processing.RayTracingCalculation(src, els, False)
    ref = processing.RayTracingCalculation(src, els, IgnoreDefects=False, device="cpu")
    assert len(base) == len(sloped) == 1 and base[0].p.device.type == "cpu"
    assert torch.equal(sloped[0].d, ref[0].d)
    both = base[0].alive & sloped[0].alive
    assert int(both.sum()) > 200 and float((base[0].d[both] - sloped[0].d[both]).abs().max()) > 1e-5


def test_f2_trace_signatures_and_engine_names(monkeypatch):
    """F2: get_output_rays(ignore_defects, force) and
    trace_final(ignore_defects, engine) in the JAX order; the JAX engine
    names ("pallas", "xla-source": the kernel engine, "xla": the plain
    trace) are accepted, and ART_TPU_ENGINE is read when no engine is
    given."""
    monkeypatch.delenv("ART_TPU_ENGINE", raising=False)
    chain = _deformed_parabola(2048).to("cpu")
    hist = chain.get_output_rays(False)
    assert chain.get_output_rays(False, False) is hist and chain.get_output_rays(False, True) is not hist
    monkeypatch.setattr(tchain, "PALLAS_MIN_RAYS", 1024)
    sloped = chain.trace_final(False)
    assert chain.last_trace_engine == "torch-source"
    flat = chain.trace_final(True, "pallas")
    assert chain.last_trace_engine == "torch-source"
    both = sloped.alive & flat.alive
    assert float((sloped.d[both] - flat.d[both]).abs().max()) > 1e-5
    chain.trace_final(engine="xla-source")
    assert chain.last_trace_engine == "torch-source"
    chain.trace_final(engine="xla")
    assert chain.last_trace_engine == "trace"
    monkeypatch.setenv("ART_TPU_ENGINE", "xla")
    chain.trace_final()
    assert chain.last_trace_engine == "trace"
    monkeypatch.setenv("ART_TPU_ENGINE", "pallas")
    chain.trace_final()
    assert chain.last_trace_engine == "torch-source"


def test_f3_find_optimal_distance_pallas_alias():
    """F3: analysis/optimizer.FindOptimalDistancePallas, the JAX package's
    name, is FindOptimalDistanceFused."""
    from attosecondraytracing_tpu.analysis import optimizer as jopt
    from attosecondraytracing_tpu_torch.analysis import optimizer as topt

    assert callable(jopt.FindOptimalDistancePallas)
    assert topt.FindOptimalDistancePallas is topt.FindOptimalDistanceFused


_SELF_IMPORTING_CONFIG = """
import sys
from attosecondraytracing_tpu import mirrors, supports, processing as mp

# the CLI registers this module under its file name while it runs
assert sys.modules["{name}"].__dict__ is globals()
OpticalChain = mp.OEPlacement(
    {{"Divergence": 0, "SourceSize": 10, "Wavelength": 800e-6, "NumberRays": 64}},
    [mirrors.MirrorPlane(supports.SupportRound(20))], [100], [10])
DetectorOptions = {{"DistanceDetector": 50.0, "AutoDetectorDistance": False}}
AnalysisOptions = {{"verbose": False, "save_results": False}}
"""


def test_f4_config_module_registered_while_it_runs(tmp_path):
    """F4: run_config_file registers the CONFIG module in
    sys.modules[filename] while it runs (the JAX CLI does, main.py:679),
    and restores sys.modules afterwards."""
    name = "cfg_self_import.py"
    path = tmp_path / name
    path.write_text(_SELF_IMPORTING_CONFIG.format(name=name))
    assert name not in sys.modules
    kept = tmain.run_config_file(str(path), device="cpu")
    assert name not in sys.modules
    assert 0 < kept["ETransmission"][0] <= 100


def test_f5_rays_needs_a_count(capsys):
    """F5: --rays with no number prints the JAX CLI's message and exits 1."""
    with pytest.raises(SystemExit) as exc:
        tmain.cli(["--rays", "abc", "cfg.py"])
    assert exc.value.code == 1
    assert "--rays requires a ray count" in capsys.readouterr().out


def test_f6_scan_engine_option(monkeypatch, capsys):
    """F6: the CLI reads --scan-engine auto|off and ART_TPU_SCAN_ENGINE (the
    JAX package's variable) and passes them to run_config_file."""
    calls = []
    monkeypatch.setattr(tmain, "run_config_file",
                        lambda path, n_rays=None, device="cuda", scan_engine="auto":
                        calls.append(scan_engine))
    monkeypatch.delenv("ART_TPU_SCAN_ENGINE", raising=False)
    tmain.cli(["--device", "cpu", "cfg.py"])
    tmain.cli(["--scan-engine", "off", "cfg.py"])
    monkeypatch.setenv("ART_TPU_SCAN_ENGINE", "off")
    tmain.cli(["cfg.py"])
    tmain.cli(["--scan-engine", "auto", "cfg.py"])
    assert calls == ["auto", "off", "off", "auto"]
    with pytest.raises(SystemExit):
        tmain.cli(["--scan-engine", "fast", "cfg.py"])
    assert "--scan-engine takes one of" in capsys.readouterr().out
