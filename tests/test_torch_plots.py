"""The port's plot set (``analysis/plots.py``, ``main.make_plots`` and
``main._plot_calls``, ``OpticalChain.render`` / ``quickshow``, and its
giga-ray example) against the JAX package's, on matplotlib's ``Agg``.

One chain is built in both packages and traced by the JAX package in
float64; its bundles are carried across with ``interop`` (the port's chain
returns them from ``get_output_rays``), so both plot the same rays. Each
data function of the port is held against the arrays read off the JAX
figure (scatter offsets and colours, 3D offsets, imshow arrays with their
NaN masks and extents, legend, title, text and colorbar labels, axis
limits, line data, contour fills) to 1e-12 relative, with identical NaN
masks and identical chosen rays; the figure the port draws from the data
carries the same arrays. ``make_plots`` draws the same sequence of figures
as the JAX package's for each combination of options tested, and where
matplotlib cannot be imported it prints one line and changes no result.
"""

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

import matplotlib  # noqa: E402

matplotlib.use("Agg", force=True)

import inspect  # noqa: E402

import jax  # noqa: E402
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
from matplotlib.backend_bases import KeyEvent  # noqa: E402

from attosecondraytracing_tpu import main as jmain  # noqa: E402
from attosecondraytracing_tpu.analysis import gigascan as jgs  # noqa: E402
from attosecondraytracing_tpu.analysis import plots as jplots  # noqa: E402
from attosecondraytracing_tpu.models import chain as jchain_mod  # noqa: E402
from attosecondraytracing_tpu.models import masks as jmask  # noqa: E402
from attosecondraytracing_tpu.models import mirrors as jmirror  # noqa: E402
from attosecondraytracing_tpu.models import supports as jsupp  # noqa: E402
from attosecondraytracing_tpu.models.chain import OpticalChain as JChain  # noqa: E402
from attosecondraytracing_tpu.models.placement import OEPlacement as JPlacement  # noqa: E402
from attosecondraytracing_tpu_torch import interop  # noqa: E402
from attosecondraytracing_tpu_torch import main as tmain  # noqa: E402
from attosecondraytracing_tpu_torch.analysis import plots as tplots  # noqa: E402
from attosecondraytracing_tpu_torch.models import chain as tchain_mod  # noqa: E402
from attosecondraytracing_tpu_torch.models import masks as tmask  # noqa: E402
from attosecondraytracing_tpu_torch.models import mirrors as tmirror  # noqa: E402
from attosecondraytracing_tpu_torch.models import supports as tsupp  # noqa: E402
from attosecondraytracing_tpu_torch.models.chain import OpticalChain as TChain  # noqa: E402
from attosecondraytracing_tpu_torch.models.detector import Detector as TDetector  # noqa: E402
from attosecondraytracing_tpu_torch.models.placement import OEPlacement as TPlacement  # noqa: E402

torch.set_num_threads(2)

RTOL = 1e-12
#: light speed [mm/fs]: delays are differences of optical paths, so their
#: float64 rounding is relative to the path in fs, not to the delay
LIGHT_MM_PER_FS = 2.99792458e-4
DET_OPTS = {"ReflectionNumber": -1, "ManualDetector": False, "DetectorCentre": None,
            "DetectorNormal": None, "DistanceDetector": 100.0, "AutoDetectorDistance": False,
            "OptFor": "intensity"}


@pytest.fixture(autouse=True)
def _float64_headless(monkeypatch):
    """Float64 traces in the port, the stub modules set aside, and no
    PyVista or colorcet in either package (both draw on matplotlib)."""
    monkeypatch.setenv("ART_TPU_DTYPE", "float64")
    for name, mod in list(sys.modules.items()):
        if not isinstance(getattr(mod, "__file__", None), (str, type(None))):
            monkeypatch.delitem(sys.modules, name)
    for name in ("pyvista", "pyvistaqt", "colorcet"):
        monkeypatch.setitem(sys.modules, name, None)
    yield
    plt.close("all")


# ---------------------------------------------------------------------------
# one chain in both packages
# ---------------------------------------------------------------------------


def _parabola(pkg_mirror, pkg_supp, Placement, n):
    """tests/test_plots_driver.py's chain: a holed parabola, a 40 mm disk."""
    parabola = pkg_mirror.MirrorParabolic(100, 90, pkg_supp.SupportRoundHole(30, 5, 10, 5))
    props = {"Divergence": 0, "SourceSize": 40, "Wavelength": 800e-6, "DeltaFT": 2.7,
             "NumberRays": n}
    return Placement(props, [parabola], [200], [0.0], Description="parabola")


def _flagship(pkg_mask, pkg_mirror, pkg_supp, Placement, n):
    """Round-hole mask + two toroids at 80 deg in f-d-f, a 25 mrad cone."""
    R, r = pkg_mirror.ReturnOptimalToroidalRadii(500.0, 80.0)
    tor = pkg_mirror.MirrorToroidal(R, r, pkg_supp.SupportRectangle(150, 32))
    mask = pkg_mask.Mask(pkg_supp.SupportRoundHole(20, 7, 0, 0))
    props = {"Divergence": 25e-3, "SourceSize": 0, "Wavelength": 80e-6, "DeltaFT": 0.5,
             "NumberRays": n}
    return Placement(props, [mask, tor, tor], [400.0, 100.0, 500.0], [0.0, 80.0, -80.0],
                     [0.0, 0.0, 0.0], "flagship")


class Pair:
    """The JAX chain, its twin in the port (returning the JAX chain's
    carried history), the final bundles and the detectors."""

    def __init__(self, monkeypatch, kind="parabola", n=2000, distance=100.0):
        if kind == "parabola":
            self.j = _parabola(jmirror, jsupp, JPlacement, n)
            self.t = _parabola(tmirror, tsupp, TPlacement, n).to("cpu")
        else:
            self.j = _flagship(jmask, jmirror, jsupp, JPlacement, n)
            self.t = _flagship(tmask, tmirror, tsupp, TPlacement, n).to("cpu")
        np.testing.assert_array_equal(np.asarray(self.j.source_rays.p),
                                      self.t.source_rays.p.numpy())
        self.jout = self.j.get_output_rays()
        self.tout = [carry(b) for b in self.jout]
        monkeypatch.setattr(self.t, "get_output_rays", lambda *a, **k: self.tout)
        self.jb, self.tb = self.jout[-1], self.tout[-1]
        self.jdet = jmain.setup_detector(self.j, dict(DET_OPTS, DistanceDetector=distance),
                                         self.jb)
        self.tdet = TDetector(self.jdet.refpoint, self.jdet.centre, self.jdet.normal)
        #: the scale of the delays' rounding: the longest path in fs
        self.path_fs = float(np.asarray(self.jb.opl).max()) / LIGHT_MM_PER_FS


def carry(bundle):
    return interop.bundle_from_numpy(jax.tree.map(np.asarray, bundle), device="cpu",
                                     dtype=torch.float64)


@pytest.fixture
def parabola(monkeypatch):
    return Pair(monkeypatch)


@pytest.fixture
def flagship(monkeypatch):
    return Pair(monkeypatch, "flagship", 3000, 500.0)


# ---------------------------------------------------------------------------
# what a figure carries
# ---------------------------------------------------------------------------


def _arr(x):
    a = np.ma.asarray(x)
    if a.dtype.kind in "fiub":
        return np.ma.filled(a.astype(np.float64), np.nan)
    return np.asarray(x)


def same(got, want, what="", floor=0.0):
    """Arrays equal to 1e-12 relative to the largest entry (or to
    ``floor``, the path in fs for delays, where that is larger), NaN masks
    identical."""
    got, want = _arr(got), _arr(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert (np.isnan(got) == np.isnan(want)).all(), f"{what}: NaN masks differ"
    finite = ~np.isnan(want)
    if finite.any():
        scale = max(np.abs(want[finite]).max(), floor)
        assert np.abs(got[finite] - want[finite]).max() <= RTOL * scale, what


def _collection(c):
    out = {"type": type(c).__name__}
    if hasattr(c, "_offsets3d"):
        out["offsets"] = np.asarray(c._offsets3d, dtype=np.float64)
    elif out["type"] == "PathCollection":
        out["offsets"] = c.get_offsets()
    if hasattr(c, "_segments3d"):
        out["segments"] = np.asarray(c._segments3d, dtype=np.float64)
    if getattr(c, "_vec", None) is not None:
        out["vec"] = np.asarray(c._vec)
    a = c.get_array()
    out["array"] = None if a is None else a
    return out


def summary(fig):
    """What a figure carries, as nested dicts and lists of arrays and
    strings."""
    axes = []
    for ax in fig.axes:
        is3d = hasattr(ax, "get_zlim")
        legend = ax.get_legend()
        axes.append({
            "titles": [ax.get_title(loc) for loc in ("left", "center", "right")],
            "labels": [ax.get_xlabel(), ax.get_ylabel(), ax.get_zlabel() if is3d else ""],
            "lims": np.array([ax.get_xlim(), ax.get_ylim()] + ([ax.get_zlim()] if is3d else [])),
            "legend": [t.get_text() for t in legend.get_texts()] if legend else [],
            "texts": [t.get_text() for t in ax.texts],
            "lines": [np.asarray(ln.get_data_3d()) if hasattr(ln, "get_data_3d") else ln.get_xydata()
                      for ln in ax.lines],
            "patches": [p.get_xy() for p in ax.patches],
            "images": [{"array": im.get_array(), "extent": np.asarray(im.get_extent()),
                        "cmap": im.get_cmap().name} for im in ax.images],
            "collections": [_collection(c) for c in ax.collections],
        })
    return {"suptitle": fig._suptitle.get_text() if fig._suptitle else "", "axes": axes}


def same_tree(got, want, what="figure", floor=0.0):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            same_tree(got[k], want[k], f"{what}.{k}", floor)
    elif isinstance(want, list):
        assert len(got) == len(want), (what, len(got), len(want))
        for i, (g, w) in enumerate(zip(got, want)):
            same_tree(g, w, f"{what}[{i}]", floor)
    elif want is None or isinstance(want, str):
        assert got == want, (what, got, want)
    else:
        same(got, want, what, floor)


def delay_floor(pair, fig):
    """``floor`` for a figure's arrays: the pair's path in fs where the
    figure maps delays."""
    return pair.path_fs if shows_delays(fig) else 0.0


def shows_delays(fig):
    """True when the figure maps delays: a title or axis label says so."""
    return any("Delay" in t for t in titles(fig)) or any(
        "Delay" in label for ax in fig.axes for label in (ax.get_ylabel(), getattr(
            ax, "get_zlabel", str)()))


def titles(fig):
    return [fig._suptitle.get_text() if fig._suptitle else ""] + [
        ax.get_title(loc) for ax in fig.axes for loc in ("left", "center", "right")]


# ---------------------------------------------------------------------------
# the public names
# ---------------------------------------------------------------------------


def test_public_signatures_match_jax():
    """Every public function of the JAX plots module exists in the port
    with the same signature; importing the port's module loaded no jax."""
    names = [n for n, obj in vars(jplots).items()
             if not n.startswith("_") and inspect.isfunction(obj)
             and obj.__module__ == jplots.__name__]
    assert {"SpotDiagram", "SpotDiagramImage", "DelayMapImage", "GigaRayImages", "DelayGraph",
            "MirrorProjection", "RayRenderGraph", "generate_distinct_colors", "show",
            "getETransmission", "GetResultSummary"} <= set(names)
    for name in names:
        assert inspect.signature(getattr(tplots, name)) == inspect.signature(getattr(jplots, name)), name
    for name in ("render", "quickshow"):
        assert inspect.signature(getattr(TChain, name)) == inspect.signature(getattr(JChain, name))
    for name in ("make_plots", "run_ART"):
        jparams = list(inspect.signature(getattr(jmain, name)).parameters)
        assert list(inspect.signature(getattr(tmain, name)).parameters)[:len(jparams)] == jparams


def test_transmission_and_summary(parabola):
    p = parabola
    assert tplots.getETransmission(carry(p.j.source_rays), p.tb) == pytest.approx(
        jplots.getETransmission(p.j.source_rays, p.jb), rel=RTOL)
    np.testing.assert_allclose(tplots.GetResultSummary(p.tdet, p.tb),
                               jplots.GetResultSummary(p.jdet, p.jb), rtol=1e-10)


# ---------------------------------------------------------------------------
# each plot: the port's data against the JAX figure, then the port's figure
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("draw_airy,color", [(True, None), (True, "Delay"), (False, "Intensity"),
                                              (False, "Incidence")])
def test_spot_diagram(parabola, draw_airy, color):
    p = parabola
    data = tplots.spot_diagram_data(p.tb, p.tdet, draw_airy, color)
    jfig = jplots.SpotDiagram(p.jb, p.jdet, draw_airy, color)
    ax = jfig.axes[0]
    sc = ax.collections[0]
    same(data.points, sc.get_offsets(), "points")
    if color is None:
        assert data.colors is None and sc.get_array() is None
    else:
        same(data.colors, sc.get_array(), "colors", p.path_fs if color == "Delay" else 0.0)
        assert data.color_label == jfig.axes[1].get_ylabel()
    assert data.legend == ax.get_legend().get_texts()[0].get_text()
    assert data.title == ax.get_title()
    same(np.array([-data.lim, data.lim]), ax.get_xlim(), "lim")
    if draw_airy:
        same(data.airy.T, ax.lines[0].get_xydata(), "airy")
    same_tree(summary(data.draw()), summary(jfig), floor=delay_floor(p, jfig))


def test_spot_diagram_key_navigation(parabola):
    """Right, right, left, up: after each key the port's figure carries the
    JAX figure's offsets, colours, legend and limits."""
    p = parabola
    jfig = jplots.SpotDiagram(p.jb, p.jdet, DrawAiryAndFourier=True, ColorCoded="Delay")
    tfig = tplots.SpotDiagram(p.tb, p.tdet, DrawAiryAndFourier=True, ColorCoded="Delay")
    for key in ["right", "right", "left", "up"]:
        for fig in (jfig, tfig):
            KeyEvent("key_press_event", fig.canvas, key)._process()
        same_tree(summary(tfig), summary(jfig), key, p.path_fs)
        assert tfig.axes[0].collections[0].get_clim() == pytest.approx(
            jfig.axes[0].collections[0].get_clim(), rel=RTOL)


@pytest.mark.parametrize("color", [None, "Intensity", "Delay", "Incidence"])
def test_spot_diagram_image(parabola, color):
    p = parabola
    data = tplots.spot_diagram_image_data(p.tb, p.tdet, True, color, bins=24)
    jfig = jplots.SpotDiagramImage(p.jb, p.jdet, True, color, bins=24)
    im = jfig.axes[0].images[0]
    same(data.image, im.get_array(), "image", delay_floor(p, jfig))
    assert np.isnan(data.image).any() and not np.isnan(data.image).all()
    same(np.asarray(data.extent), np.asarray(im.get_extent()), "extent")
    assert data.cmap == im.get_cmap().name
    assert data.text == jfig.axes[0].texts[0].get_text()
    assert data.title == jfig.axes[0].get_title()
    assert (data.color_label or "") == (jfig.axes[1].get_ylabel() if len(jfig.axes) > 1 else "")
    same_tree(summary(data.draw()), summary(jfig), floor=delay_floor(p, jfig))


@pytest.mark.parametrize("color", [None, "Intensity", "Incidence"])
def test_delay_map_image(parabola, color):
    p = parabola
    data = tplots.delay_map_image_data(p.tb, p.tdet, 2.7, False, color, bins=20)
    jfig = jplots.DelayMapImage(p.jb, p.jdet, 2.7, False, color, bins=20)
    same(data.image, jfig.axes[0].images[0].get_array(), "image", delay_floor(p, jfig))
    same_tree(summary(data.draw()), summary(jfig), floor=delay_floor(p, jfig))


def _float32_elements(chain):
    """The JAX chain's float32 element records, as tests/test_gigascan.py
    feeds its image engines."""
    return [e.to_device(dtype=np.float32) for e in chain.optical_elements]


def test_giga_ray_images(flagship):
    """The same ``fused_source_images`` result (the JAX package's, 4096
    rays on its XLA source engine) drawn by both packages."""
    p = flagship
    res = jgs.fused_source_images(p.j.source_spec, _float32_elements(p.j), p.jdet, n_total=4096,
                                  bins=(32, 32), engine="xla-source")
    res = jax.tree.map(np.asarray, res)
    data = tplots.giga_ray_images_data(res, title="flagship")
    jfig = jplots.GigaRayImages(res, title="flagship")
    same(data.image, jfig.axes[0].images[0].get_array(), "image")
    same(data.mean_delay, jfig.axes[1].images[0].get_array(), "mean delay")
    assert data.title == jfig.axes[0].get_title() and data.suptitle == "flagship"
    same_tree(summary(data.draw()), summary(jfig), floor=delay_floor(p, jfig))


@pytest.mark.parametrize("draw_airy,color", [(True, None), (False, "Incidence"), (True, "Intensity")])
def test_delay_graph(parabola, draw_airy, color):
    p = parabola
    data = tplots.delay_graph_data(p.tb, p.tdet, 2.7, draw_airy, color)
    jfig = jplots.DelayGraph(p.jb, p.jdet, 2.7, draw_airy, color)
    sc = jfig.axes[0].collections[0]
    xyz = np.asarray(sc._offsets3d, dtype=float)
    same(np.stack([data.x, data.y]), xyz[:2], "xy")
    same(data.delays, xyz[2], "delays", p.path_fs)
    same(data.colors, sc.get_array(), "colors", p.path_fs if color is None else 0.0)
    assert data.legend == jfig.axes[0].get_legend().get_texts()[0].get_text()
    assert (data.wireframe is not None) == draw_airy
    same_tree(summary(data.draw()), summary(jfig), floor=delay_floor(p, jfig))


@pytest.mark.parametrize("element,color,use_detector", [
    (-1, "Delay", True), (-1, "Incidence", False), (0, None, False), (1, "Intensity", True)])
def test_mirror_projection(flagship, element, color, use_detector):
    p = flagship
    data = tplots.mirror_projection_data(p.t, element, p.tdet if use_detector else None, color)
    jfig = jplots.MirrorProjection(p.j, element, p.jdet if use_detector else None, color)
    ax = jfig.axes[0]
    same(np.column_stack([data.x, data.y]), ax.collections[0].get_offsets(), "points")
    assert len(data.contours) == len(ax.patches)
    for contour, patch in zip(data.contours, ax.patches):
        same(contour, patch.get_xy(), "contour")
    assert data.title == ax.get_title(loc="right")
    same_tree(summary(data.draw()), summary(jfig), floor=delay_floor(p, jfig))


def test_mirror_projection_delay_needs_detector(flagship):
    """Both packages fail alike for delays without a detector: the colour
    data is taken first, so ``None.get_Delays`` raises before the
    ValueError."""
    p = flagship
    with pytest.raises(AttributeError):
        jplots.MirrorProjection(p.j, -1, None, "Delay")
    with pytest.raises(AttributeError):
        tplots.mirror_projection_data(p.t, -1, None, "Delay")


@pytest.mark.parametrize("kwargs", [{"maxRays": 40, "OEpoints": 300},
                                    {"maxRays": 30, "OEpoints": 200, "cycle_ray_colors": True},
                                    {"EndDistance": 120.0, "maxRays": 25, "OEpoints": 250,
                                     "draw_mesh": True}])
def test_ray_render_graph(flagship, kwargs):
    """The same rays chosen per hop (the JAX package's NumPy generator) and
    the same element samples; with ``draw_mesh`` the same triangles."""
    p = flagship
    data = tplots.ray_render_graph_data(p.t, **kwargs)
    jfig = jplots.RayRenderGraph(p.j, **kwargs)
    lines = [ln.get_data_3d() for ln in jfig.axes[0].lines]
    segs = np.concatenate(data.segment_sets)
    same(segs.transpose(0, 2, 1), np.asarray(lines), "segments")
    same_tree(summary(data.draw()), summary(jfig))


@pytest.mark.parametrize("max_rays", [7, 1000, 4000])
def test_ray_segments_match_jax(flagship, max_rays):
    """The rays of each hop: all alive ones up to ``max_rays``, else the
    JAX package's choice (seed 0, one draw per hop in hop order)."""
    p = flagship
    jsets = jplots._ray_segments([jax.tree.map(np.asarray, b) for b in [p.j.source_rays] + p.jout],
                                 55.0, max_rays)
    tsets = tplots._ray_segments([p.t.source_rays] + p.tout, 55.0, max_rays)
    assert len(tsets) == len(jsets) == 4
    for tset, jset in zip(tsets, jsets):
        assert len(tset) == len(jset) == min(max_rays, len(tset)) or max_rays == 1000
        same(tset, np.asarray(jset).reshape(len(jset), 2, 3), "segments")


def test_element_mesh_matches_jax(flagship):
    """``draw_mesh``'s triangulation (the JAX side:
    tests/test_plots_driver.py:127) on the holed mask and a toroid."""
    p = flagship
    for tel, jel in zip(p.t.optical_elements, p.j.optical_elements):
        tpts, ttris = tplots._element_mesh_lab(tel, 400)
        jpts, jtris = jplots._element_mesh_lab(jel, 400)
        same(tpts, jpts, "mesh points")
        np.testing.assert_array_equal(ttris, jtris)


def test_render_and_quickshow(flagship):
    p = flagship
    same_tree(summary(p.t.render(maxRays=30, OEpoints=200)),
              summary(p.j.render(maxRays=30, OEpoints=200)))
    same_tree(summary(p.t.quickshow()), summary(p.j.quickshow()))


# ---------------------------------------------------------------------------
# the dispatch
# ---------------------------------------------------------------------------

SPOTS = {"plot_SpotDiagram": True, "plot_DelaySpotDiagram": True,
         "plot_IncidenceSpotDiagram": True, "plot_IntensityGraph": True,
         "plot_DelayGraph": True, "plot_IncidenceGraph": True}


@pytest.mark.parametrize("case", ["scatter", "images", "auto-below", "auto-above", "giga",
                                  "giga-no-spec"])
def test_make_plots_dispatch(monkeypatch, capsys, case):
    """``make_plots`` draws the JAX package's figures in its order: spot
    plots and graphs as scatters or device-binned images (``image_plots``
    False / True / "auto" below and above ``PALLAS_MIN_RAYS``), and with
    ``image_rays`` the giga-ray images in place of the intensity and delay
    plots (render and mirror projections first), or the "image_rays
    ignored" line for a chain without a ``source_spec``."""
    p = Pair(monkeypatch, "flagship", 2000, 500.0)
    ao = dict(SPOTS, verbose=False, image_bins=16, maxRaysToRender=20, OEPointsToRender=200)
    if case in ("scatter", "images"):
        ao["image_plots"] = case == "images"
    if case == "auto-above":
        for mod in (jchain_mod, tchain_mod):
            monkeypatch.setattr(mod, "PALLAS_MIN_RAYS", 1000)
    if case.startswith("giga"):
        ao.update(image_rays=4096, plot_Render=True, plot_IncidenceMirrorProjection=True)
        # the JAX package's XLA source engine on float32 elements (no
        # interpret-mode Pallas)
        image_fn = jgs.fused_source_images
        monkeypatch.setattr(jgs, "fused_source_images", lambda spec, _els, det, **kw: image_fn(
            spec, _float32_elements(p.j), det, engine="xla-source", **kw))
    if case == "giga-no-spec":
        p.j.source_rays = p.j.source_rays
        p.t.source_rays = p.t.source_rays
    sp, do, ao = jmain.complete_defaults({"DeltaFT": 0.5}, dict(DET_OPTS, DistanceDetector=500.0),
                                         ao)
    runs = {}
    for pkg, module, chain, bundle, det in (("jax", jmain, p.j, p.jb, p.jdet),
                                            ("port", tmain, p.t, p.tb, p.tdet)):
        plt.close("all")
        capsys.readouterr()
        module.make_plots(chain, bundle, det, sp, do, ao)
        figs = [plt.figure(n) for n in plt.get_fignums()]
        runs[pkg] = ([titles(f) for f in figs], capsys.readouterr().out, figs)
    (jt, jout, jfigs), (tt, tout, tfigs) = runs["jax"], runs["port"]
    assert tt == jt
    assert len(tt) == {"scatter": 6, "images": 6, "auto-below": 6, "auto-above": 6, "giga": 5,
                       "giga-no-spec": 8}[case]
    names = [name for name, _ in tmain._plot_calls(p.t, p.tb, p.tdet, sp, do, ao)]
    scatter = case in ("scatter", "auto-below")
    if case == "giga":
        assert names == ["RayRenderGraph", "MirrorProjection", "GigaRayImages", "SpotDiagram",
                         "DelayGraph"]
    elif not case.startswith("giga"):
        assert names == (["SpotDiagram"] * 3 + ["DelayGraph"] * 3 if scatter
                         else ["SpotDiagramImage"] * 3 + ["DelayMapImage"] * 3)
    if case == "giga-no-spec":
        line = "image_rays ignored: this chain's source is not in-kernel synthesizable (no source_spec)."
        assert jout.count(line) == 1 and tout.count(line) == 1
        assert tout.split("]", 1)[1].strip() == jout.split("]", 1)[1].strip()
    else:
        assert "image_rays ignored" not in tout
    if case != "giga":  # the giga-ray images come from two engines: test_torch_gigascan.py
        for tf, jf in zip(tfigs, jfigs):
            same_tree(summary(tf), summary(jf), floor=delay_floor(p, jf))


def test_make_plots_without_matplotlib(monkeypatch, capsys, parabola):
    """With matplotlib hidden, the port's plots module still runs every data
    function, and ``run_ART`` prints one line naming the requested plots and
    returns what it returns with the plots off."""
    p = parabola
    sp, do, ao = tmain.complete_defaults({"NumberRays": 2000, "DeltaFT": 2.7}, DET_OPTS,
                                         dict(SPOTS, verbose=False))
    quiet = {k: (False if k.startswith("plot_") else v) for k, v in ao.items()}
    want = tmain.run_ART(p.t, sp, do, quiet, device="cpu")
    for name in [n for n in sys.modules if n == "matplotlib" or n.startswith("matplotlib.")]:
        monkeypatch.setitem(sys.modules, name, None)
    with pytest.raises(ImportError):
        tplots.pyplot()
    records = [tplots.spot_diagram_data(p.tb, p.tdet, True, "Delay"),
               tplots.spot_diagram_image_data(p.tb, p.tdet, True, "Incidence", bins=16),
               tplots.delay_map_image_data(p.tb, p.tdet, 2.7, bins=16),
               tplots.delay_graph_data(p.tb, p.tdet, 2.7, True),
               tplots.mirror_projection_data(p.t, -1, p.tdet, "Intensity"),
               tplots.ray_render_graph_data(p.t, maxRays=20, OEpoints=100)]
    assert records[0].navigator.key("right") is not None
    assert all(r is not None for r in records)
    capsys.readouterr()
    got = tmain.run_ART(p.t, sp, do, ao, device="cpu")
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1 and "matplotlib cannot be imported" in err[0]
    assert all(k in err[0] for k in SPOTS)
    assert got[2:] == want[2:]
    assert got[1].get_distance() == want[1].get_distance()


# ---------------------------------------------------------------------------
# the giga-ray example on the port's names
# ---------------------------------------------------------------------------


def test_gigaray_example(monkeypatch, tmp_path):
    """``python -m attosecondraytracing_tpu_torch.examples.gigaray_delay_map
    16384 --device cpu`` writes its PNG into the working directory, and its
    images equal a direct ``fused_source_images`` call on its chain."""
    from attosecondraytracing_tpu_torch.analysis.gigascan import fused_source_images
    from attosecondraytracing_tpu_torch.examples import gigaray_delay_map as ex

    monkeypatch.chdir(tmp_path)
    res = ex.cli(["16384", "--device", "cpu"])
    assert (tmp_path / ex.OUT).stat().st_size > 0
    chain, det = ex.chain_and_detector("cpu")
    ref = fused_source_images(chain.source_spec, chain.device_elements(torch.float32), det,
                              n_total=16384, bins=(512, 512))
    assert res["sum_w"] > 0
    for key in ("image", "mean_delay"):
        np.testing.assert_array_equal(res[key], ref[key])
    same(np.asarray(res["extent"]), np.asarray(ref["extent"]), "extent")
