"""Standard visualizations (counterpart of the JAX package's
``analysis/plots.py``, ART/ModuleAnalysisAndPlots.py).

The same plot set and signatures: interactive spot diagram (left/right
arrows move the detector), device-binned spot and delay images, giga-ray
images, 3D delay graph, mirror projection and a 3D render of the optical
chain (PyVista when importable, else matplotlib 3D).

Each plot is split in two. Its data function (``spot_diagram_data``,
``spot_diagram_image_data``, ...) takes the plot's arguments, does the ray
work on the bundle's device (tensors) and returns a record of host NumPy
arrays and strings: exactly what the JAX function hands to matplotlib.
Only what is drawn crosses to the host: the alive points of a scatter, the
O(bins^2) pixels of an image, ``maxRays`` segments per hop of a render. The
record's ``draw()`` draws it; the public function is the two in turn.
matplotlib is imported at the first drawing (:func:`pyplot`), never when
this module is imported, so the data half runs where matplotlib is absent.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops import supports as sup
from ..ops.bundle import RayBundle
from . import stats


def pyplot():
    """``matplotlib.pyplot``, imported on first use with the JAX package's
    backend rule: a GUI backend already chosen stays, anything else becomes
    the headless ``Agg``. Raises ImportError where matplotlib is missing."""
    import matplotlib

    if not (matplotlib.get_backend() or "").lower().startswith(("qt", "tk", "gtk", "macosx")):
        try:  # headless default
            matplotlib.use("Agg", force=False)
        except Exception:
            pass
    import matplotlib.pyplot as plt

    return plt


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def _alive(bundle):
    return bundle.alive


def _detector_points_um(bundle: RayBundle, detector):
    """(x_um, y_um, focal_spot_minmax, spot_sd) of surviving impact points
    (_getDetectorPoints, ART/ModuleAnalysisAndPlots.py:28-58): selected on
    the bundle's device, reduced on the host as the JAX package does."""
    xy = _host(detector.get_PointList2DCentre(bundle)[_alive(bundle)])
    spot_sd = float(np.sqrt(np.var(xy, axis=0).sum())) if len(xy) else 0.0
    extent = float(max(np.ptp(xy[:, 0]), np.ptp(xy[:, 1]))) if len(xy) else 0.0
    return xy[:, 0] * 1e3, xy[:, 1] * 1e3, extent, spot_sd


def getETransmission(source: RayBundle, out: RayBundle) -> float:
    """Energy transmission in percent (ART/ModuleAnalysisAndPlots.py:62-77)."""
    return float(stats.energy_transmission(source, out))


def GetResultSummary(detector, bundle: RayBundle, verbose=False):
    from ..main import get_result_summary

    return get_result_summary(detector, bundle, verbose)


def _color_data(bundle: RayBundle, detector, color_coded):
    alive = _alive(bundle)
    if color_coded == "Intensity":
        return _host(bundle.intensity[alive]), "Intensity (arb.u.)"
    if color_coded == "Incidence":
        return _host(torch.rad2deg(bundle.incidence)[alive]), "Incidence angle (deg)"
    if color_coded == "Delay":
        return _host(detector.get_Delays(bundle)[alive]), "Delay (fs)"
    return None, None


def _airy_um(bundle: RayBundle) -> float:
    na = float(stats.numerical_aperture(bundle))
    return float(stats.airy_radius(float(bundle.wavelength), na)) * 1e3


def _circle(radius):
    th = np.linspace(0, 2 * np.pi, 100)
    return np.stack([radius * np.cos(th), radius * np.sin(th)])


def _spot_lim(airy_um, extent):
    return 1.1 * max(airy_um, 0.5 * extent * 1e3, 1e-12)


def _spot_step(extent, na_safe):
    return min(50, max(0.0005, round(extent / 8 / np.arcsin(na_safe) * 10000) / 10000))


# ---------------------------------------------------------------------------
# SpotDiagram
# ---------------------------------------------------------------------------


@dataclass
class SpotData:
    """What :func:`SpotDiagram` draws: the scatter ``points`` (N, 2) [µm]
    coloured by ``colors`` (None: red) with colorbar ``color_label``, the
    ``legend`` text, the axes' half-width ``lim`` [µm], the ``title``, the
    Airy circle (2, 100) [µm] or None, and the ``navigator`` that the arrow
    keys drive."""

    points: np.ndarray
    colors: np.ndarray | None
    color_label: str | None
    legend: str
    lim: float
    title: str
    airy: np.ndarray | None
    navigator: "SpotNavigator"

    def draw(self):
        plt = pyplot()
        fig, ax = plt.subplots()
        if self.airy is not None:
            ax.plot(self.airy[0], self.airy[1], c="black")
        sc = ax.scatter(self.points[:, 0], self.points[:, 1],
                        c=self.colors if self.colors is not None else "red", s=15,
                        label=self.legend)
        if self.color_label:
            fig.colorbar(sc).set_label(self.color_label)
        ax.set_xlim(-self.lim, self.lim)
        ax.set_ylim(-self.lim, self.lim)
        ax.legend(loc="upper right")
        ax.set_xlabel("X (µm)")
        ax.set_ylabel("Y (µm)")
        ax.set_title(self.title)

        def on_key(event):
            new = self.navigator.key(event.key)
            if new is None:
                return
            sc.set_offsets(new.points)
            if new.colors is not None:  # delays move with the detector
                sc.set_array(new.colors)
                sc.set_clim(new.colors.min(), new.colors.max())
            sc.set_label(new.legend)
            ax.legend(loc="upper right")
            ax.set_xlim(-new.lim, new.lim)
            ax.set_ylim(-new.lim, new.lim)
            fig.canvas.draw_idle()

        fig.canvas.mpl_connect("key_press_event", on_key)
        _maybe_show()
        return fig


class SpotNavigator:
    """The spot diagram's arrow keys: "right" moves a copy of the detector
    one step downstream, "left" one step upstream (or to half a step from
    its reference point), and each move recomputes the points, the legend,
    the limits and the step on the bundle's device
    (ART/ModuleAnalysisAndPlots.py:133-280)."""

    def __init__(self, bundle, detector, color_coded, airy_um, na_safe, extent):
        self.bundle = bundle
        self.detector = detector.copy_detector()
        self.dist = detector.get_distance()
        self.color_coded = color_coded
        self.airy_um = airy_um
        self.na_safe = na_safe
        self.step = _spot_step(extent, na_safe)

    def key(self, key) -> SpotData | None:
        """The points, the delays (None unless colour-coded by delay), the
        legend and ``lim`` after ``key``, or None for a key that moves
        nothing."""
        if key == "right":
            self.detector.shiftByDistance(self.step)
            self.dist += self.step
        elif key == "left":
            if self.dist > 1.5 * self.step:
                self.detector.shiftByDistance(-self.step)
                self.dist -= self.step
            else:
                self.detector.shiftToDistance(0.5 * self.step)
                self.dist = 0.5 * self.step
        else:
            return None
        nx, ny, nextent, nsd = _detector_points_um(self.bundle, self.detector)
        label = f"{self.dist:.3f} mm\n{nsd * 1e3:.1f} μm SD"
        nz = None
        if self.color_coded == "Delay":
            nz = _host(self.detector.get_Delays(self.bundle)[_alive(self.bundle)])
            label += f"\n{np.std(nz):.2f} fs SD"
        self.step = _spot_step(nextent, self.na_safe)
        return SpotData(np.column_stack([nx, ny]), nz, None, label,
                        _spot_lim(self.airy_um, nextent), "", None, self)


def spot_diagram_data(bundle: RayBundle, detector, DrawAiryAndFourier=False, ColorCoded=None):
    """:class:`SpotData` of :func:`SpotDiagram`."""
    na = float(stats.numerical_aperture(bundle))
    airy_um = float(stats.airy_radius(float(bundle.wavelength), na)) * 1e3 if DrawAiryAndFourier else 0.0

    x_um, y_um, extent, spot_sd = _detector_points_um(bundle, detector)
    z, zlabel = _color_data(bundle, detector, ColorCoded)

    label = f"{detector.get_distance():.3f} mm\n{spot_sd * 1e3:.1f} μm SD"
    if ColorCoded == "Delay":
        label += f"\n{np.std(z):.2f} fs SD"
    title = (ColorCoded + " + " if ColorCoded else "") + "Spot Diagram\n press left/right to move detector position"
    na_safe = max(min(na, 1.0), 1e-9)
    return SpotData(
        points=np.column_stack([x_um, y_um]), colors=z, color_label=zlabel, legend=label,
        lim=_spot_lim(airy_um, extent), title=title,
        airy=_circle(airy_um) if DrawAiryAndFourier and airy_um > 0 else None,
        navigator=SpotNavigator(bundle, detector, ColorCoded, airy_um, na_safe, extent))


def SpotDiagram(bundle: RayBundle, detector, DrawAiryAndFourier=False, ColorCoded=None):
    """Interactive spot diagram; arrows shift the detector
    (ART/ModuleAnalysisAndPlots.py:133-280)."""
    return spot_diagram_data(bundle, detector, DrawAiryAndFourier, ColorCoded).draw()


# ---------------------------------------------------------------------------
# device-binned images
# ---------------------------------------------------------------------------


def _image_data(bundle: RayBundle, detector, ColorCoded, bins):
    """(image, (lo, hi), colorbar label) for the device-binned plots, binned
    where the bundle lives; only the image and its corners reach the host.
    The image is NaN where no weight fell (mean-value maps and the
    intensity image alike)."""
    from .histogram import value_map

    if ColorCoded in (None, "Intensity"):
        img, (lo, hi) = detector.get_Image(bundle, bins=(bins, bins))
        label = "Intensity (arb.u.)" if ColorCoded else None
        return _host(torch.where(img > 0, img, float("nan"))), (_host(lo), _host(hi)), label
    if ColorCoded == "Delay":
        mean, _w, (lo, hi) = detector.get_DelayMap(bundle, bins=(bins, bins))
        return _host(mean), (_host(lo), _host(hi)), "Delay (fs)"
    if ColorCoded == "Incidence":
        mean, _w, (lo, hi) = value_map(
            bundle, torch.rad2deg(bundle.incidence),
            detector.centre, detector.normal, detector._plane_rotation(),
            bins=(bins, bins),
        )
        return _host(mean), (_host(lo), _host(hi)), "Incidence angle (deg)"
    raise ValueError(f"unknown ColorCoded {ColorCoded!r}")


def _recentred_extent(lo, hi):
    """imshow's (left, right, bottom, top) [µm] of the window (lo, hi) [mm]
    about its middle, like the scatter plot's get_PointList2DCentre."""
    lo, hi = np.asarray(lo), np.asarray(hi)
    mid = 0.5 * (lo + hi)
    lo_um, hi_um = (lo - mid) * 1e3, (hi - mid) * 1e3
    return (lo_um[0], hi_um[0], lo_um[1], hi_um[1])


@dataclass
class ImageData:
    """What :func:`SpotDiagramImage` draws: ``image`` as imshow takes it (y
    along axis 0, NaN where no weight fell), its ``extent`` [µm], ``cmap``,
    colorbar ``color_label`` (or None), the Airy circle (2, 100) [µm] or
    None, the corner ``text`` and the ``title``."""

    image: np.ndarray
    extent: tuple
    cmap: str
    color_label: str | None
    airy: np.ndarray | None
    text: str
    title: str

    def draw(self):
        plt = pyplot()
        fig, ax = plt.subplots()
        im = ax.imshow(self.image, origin="lower", extent=self.extent, aspect="equal",
                       cmap=self.cmap)
        if self.color_label:
            fig.colorbar(im).set_label(self.color_label)
        if self.airy is not None:
            ax.plot(self.airy[0], self.airy[1], c="white", lw=0.8)
        ax.set_xlabel("X (µm)")
        ax.set_ylabel("Y (µm)")
        ax.set_title(self.title)
        ax.text(0.02, 0.98, self.text, transform=ax.transAxes, va="top", ha="left",
                color="white", fontsize=8)
        _maybe_show()
        return fig


def spot_diagram_image_data(bundle: RayBundle, detector, DrawAiryAndFourier=False,
                            ColorCoded=None, bins=256):
    """:class:`ImageData` of :func:`SpotDiagramImage`."""
    img, (lo, hi), zlabel = _image_data(bundle, detector, ColorCoded, bins)
    spot_sd, duration_sd = detector.get_SpotAndDuration(bundle)
    airy = None
    if DrawAiryAndFourier:
        airy_um = _airy_um(bundle)
        if airy_um > 0:
            airy = _circle(airy_um)
    label = f"{detector.get_distance():.3f} mm\n{float(spot_sd) * 1e3:.1f} μm SD"
    if ColorCoded == "Delay":
        label += f"\n{float(duration_sd):.2f} fs SD"
    return ImageData(
        image=img.T,  # histogram layout: x along axis 0 -> transpose for imshow
        extent=_recentred_extent(lo, hi),
        cmap="inferno" if ColorCoded in (None, "Intensity") else "viridis",
        color_label=zlabel, airy=airy, text=label,
        title=(ColorCoded + " + " if ColorCoded else "") + "Spot Diagram (device-binned)")


def SpotDiagramImage(bundle: RayBundle, detector, DrawAiryAndFourier=False,
                     ColorCoded=None, bins=256):
    """Device-binned spot diagram: the gather-free equivalent of
    :func:`SpotDiagram` for production-size bundles (only O(bins^2) bytes
    leave the device; the scatter version fetches every ray). Default is the
    intensity histogram; ``ColorCoded`` "Delay"/"Incidence" show per-pixel
    weighted means instead."""
    return spot_diagram_image_data(bundle, detector, DrawAiryAndFourier, ColorCoded, bins).draw()


def delay_map_image_data(bundle: RayBundle, detector, DeltaFT=None,
                         DrawAiryAndFourier=False, ColorCoded=None, bins=256):
    """:class:`ImageData` of :func:`DelayMapImage`."""
    which = "Delay" if ColorCoded in (None, "Delay") else ColorCoded
    return spot_diagram_image_data(bundle, detector, DrawAiryAndFourier, which, bins)


def DelayMapImage(bundle: RayBundle, detector, DeltaFT=None,
                  DrawAiryAndFourier=False, ColorCoded=None, bins=256):
    """Device-binned spatio-temporal distortion map: per-pixel mean delay
    [fs] over the detector plane — the production-size replacement for the 3D
    :func:`DelayGraph` scatter (``ColorCoded`` "Intensity"/"Incidence" swap
    the mapped quantity, as in the reference's color-coded delay graphs)."""
    return delay_map_image_data(bundle, detector, DeltaFT, DrawAiryAndFourier, ColorCoded,
                                bins).draw()


@dataclass
class GigaData:
    """What :func:`GigaRayImages` draws: the intensity ``image`` and the
    ``mean_delay`` map as imshow takes them, their ``extent`` [µm], the
    intensity panel's ``title`` and the figure's ``suptitle`` ("" for
    none)."""

    image: np.ndarray
    mean_delay: np.ndarray
    extent: tuple
    title: str
    suptitle: str

    def draw(self):
        plt = pyplot()
        fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4.6))
        im1 = ax1.imshow(self.image, origin="lower", extent=self.extent,
                         aspect="equal", cmap="inferno")
        ax1.set_title(self.title)
        fig.colorbar(im1, ax=ax1).set_label("weight / pixel")
        im2 = ax2.imshow(self.mean_delay, origin="lower", extent=self.extent,
                         aspect="equal", cmap="coolwarm")
        ax2.set_title("Mean delay (fs)")
        fig.colorbar(im2, ax=ax2).set_label("fs")
        for ax in (ax1, ax2):
            ax.set_xlabel("X (µm)")
            ax.set_ylabel("Y (µm)")
        if self.suptitle:
            fig.suptitle(self.suptitle)
        fig.tight_layout()
        _maybe_show()
        return fig


def giga_ray_images_data(res: dict, title: str = ""):
    """:class:`GigaData` of :func:`GigaRayImages`."""
    return GigaData(image=np.asarray(res["image"]).T, mean_delay=np.asarray(res["mean_delay"]).T,
                    extent=_recentred_extent(*res["extent"]),
                    title=f"Intensity ({res['n_total']:.2e} rays)", suptitle=title)


def GigaRayImages(res: dict, title: str = ""):
    """Intensity image + mean-delay map from a
    :func:`attosecondraytracing_tpu_torch.analysis.gigascan.fused_source_images`
    result: the detector images at ray counts far beyond any traced bundle
    (the source is synthesized chunk-wise inside the image kernel and binned
    on the device)."""
    return giga_ray_images_data(res, title).draw()


# ---------------------------------------------------------------------------
# DelayGraph
# ---------------------------------------------------------------------------


@dataclass
class GraphData:
    """What :func:`DelayGraph` draws: the 3D scatter ``x``, ``y`` [µm] and
    ``delays`` [fs] coloured by ``colors`` with colorbar ``color_label`` (or
    None), the ``legend``, the Airy cylinder's two wireframes (X, Y, Z) and
    (X, -Y, Z) as ``wireframe`` (or None) and the axes' half-width ``lim``."""

    x: np.ndarray
    y: np.ndarray
    delays: np.ndarray
    colors: np.ndarray
    color_label: str | None
    legend: str
    wireframe: tuple | None
    lim: float

    def draw(self):
        plt = pyplot()
        fig = plt.figure()
        ax = fig.add_subplot(projection="3d")
        ax.set_xlabel("X (µm)")
        ax.set_ylabel("Y (µm)")
        ax.set_zlabel("Delay (fs)")
        sc = ax.scatter(self.x, self.y, self.delays, s=4, c=self.colors, label=self.legend)
        if self.color_label:
            fig.colorbar(sc, pad=0.12).set_label(self.color_label)
        ax.legend(loc="upper right")
        if self.wireframe is not None:
            X, Y, Z = self.wireframe
            ax.plot_wireframe(X, Y, Z, color="grey", alpha=0.1)
            ax.plot_wireframe(X, -Y, Z, color="grey", alpha=0.1)
        ax.set_xlim(-self.lim, self.lim)
        ax.set_ylim(-self.lim, self.lim)
        _maybe_show()
        return fig


def delay_graph_data(bundle: RayBundle, detector, DeltaFT, DrawAiryAndFourier=False,
                     ColorCoded=None):
    """:class:`GraphData` of :func:`DelayGraph`."""
    airy_um = _airy_um(bundle)
    x_um, y_um, extent, spot_sd = _detector_points_um(bundle, detector)
    delays = _host(detector.get_Delays(bundle)[_alive(bundle)])
    z, zlabel = _color_data(bundle, detector, ColorCoded)
    label = f"{detector.get_distance():.3f} mm\n{spot_sd * 1e3:.1f} μm SD\n{np.std(delays):.2f} fs SD"
    wireframe = None
    if DrawAiryAndFourier and airy_um > 0:
        xs = np.linspace(-airy_um, airy_um, 40)
        zs = np.linspace(np.mean(delays) - DeltaFT * 0.5, np.mean(delays) + DeltaFT * 0.5, 40)
        X, Z = np.meshgrid(xs, zs)
        wireframe = (X, np.sqrt(np.maximum(airy_um**2 - X**2, 0.0)), Z)
    return GraphData(x=x_um, y=y_um, delays=delays, colors=z if z is not None else delays,
                     color_label=zlabel, legend=label, wireframe=wireframe,
                     lim=_spot_lim(airy_um, extent))


def DelayGraph(bundle: RayBundle, detector, DeltaFT, DrawAiryAndFourier=False, ColorCoded=None):
    """3D spot diagram with ray delay on the z-axis
    (ART/ModuleAnalysisAndPlots.py:284-440)."""
    return delay_graph_data(bundle, detector, DeltaFT, DrawAiryAndFourier, ColorCoded).draw()


# ---------------------------------------------------------------------------
# MirrorProjection
# ---------------------------------------------------------------------------


@dataclass
class ProjectionData:
    """What :func:`MirrorProjection` draws: the support's closed
    ``contours`` (each (n + 1, 2) [mm]), the impact points ``x``, ``y`` [mm]
    in the support plane coloured by ``colors`` (None: red) with colorbar
    ``color_label``, and the right-hand ``title``."""

    contours: list
    x: np.ndarray
    y: np.ndarray
    colors: np.ndarray | None
    color_label: str | None
    title: str

    def draw(self):
        plt = pyplot()
        fig, ax = plt.subplots(subplot_kw={"aspect": "equal"})
        for closed in self.contours:
            ax.fill(closed[:, 0], closed[:, 1], alpha=0.08, color="C0")
        p = ax.scatter(self.x, self.y, c=self.colors if self.colors is not None else "red", s=15)
        if self.color_label:
            fig.colorbar(p).set_label(self.color_label)
        ax.set_xlabel("x (mm)")
        ax.set_ylabel("y (mm)")
        ax.set_title(self.title, loc="right")
        _maybe_show()
        return fig


def mirror_projection_data(chain, ReflectionNumber: int, Detector=None, ColorCoded=None):
    """:class:`ProjectionData` of :func:`MirrorProjection`: the traced
    history's bundle at the element, projected on its device."""
    element = chain.optical_elements[ReflectionNumber]
    bundle = chain.get_output_rays()[ReflectionNumber]
    alive = _alive(bundle)
    # into the mirror-support frame (mirror frame without the centre shift),
    # in float64 like the JAX package's host arithmetic
    p = bundle.p[alive].to(torch.float64)
    R = torch.as_tensor(element.frame_rotation(), dtype=torch.float64, device=p.device)
    local = _host((p - torch.as_tensor(element.position, dtype=torch.float64, device=p.device))
                  @ R.T)

    z, zlabel = _color_data(bundle, Detector, ColorCoded)
    if ColorCoded == "Delay" and Detector is None:
        raise ValueError("If you want to project ray delays, you must specify a detector.")
    title = f"Ray {ColorCoded.lower()} projected on mirror" if ColorCoded else "Ray impact points projected on mirror"
    return ProjectionData(
        contours=[np.vstack([c, c[:1]]) for c in sup.contour_points(element.type.support, 200)],
        x=local[:, 0], y=local[:, 1], colors=z, color_label=zlabel, title=title)


def MirrorProjection(chain, ReflectionNumber: int, Detector=None, ColorCoded=None):
    """Ray impact points projected on the optic's support plane
    (ART/ModuleAnalysisAndPlots.py:444-525)."""
    return mirror_projection_data(chain, ReflectionNumber, Detector, ColorCoded).draw()


# ---------------------------------------------------------------------------
# RayRenderGraph
# ---------------------------------------------------------------------------


def generate_distinct_colors(num_colors):
    """Distinct ray-bundle colors (reference uses colorcet glasbey; fall back
    to matplotlib's tab20)."""
    try:
        import colorcet as cc

        palette = cc.glasbey
        return palette[: min(num_colors, len(palette))]
    except ImportError:
        cmap = pyplot().get_cmap("tab20")
        return [cmap(i % 20) for i in range(num_colors)]


@dataclass
class RenderData:
    """What :func:`RayRenderGraph` draws: per hop the ray ``segment_sets``
    (each (k, 2, 3) [mm]: start and end points), per element its sampled
    surface ``element_points`` (lab frame) and, for ``draw_mesh``, the
    ``elements`` to triangulate, with the render options."""

    segment_sets: list
    element_points: list
    elements: list
    OEpoints: int
    scale_spheres: float
    draw_mesh: bool
    cycle_ray_colors: bool

    def colors(self):
        n = len(self.segment_sets)
        return generate_distinct_colors(n) if self.cycle_ray_colors else [(0.7, 0, 0)] * n

    def draw(self):
        try:
            import pyvista as pv
        except ImportError:
            pv = None
        if pv is not None:
            return _render_pyvista(self)
        plt = pyplot()
        fig = plt.figure(figsize=(12, 5))
        ax = fig.add_subplot(projection="3d")
        for segs, color in zip(self.segment_sets, self.colors()):
            for a, b in segs:
                ax.plot([a[0], b[0]], [a[1], b[1]], [a[2], b[2]], color=color, linewidth=0.5,
                        alpha=0.6)
        for element, pts in zip(self.elements, self.element_points):
            if self.draw_mesh:
                mpts, tris = _element_mesh_lab(element, self.OEpoints)
                if len(tris):
                    ax.plot_trisurf(mpts[:, 0], mpts[:, 1], mpts[:, 2], triangles=tris, alpha=0.4,
                                    linewidth=0.1)
                    continue
            ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=self.scale_spheres * 0.2, alpha=0.5)
        ax.set_xlabel("x (mm)")
        ax.set_ylabel("y (mm)")
        ax.set_zlabel("z (mm)")
        try:
            ax.set_aspect("equal")
        except NotImplementedError:
            pass
        _maybe_show()
        return fig


def ray_render_graph_data(chain, EndDistance=None, maxRays=300, OEpoints=3000,
                          scale_spheres=5.0, draw_mesh=False, cycle_ray_colors=False):
    """:class:`RenderData` of :func:`RayRenderGraph`: the chain's source and
    traced history stay on their devices; ``maxRays`` segments per hop come
    to the host."""
    history = [chain.source_rays] + list(chain.get_output_rays())
    if EndDistance is None:
        EndDistance = float(np.linalg.norm(
            _host(history[0].p[0]) - chain.optical_elements[0].position))
    return RenderData(
        segment_sets=_ray_segments(history, EndDistance, maxRays),
        element_points=[_element_points_lab(el, OEpoints) for el in chain.optical_elements],
        elements=list(chain.optical_elements), OEpoints=OEpoints, scale_spheres=scale_spheres,
        draw_mesh=draw_mesh, cycle_ray_colors=cycle_ray_colors)


def RayRenderGraph(
    chain,
    EndDistance=None,
    maxRays=300,
    OEpoints=3000,
    scale_spheres=5.0,
    draw_mesh=False,
    cycle_ray_colors=False,
):
    """3D rendering of optics + traced rays
    (ART/ModuleAnalysisAndPlots.py:616-673). Uses PyVista when available
    (same look as the reference), otherwise matplotlib 3D."""
    return ray_render_graph_data(chain, EndDistance, maxRays, OEpoints, scale_spheres,
                                 draw_mesh, cycle_ray_colors).draw()


def _render_pyvista(data: RenderData):
    """PyVista scene (reference RayRenderGraph look,
    ART/ModuleAnalysisAndPlots.py:616-673). Only reached when pyvista is
    installed.

    With a display and pyvistaqt available, the scene opens in a *live,
    non-blocking* ``BackgroundPlotter`` window (the reference's interactive
    3D scene, ART/ModuleAnalysisAndPlots.py:648-668) so script execution
    continues while the user orbits the model; otherwise a plain (blocking
    or off-screen) ``pv.Plotter`` is used."""
    import pyvista as pv

    plotter = None
    background = False
    if _has_display():
        try:
            from pyvistaqt import BackgroundPlotter

            plotter = BackgroundPlotter(window_size=(1500, 500))
            background = True
        except Exception:
            plotter = None  # no Qt stack: fall through to the blocking plotter
    if plotter is None:
        plotter = pv.Plotter(window_size=(1500, 500), off_screen=not _has_display())
    plotter.set_background("white")
    for segs, color in zip(data.segment_sets, data.colors()):
        if len(segs):
            plotter.add_mesh(pv.line_segments_from_points(segs.reshape(-1, 3)), color=color[:3])
    for element, pts in zip(data.elements, data.element_points):
        if data.draw_mesh:
            # triangulated surface (reference delaunay_2d mesh,
            # ART/ModuleAnalysisAndPlots.py:544-561), built in the optic's
            # local support plane so holes are respected
            mpts, tris = _element_mesh_lab(element, data.OEpoints)
            if len(tris):
                faces = np.column_stack([np.full(len(tris), 3), tris]).ravel()
                plotter.add_mesh(pv.PolyData(mpts, faces=faces), opacity=0.7)
                continue
        plotter.add_mesh(pv.PolyData(pts), point_size=data.scale_spheres,
                         render_points_as_spheres=True)
    if not background:
        plotter.show(auto_close=False)  # BackgroundPlotter shows itself
    return plotter


def _has_display():
    import os

    return bool(os.environ.get("DISPLAY"))


def _ray_segments(history, end_distance, max_rays):
    """Per-hop line segments between successive bundles, each (k, 2, 3);
    ray identity is the array index (the reference matches Ray.number
    across shrinking lists, ART/ModuleAnalysisAndPlots.py:563-602). The
    alive rays are found on each bundle's device; at most ``max_rays`` of
    them per hop are drawn by the JAX package's NumPy generator (seed 0, one
    ``choice`` per hop in hop order: ``choice(n, k)`` picks the positions
    ``choice(alive_indices, k)`` picks), and only those come to the host."""
    rng = np.random.default_rng(0)
    sets = []
    for k in range(len(history)):
        last = k == len(history) - 1
        nxt = history[k] if last else history[k + 1]
        idx = torch.nonzero(nxt.alive).reshape(-1)
        if len(idx) > max_rays:
            pick = rng.choice(len(idx), max_rays, replace=False)
            idx = idx[torch.as_tensor(pick, device=idx.device)]
        here = history[k]
        a = _host(here.p[idx.to(here.p.device)])
        if last:
            b = a + _host(here.d[idx.to(here.d.device)]) * end_distance
        else:
            b = _host(nxt.p[idx])
        sets.append(np.stack([a, b], axis=1))
    return sets


def _element_points_lab(element, n_points):
    """Sample an element's surface and transform to the lab frame (reference
    _RenderOpticalElement, ART/ModuleAnalysisAndPlots.py:529-561)."""
    pts_local = np.asarray(element.type.get_grid3D(n_points))
    R = element.frame_rotation()
    centre = element.type.get_centre()
    return (pts_local - centre) @ R + element.position


def _element_mesh_lab(element, n_points):
    """(lab points, triangle indices) for a surface mesh of the element
    (drawing side: matplotlib's Delaunay triangulation).

    The reference triangulates with pyvista's ``delaunay_2d`` seeded by
    support-contour edges (ART/ModuleAnalysisAndPlots.py:544-561). Here the
    Delaunay triangulation runs in the optic's local x-y support plane (the
    surface is a height map over the support, so this is well-defined for
    every mirror type), and triangles whose centroid falls off the support
    are dropped — which handles holed supports without an edge source."""
    pyplot()
    import matplotlib.tri as mtri

    pts_local = np.asarray(element.type.get_grid3D(n_points))
    x, y = pts_local[:, 0], pts_local[:, 1]
    try:
        tri = mtri.Triangulation(x, y)
    except (ValueError, RuntimeError):  # degenerate grids (<3 pts, collinear)
        return _element_points_lab(element, n_points), np.zeros((0, 3), int)
    tris = tri.triangles
    # support coordinates are relative to the support centre (grid3D points
    # are in the optic frame, offset by get_centre() for off-axis optics)
    centre = element.type.get_centre()
    cx = x[tris].mean(axis=1) - centre[0]
    cy = y[tris].mean(axis=1) - centre[1]
    keep = np.asarray(sup.include(element.type.support, cx, cy))
    tris = tris[keep]
    R = element.frame_rotation()
    pts_lab = (pts_local - centre) @ R + element.position
    return pts_lab, tris


def _maybe_show():
    import matplotlib

    if matplotlib.get_backend().lower() != "agg":
        pyplot().show(block=False)


def show():
    pyplot().show(block=False)
