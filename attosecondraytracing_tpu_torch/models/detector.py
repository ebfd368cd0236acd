"""Virtual detector: a plane in lab space with response methods
(ART/ModuleDetector.py).

The Detector object itself is host-side (centre/normal/refpoint as float64
NumPy); its responses evaluate on the bundle's device via
:mod:`attosecondraytracing_tpu_torch.analysis.stats` and, for images,
:mod:`attosecondraytracing_tpu_torch.analysis.histogram`.
"""

from __future__ import annotations

import numpy as np

from ..analysis import stats
from ..ops import host_geometry as hg
from ..ops.bundle import RayBundle


class Detector:
    """A plane defined by ``centre`` and ``normal`` (pointing towards the
    incoming rays), plus a ``refpoint`` distances are measured from."""

    def __init__(self, RefPoint, Centre=None, Normal=None):
        self.centre = None if Centre is None else np.asarray(Centre, dtype=float)
        self.normal = None if Normal is None else hg.normalize(Normal)
        self.refpoint = np.asarray(RefPoint, dtype=float)

    def copy_detector(self) -> "Detector":
        return Detector(self.refpoint, self.centre, self.normal)

    # ------------------------------------------------------------------
    # placement (ART/ModuleDetector.py:109-177)

    def autoplace(self, bundle: RayBundle, DistanceDetector: float):
        """Place perpendicular to the bundle's central ray at the given
        distance from its mean origin point (ART/ModuleDetector.py:109-137)."""
        central_vec = stats.central_direction(bundle).double().cpu().numpy()
        central_vec = central_vec / np.linalg.norm(central_vec)
        central_point = stats.central_point(bundle).double().cpu().numpy()
        self.normal = -central_vec
        self.centre = central_point + central_vec * DistanceDetector
        self.refpoint = central_point

    def get_distance(self) -> float:
        """Distance of the plane from the refpoint (ART/ModuleDetector.py:139-145)."""
        return float(abs(np.dot(self.refpoint - self.centre, self.normal)))

    def shiftToDistance(self, NewDistance: float):
        shift = NewDistance - self.get_distance()
        self.centre = self.centre - shift * self.normal

    def shiftByDistance(self, Shift: float):
        self.centre = self.centre - Shift * self.normal

    def _iscomplete(self):
        if self.centre is None or self.normal is None:
            raise TypeError("The detector has no centre and normal vectors defined yet.")
        return True

    # ------------------------------------------------------------------
    # response (evaluated on the bundle's device; ART/ModuleDetector.py:191-279)

    def _plane_rotation(self) -> np.ndarray:
        """Host rotation matrix taking the detector normal onto ez (the
        reference's RotationPointList convention)."""
        return hg.rotation_from_to(self.normal, np.array([0.0, 0.0, 1.0]))

    def get_PointList3D(self, bundle: RayBundle):
        self._iscomplete()
        pts, _ = stats.detector_points_3d(bundle, self.centre, self.normal)
        return pts

    def get_PointList2D(self, bundle: RayBundle):
        self._iscomplete()
        return stats.detector_points_2d(bundle, self.centre, self.normal, self._plane_rotation())

    def get_PointList2DCentre(self, bundle: RayBundle):
        self._iscomplete()
        xy = self.get_PointList2D(bundle)
        return stats.centre_point_cloud(xy, bundle.alive)

    def get_Delays(self, bundle: RayBundle):
        """Delays [fs] relative to the mean travel time (ART/ModuleDetector.py:254-279)."""
        self._iscomplete()
        return stats.detector_delays(bundle, self.centre, self.normal)

    def get_SpotAndDuration(self, bundle: RayBundle, intensity_weighted=False):
        """(spot SD [mm], duration SD [fs])."""
        self._iscomplete()
        return stats.spot_and_duration(
            bundle, self.centre, self.normal, self._plane_rotation(), intensity_weighted
        )

    def get_Image(self, bundle: RayBundle, bins=(256, 256), extent=None, intensity_weighted=True):
        """Intensity image ``(image, (lo, hi))`` binned where the bundle
        lives: the reference's SpotDiagram scatter
        (ART/ModuleAnalysisAndPlots.py:133-280) at any bundle size
        (:func:`~..analysis.histogram.detector_image`)."""
        self._iscomplete()
        from ..analysis.histogram import detector_image

        return detector_image(bundle, self.centre, self.normal, self._plane_rotation(),
                              bins=tuple(bins), extent=extent,
                              intensity_weighted=intensity_weighted)

    def get_DelayMap(self, bundle: RayBundle, bins=(256, 256), extent=None, intensity_weighted=True):
        """Per-pixel mean delay [fs] binned where the bundle lives: the
        binned DelayGraph (ART/ModuleAnalysisAndPlots.py:284-440). Returns
        ``(mean_delay, weight_image, (lo, hi))``
        (:func:`~..analysis.histogram.delay_map`)."""
        self._iscomplete()
        from ..analysis.histogram import delay_map

        return delay_map(bundle, self.centre, self.normal, self._plane_rotation(),
                         bins=tuple(bins), extent=extent, intensity_weighted=intensity_weighted)
