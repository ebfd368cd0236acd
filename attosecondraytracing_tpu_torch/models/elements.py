"""OpticalElement: pose of an optic in the lab frame, plus (mis)alignment
methods (ART/ModuleOpticalElement.py).

The pose is (position, normal, majoraxis) exactly as in the reference,
including the normal-setter behavior of co-rotating the majoraxis
(ART/ModuleOpticalElement.py:125-141). Angles are in degrees, distances in mm.

``to_device(device, dtype)`` compiles the pose + optic into the NamedTuple
consumed by the batched trace: the lab->optic rotation matrix replaces the
reference's per-ray quaternion rotations.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import host_geometry as hg
from ..ops.defects import GridDefect, grid_to
from ..ops.precision import default_dtype
from ..ops.trace import MaskElement, MirrorElement
from .masks import Mask
from .mirrors import DeformedMirror


class OpticalElement:
    """Pose of an optic (mirror or mask) in the lab frame."""

    def __init__(self, Type, Position, Normal, MajorAxis):
        self._type = Type
        self.position = np.asarray(Position, dtype=float)
        self._normal = hg.normalize(Normal)
        self._majoraxis = hg.normalize(MajorAxis)
        if abs(np.dot(self._normal, self._majoraxis)) > 1e-9:
            raise ValueError("The normal and major axis of optical elements need to be orthogonal!")

    @property
    def type(self):
        """The optic (Mirror/Mask object); name kept from the reference."""
        return self._type

    optic = type  # clearer alias

    @property
    def position(self):
        return self._position

    @position.setter
    def position(self, NewPosition):
        p = np.asarray(NewPosition, dtype=float)
        if p.shape != (3,):
            raise TypeError("Position must be a 3D vector.")
        self._position = p

    @property
    def normal(self):
        return self._normal

    @normal.setter
    def normal(self, NewNormal):
        """Setting a new normal co-rotates the majoraxis to keep it
        perpendicular (ART/ModuleOpticalElement.py:125-141)."""
        new = hg.normalize(NewNormal)
        if abs(np.dot(new, self._majoraxis)) > 1e-12:
            axis = np.cross(self._normal, new)
            angle = hg.angle_between(self._normal, new)
            self._majoraxis = hg.rotate_vector(axis, angle, self._majoraxis)
        self._normal = new

    @property
    def majoraxis(self):
        return self._majoraxis

    @majoraxis.setter
    def majoraxis(self, NewMajorAxis):
        new = hg.normalize(NewMajorAxis)
        if abs(np.dot(self._normal, new)) > 1e-12:
            raise ValueError("The normal and major axis of optical elements need to be orthogonal!")
        self._majoraxis = new

    # ------------------------------------------------------------------
    # content identity (retrace caching, ART/ModuleOpticalElement.py:161-165)
    def __hash__(self):
        return hash(
            (
                tuple(self._position),
                tuple(self._normal),
                tuple(self._majoraxis),
                hash(self._type),
            )
        )

    # ------------------------------------------------------------------
    # (mis-)alignment methods; angles in degrees, distances in mm
    def rotate_pitch_by(self, angle):
        """Rotate about (normal x majoraxis) — the incidence-angle knob
        (ART/ModuleOpticalElement.py:169-185)."""
        axis = np.cross(self._normal, self._majoraxis)
        self.normal = hg.rotate_vector(axis, np.deg2rad(angle), self._normal)

    def rotate_roll_by(self, angle):
        """Rotate about the majoraxis (ART/ModuleOpticalElement.py:187-197)."""
        self.normal = hg.rotate_vector(self._majoraxis, np.deg2rad(angle), self._normal)

    def rotate_yaw_by(self, angle):
        """Rotate about the normal (ART/ModuleOpticalElement.py:199-208)."""
        self.majoraxis = hg.rotate_vector(self._normal, np.deg2rad(angle), self._majoraxis)

    def rotate_random_by(self, angle, rng=None):
        rng = np.random if rng is None else rng
        self.normal = hg.rotate_vector(rng.random(3), np.deg2rad(angle), self._normal)

    def shift_along_normal(self, distance):
        self.position = self._position + distance * self._normal

    def shift_along_major(self, distance):
        self.position = self._position + distance * self._majoraxis

    def shift_along_cross(self, distance):
        self.position = self._position + distance * hg.normalize(np.cross(self._normal, self._majoraxis))

    def shift_along_random(self, distance, rng=None):
        rng = np.random if rng is None else rng
        self.position = self._position + distance * hg.normalize(rng.random(3))

    # ------------------------------------------------------------------
    def frame_rotation(self) -> np.ndarray:
        """Lab->optic rotation matrix (rows: majoraxis, n x m, normal)."""
        return hg.frame_rotation(self._normal, self._majoraxis)

    def to_device(self, device, dtype=None):
        """The element record consumed by the trace: pose tensors (rotation,
        position, support centre) on ``device`` in ``dtype`` (default: the
        trace dtype), surface and support parameters as python floats, so
        their derived constants round to the ray dtype once, at use; a
        ``DeformedMirror``'s defects (``device_defects``) ride along."""
        dtype = dtype or default_dtype()

        def tensor(x):
            return torch.as_tensor(np.asarray(x, dtype=np.float64), dtype=dtype, device=device)

        optic = self._type
        if isinstance(optic, Mask):
            return MaskElement(rot=tensor(self.frame_rotation()),
                               position=tensor(self._position), support=optic.support)
        surface = optic.surface_params()
        defects = ()
        if isinstance(optic, DeformedMirror):
            # Zernike coefficients stay host floats; grid maps become
            # tensors on the element's device, copied once per device
            defects = tuple(grid_to(d, device, dtype) if isinstance(d, GridDefect) else d
                            for d in optic.device_defects())
        return MirrorElement(
            rot=tensor(self.frame_rotation()),
            position=tensor(self._position),
            centre=tensor(optic.get_centre()),
            surface=type(surface)(*(float(v) for v in surface)),
            support=optic.support,
            defects=defects,
        )
