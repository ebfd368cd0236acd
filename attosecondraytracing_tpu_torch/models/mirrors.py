"""User-facing mirror classes (host side).

These mirror (pun intended) the public API of ART/ModuleMirror.py: the same
class names, constructor signatures, attributes, ``get_centre``/``get_normal``
/``get_grid3D`` methods and helper functions, so CONFIG scripts port directly.

Unlike the reference, these objects hold *no tracing logic for bundles*: they
compile to surface descriptions (:meth:`surface_params`) consumed by the
batched PyTorch trace (attosecondraytracing_tpu_torch.ops.surfaces / .trace)
and the CUDA kernels; ``DeformedMirror`` wraps any of them with surface
defects (``models/defects``). Each class
also provides a scalar float64 NumPy intersection (:meth:`_intersect_host`,
``np.roots``-based like the reference) that is used for the single
alignment ray during auto-placement and as an independent test oracle for the
device kernels.
"""

from __future__ import annotations

import math

import numpy as np

from ..ops import supports as sup
from ..ops import surfaces as srf
from ..ops.host_geometry import angle_between, normalize


def _real_positive_roots(coeffs, eps=1e-12):
    """Real, positive roots of a polynomial (reference: SolverQuadratic/
    SolverQuartic + KeepPositiveSolution, ART/ModuleGeometry.py:80-134)."""
    roots = np.roots(coeffs)
    return [r.real for r in roots if abs(r.imag) < 1e-12 and r.real > eps]


def _nearest_valid(p, d, ts, valid_fn):
    """Nearest hit among candidate ray parameters satisfying ``valid_fn``
    (reference picks the closest intersection point,
    ART/ModuleMirror.py:27-38)."""
    best = None
    for t in ts:
        q = p + t * d
        if valid_fn(q) and (best is None or t < best):
            best = t
    return None if best is None else p + best * d


def _support_ok(support, q, offset_x=0.0):
    return bool(np.asarray(sup.include(support, q[0] - offset_x, q[1])))


class _MirrorBase:
    """Shared host-side plumbing for all mirror types."""

    #: set by subclasses
    type = "Mirror"

    def get_grid3D(self, NbPoint: int, **kwargs):
        """Sample the mirror surface in 3D for rendering (reference
        get_grid3D methods). Returns a list of np arrays of shape (3,)."""
        contour_n = int(round(0.1 * NbPoint))
        contours = np.concatenate(sup.contour_points(self.support, max(contour_n, 4)), axis=0)
        grid = sup.grid_points(self.support, NbPoint - contour_n)
        xy = np.concatenate([contours, grid], axis=0)
        xy = xy + self._grid_offset()
        z = self._sag(xy[:, 0], xy[:, 1])
        keep = np.isfinite(z)
        pts = np.stack([xy[keep, 0], xy[keep, 1], z[keep]], axis=-1)
        return [row for row in pts]

    def _grid_offset(self):
        return np.zeros(2)

    def _params_tuple(self):
        """Hashable content identity (used for retrace caching, the analog of
        the reference's content ``__hash__``, ART/ModuleOpticalRay.py:151)."""
        raise NotImplementedError

    def __hash__(self):
        return hash((self.type, self._params_tuple(), self.support))


# %% ------------------------------------------------------------------------


class MirrorPlane(_MirrorBase):
    """Plane mirror (ART/ModuleMirror.py:42-113)."""

    def __init__(self, Support):
        self.support = Support
        self.type = "Plane Mirror"

    def surface_params(self):
        return srf.Plane()

    def get_normal(self, Point):
        return np.array([0.0, 0.0, 1.0])

    def get_centre(self):
        return np.zeros(3)

    def _sag(self, x, y):
        return np.zeros_like(x)

    def _intersect_host(self, p, d):
        if abs(d[2]) < 1e-30:
            return None
        t = -p[2] / d[2]
        q = p + t * d
        if t > 1e-12 and _support_ok(self.support, q):
            return q
        return None

    def _params_tuple(self):
        return ()


# %% ------------------------------------------------------------------------


class MirrorSpherical(_MirrorBase):
    """Spherical mirror x^2+y^2+z^2=R^2 (ART/ModuleMirror.py:117-208).

    Positive radius = concave, negative = convex (stored positive with a
    CC/CX type tag, like the reference).
    """

    def __init__(self, Radius, Support):
        if Radius < 0:
            self.type = "SphericalCX Mirror"
            self.radius = -Radius
        else:
            self.type = "SphericalCC Mirror"
            self.radius = Radius
        self.support = Support

    def surface_params(self):
        return srf.Sphere(radius=self.radius)

    def get_normal(self, Point):
        return normalize(-np.asarray(Point, dtype=float))

    def get_centre(self):
        return np.array([0.0, 0.0, -self.radius])

    def _sag(self, x, y):
        return -np.sqrt(np.maximum(self.radius**2 - x**2 - y**2, 0.0))

    def _intersect_host(self, p, d):
        ts = _real_positive_roots([np.dot(d, d), 2 * np.dot(d, p), np.dot(p, p) - self.radius**2])
        return _nearest_valid(p, d, ts, lambda q: q[2] < 0 and _support_ok(self.support, q))

    def _params_tuple(self):
        return (self.radius,)


# %% ------------------------------------------------------------------------


class MirrorParabolic(_MirrorBase):
    r"""Off-axis parabolic mirror z = (x^2+y^2)/(2p)
    (ART/ModuleMirror.py:212-387).

    ``feff`` is the effective focal length from the (off-axis shifted) support
    centre P to the focus; ``p = feff (1 + cos alpha)`` is the semi latus
    rectum, ``alpha`` the off-axis angle. The support centre sits at
    x_c = feff sin(alpha).
    """

    def __init__(self, FocalEffective: float, OffAxisAngle: float, Support):
        self._offaxisangle = np.deg2rad(OffAxisAngle)
        self.support = Support
        self.type = "Parabolic Mirror"
        self._feff = FocalEffective
        self._p = FocalEffective * (1 + np.cos(self._offaxisangle))

    @property
    def offaxisangle(self):
        """Off-axis angle: set in degrees, stored/returned in radian
        (reference quirk kept, ART/ModuleMirror.py:235)."""
        return self._offaxisangle

    @offaxisangle.setter
    def offaxisangle(self, OffAxisAngle):
        self._offaxisangle = np.deg2rad(OffAxisAngle)
        self._p = self._feff * (1 + np.cos(self._offaxisangle))

    @property
    def feff(self):
        return self._feff

    @feff.setter
    def feff(self, FocalEffective):
        self._feff = FocalEffective
        self._p = self._feff * (1 + np.cos(self._offaxisangle))

    @property
    def p(self):
        return self._p

    @p.setter
    def p(self, SemiLatusRectum):
        self._p = SemiLatusRectum
        self._feff = self._p / (1 + np.cos(self._offaxisangle))

    def surface_params(self):
        return srf.Parabola(p=self._p, center_x=self._feff * np.sin(self._offaxisangle))

    def get_normal(self, Point):
        return normalize(np.array([-Point[0], -Point[1], self._p]))

    def get_centre(self):
        return np.array(
            [
                self._feff * np.sin(self._offaxisangle),
                0.0,
                self._p * 0.5 - self._feff * np.cos(self._offaxisangle),
            ]
        )

    def _grid_offset(self):
        return np.array([self._feff * np.sin(self._offaxisangle), 0.0])

    def _sag(self, x, y):
        return (x**2 + y**2) / (2 * self._p)

    def _intersect_host(self, p, d):
        a = d[0] ** 2 + d[1] ** 2
        b = 2 * (d[0] * p[0] + d[1] * p[1]) - 2 * self._p * d[2]
        c = p[0] ** 2 + p[1] ** 2 - 2 * self._p * p[2]
        ts = _real_positive_roots([a, b, c]) if abs(a) > 1e-30 else ([-c / b] if abs(b) > 1e-30 else [])
        ts = [t for t in ts if t > 1e-12]
        xc = self._feff * np.sin(self._offaxisangle)
        return _nearest_valid(p, d, ts, lambda q: _support_ok(self.support, q, offset_x=xc))

    def _params_tuple(self):
        return (self._feff, self._offaxisangle)


# %% ------------------------------------------------------------------------


class MirrorToroidal(_MirrorBase):
    r"""Toroidal mirror (sqrt(x^2+z^2)-R)^2 + y^2 = r^2
    (ART/ModuleMirror.py:391-527)."""

    def __init__(self, MajorRadius, MinorRadius, Support):
        self.majorradius = MajorRadius
        self.minorradius = MinorRadius
        self.support = Support
        self.type = "Toroidal Mirror"

    def surface_params(self):
        return srf.Toroid(major_radius=self.majorradius, minor_radius=self.minorradius)

    def get_normal(self, Point):
        x, y, z = Point
        rho = math.hypot(x, z)
        w = (rho - self.majorradius) / max(rho, 1e-300)
        return normalize(np.array([-w * x, -y, -w * z]))

    def get_centre(self):
        return np.array([0.0, 0.0, -self.majorradius - self.minorradius])

    def _sag(self, x, y):
        inner = self.minorradius**2 - y**2
        inner = np.where(inner >= 0, inner, np.nan)
        outer = (np.sqrt(inner) + self.majorradius) ** 2 - x**2
        outer = np.where(outer >= 0, outer, np.nan)
        return -np.sqrt(outer)

    def _intersect_host(self, p, d):
        R, r = self.majorradius, self.minorradius
        G = 4.0 * R**2 * (d[0] ** 2 + d[2] ** 2)
        H = 8.0 * R**2 * (d[0] * p[0] + d[2] * p[2])
        I = 4.0 * R**2 * (p[0] ** 2 + p[2] ** 2)
        J = np.dot(d, d)
        K = 2.0 * np.dot(d, p)
        L = np.dot(p, p) + R**2 - r**2
        ts = _real_positive_roots([J**2, 2 * J * K, 2 * J * L + K**2 - G, 2 * K * L - H, L**2 - I])
        return _nearest_valid(p, d, ts, lambda q: q[2] < -R and _support_ok(self.support, q))

    def _params_tuple(self):
        return (self.majorradius, self.minorradius)


def ReturnOptimalToroidalRadii(Focal: float, AngleIncidence: float):
    """Astigmatism-free toroid radii for given focal length and incidence
    angle in degrees (ART/ModuleMirror.py:533-561): R = 2f(1/cos i - cos i),
    r = 2f cos i."""
    i = np.deg2rad(AngleIncidence)
    return 2 * Focal * (1 / np.cos(i) - np.cos(i)), 2 * Focal * np.cos(i)


# %% ------------------------------------------------------------------------


class MirrorEllipsoidal(_MirrorBase):
    """Ellipsoidal mirror (x/a)^2 + (y^2+z^2)/b^2 = 1
    (ART/ModuleMirror.py:565-751). Constructable from (a, b), from
    (f_object, f_image, OffAxisAngle), or mixtures, like the reference."""

    def __init__(
        self,
        Support,
        SemiMajorAxis=None,
        SemiMinorAxis=None,
        OffAxisAngle=None,
        f_object=None,
        f_image=None,
    ):
        self.type = "Ellipsoidal Mirror"
        self.support = Support
        self.a = None
        self.b = None
        self._offaxisangle = None
        if SemiMajorAxis is not None and SemiMinorAxis is not None:
            self.a = SemiMajorAxis
            self.b = SemiMinorAxis
        if OffAxisAngle is not None:
            self._offaxisangle = np.deg2rad(OffAxisAngle)
            if f_object is not None and f_image is not None:
                foci_sq = f_object**2 + f_image**2 - 2 * f_object * f_image * np.cos(self._offaxisangle)
                self.a = (f_object + f_image) / 2
                self.b = np.sqrt(self.a**2 - foci_sq / 4)
        else:
            if f_object is not None and f_image is not None and self.a is not None and self.b is not None:
                foci = 2 * np.sqrt(self.a**2 - self.b**2)
                self._offaxisangle = np.arccos(
                    (f_image**2 + f_object**2 - foci**2) / (2 * f_image * f_object)
                )
            elif self.a is not None and self.b is not None:
                foci = 2 * np.sqrt(self.a**2 - self.b**2)
                self._offaxisangle = np.arccos(1 - foci**2 / (2 * self.a**2))
        if self.a is None or self.b is None or self._offaxisangle is None:
            raise ValueError("Invalid mirror parameters")

    @property
    def offaxisangle(self):
        return self._offaxisangle

    def surface_params(self):
        centre = self.get_centre()
        return srf.Ellipsoid(a=self.a, b=self.b, center_x=centre[0], center_z=centre[2])

    def get_normal(self, Point):
        return normalize(np.array([-Point[0] / self.a**2, -Point[1] / self.b**2, -Point[2] / self.b**2]))

    def get_centre(self):
        """Support-centre point on the surface, from the off-axis angle
        (reference geometry, ART/ModuleMirror.py:695-714)."""
        foci = 2 * np.sqrt(self.a**2 - self.b**2)
        h = -foci / 2 / np.tan(self._offaxisangle)
        R = np.sqrt(foci**2 / 4 + h**2)
        sign = 1.0
        if math.isclose(self._offaxisangle, np.pi / 2):
            h = 0.0
        elif self._offaxisangle > np.pi / 2:
            h = -h
            sign = -1.0
        a_q = 1 - self.a**2 / self.b**2
        b_q = -2 * h
        c_q = self.a**2 + h**2 - R**2
        z = (-b_q + sign * np.sqrt(b_q**2 - 4 * a_q * c_q)) / (2 * a_q)
        if math.isclose(z**2, self.b**2):
            return np.array([0.0, 0.0, -self.b])
        x = self.a * np.sqrt(1 - z**2 / self.b**2)
        return np.array([x, 0.0, sign * z])

    def _grid_offset(self):
        return np.array([self.get_centre()[0], 0.0])

    def _sag(self, x, y):
        sideways = (x / self.a) ** 2 + (y / self.b) ** 2
        sideways = np.where(sideways <= 1, sideways, np.nan)
        return -self.b * np.sqrt(1 - sideways)

    def _intersect_host(self, p, d):
        a2, b2 = self.a**2, self.b**2
        da = (d[1] ** 2 + d[2] ** 2) / b2 + d[0] ** 2 / a2
        db = 2 * ((d[1] * p[1] + d[2] * p[2]) / b2 + d[0] * p[0] / a2)
        dc = (p[1] ** 2 + p[2] ** 2) / b2 + p[0] ** 2 / a2 - 1
        ts = _real_positive_roots([da, db, dc])
        xc = self.get_centre()[0]
        return _nearest_valid(p, d, ts, lambda q: q[2] < 0 and _support_ok(self.support, q, offset_x=xc))

    def _params_tuple(self):
        return (self.a, self.b, self._offaxisangle)


def ReturnOptimalEllipsoidalAxes(Focal: float, AngleIncidence: float):
    """Optimal ellipsoid semi-axes for focal length & incidence angle in
    degrees (ART/ModuleMirror.py:755-777): a = f, b = f cos i."""
    i = np.deg2rad(AngleIncidence)
    return Focal, Focal * np.cos(i)


# %% ------------------------------------------------------------------------


class MirrorCylindrical(_MirrorBase):
    """Cylindrical mirror y^2 + z^2 = R^2 (ART/ModuleMirror.py:781-874)."""

    def __init__(self, Radius, Support):
        if Radius < 0:
            self.type = "CylindricalCX Mirror"
            self.radius = -Radius
        else:
            self.type = "CylindricalCC Mirror"
            self.radius = Radius
        self.support = Support

    def surface_params(self):
        return srf.Cylinder(radius=self.radius)

    def get_normal(self, Point):
        return normalize(np.array([0.0, -Point[1], -Point[2]]))

    def get_centre(self):
        return np.array([0.0, 0.0, -self.radius])

    def _sag(self, x, y):
        return -np.sqrt(np.maximum(self.radius**2 - y**2, 0.0))

    def _intersect_host(self, p, d):
        a = d[1] ** 2 + d[2] ** 2
        b = 2 * (d[1] * p[1] + d[2] * p[2])
        c = p[1] ** 2 + p[2] ** 2 - self.radius**2
        ts = _real_positive_roots([a, b, c]) if abs(a) > 1e-30 else []
        return _nearest_valid(p, d, ts, lambda q: q[2] < 0 and _support_ok(self.support, q))

    def _params_tuple(self):
        return (self.radius,)


# %% ------------------------------------------------------------------------


class DeformedMirror(_MirrorBase):
    """A mirror with added surface-defect maps (ART/ModuleMirror.py:945-981).

    The intersection is shifted along the ray by the local height error
    h/cos(alpha); the normal composes the base normal with the defect slopes.
    ``IgnoreDefects=True`` during tracing (the reference's default,
    ART/ModuleProcessing.py:250) keeps the *offset* but reflects off the
    undeformed normal.
    """

    def __init__(self, Mirror, DeformationList):
        self.Mirror = Mirror
        self.DeformationList = DeformationList
        self.type = Mirror.type
        self.support = Mirror.support

    def surface_params(self):
        return self.Mirror.surface_params()

    def device_defects(self):
        return tuple(d.trace_defect() for d in self.DeformationList)

    def get_centre(self):
        return self.Mirror.get_centre()

    def get_normal(self, Point):
        n = self.Mirror.get_normal(Point)
        centre = self.get_centre()
        gx = -n[0] / n[2]
        gy = -n[1] / n[2]
        rel = np.asarray(Point, dtype=float) - centre
        for defect in self.DeformationList:
            dgx, dgy = defect.slopes_at(rel[0], rel[1])
            gx += dgx
            gy += dgy
        return normalize(np.array([-gx, -gy, 1.0]))

    def get_grid3D(self, NbPoint, **kwargs):
        return self.Mirror.get_grid3D(NbPoint, **kwargs)

    def _sag(self, x, y):
        return self.Mirror._sag(x, y)

    def _intersect_host(self, p, d):
        q = self.Mirror._intersect_host(p, d)
        if q is None:
            return None
        centre = self.get_centre()
        rel = q - centre
        h = sum(float(np.asarray(defect.offset_at(rel[0], rel[1]))) for defect in self.DeformationList)
        alpha = angle_between(-d, self.Mirror.get_normal(q))
        return q - d * h / np.cos(alpha)

    def _params_tuple(self):
        return (self.Mirror._params_tuple(), tuple(id(d) for d in self.DeformationList))
