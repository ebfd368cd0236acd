"""OpticalChain: the scene — a source bundle plus successive optical elements
(ART/ModuleOpticalChain.py), with hash-gated retracing, source/element
misalignment methods, and scan ("loop list") generators. Counterpart of the
JAX package's ``models/chain.py``.

Scene construction is host-side (CPU tensors, float64); :meth:`OpticalChain.to`
names the device the chain traces on. A factory source is carried as its
description (:class:`FusedSourceInfo`) and its bundle built on its first read
(:attr:`OpticalChain.source_rays`): the fused engine synthesizes the rays
from the ray index and the intensity on the device, so a design traced there
builds no bundle. :meth:`OpticalChain.trace_final` picks
the engine: at production size the fused-source kernel K1 for factory
sources and the streamed kernels K3/K4 for bundles the user built, the plain
streamed trace below it.
"""

from __future__ import annotations

import contextlib
import contextvars
import copy
import os
from typing import NamedTuple

import numpy as np
import torch

from ..ops import host_geometry as hg
from ..ops.bundle import RayBundle
from ..ops.precision import default_dtype, resolve_device
from ..ops.trace import trace
from . import sources as msource


class FusedSourceInfo(NamedTuple):
    """Host-side description of a factory source that the fused engine can
    synthesize in-kernel (BakedSource inputs + the Gaussian intensity edge).
    Attached by OEPlacement; kept in sync by shift_source/tilt_source;
    cleared when the user replaces the bundle. ``n_rays`` is the count the
    source emits (``models.sources.emitted_rays``)."""

    kind: str            # 'cone' | 'disk' | 'extended' | 'square'
    origin: tuple        # lab-frame source point / disk centre
    axis: tuple          # beam axis (unit)
    param: float         # half-divergence [rad] for 'cone'/'extended', radius [mm] for 'disk', side [mm] for 'square'
    gaussian_edge: float | None  # ApplyGaussianIntensityToRayList edge value
    n_rays: int
    wavelength: float
    diameter: float = 0.0  # source-disk diameter [mm] ('extended' only)

    def baked(self):
        from ..ops.fused_trace import make_source_spec

        return make_source_spec(self.kind, np.asarray(self.origin),
                                np.asarray(self.axis), self.param,
                                diameter=self.diameter, n_rays=self.n_rays)


#: bundles below this size stay on the streamed trace under engine="auto"
#: (same name, default and variable as the JAX package)
PALLAS_MIN_RAYS = int(os.environ.get("ART_TPU_PALLAS_MIN_RAYS", "200000"))

ENGINES = ("auto", "fused", "trace")
#: the JAX package's engine names, taken as their counterparts here: its
#: Pallas kernels and its in-jit fused source are the kernel engines, its
#: XLA trace is the plain streamed trace
ENGINE_ALIASES = {"pallas": "fused", "xla-source": "fused", "xla": "trace"}

NO_DEVICE = ("this OpticalChain has no device yet: pass device= when building it "
             "or call .to('cuda') / .to('cpu') before tracing")

#: device taken by chains built without one while a CONFIG file runs
#: (main.run_config_file); None everywhere else
_CONFIG_DEVICE = contextvars.ContextVar("config_device", default=None)


@contextlib.contextmanager
def config_device(device):
    """Within this scope every OpticalChain built without a device takes
    ``device`` (a CONFIG that traces while it loads runs on the CLI's
    device); the previous scope is restored on exit."""
    token = _CONFIG_DEVICE.set(resolve_device(device))
    try:
        yield
    finally:
        _CONFIG_DEVICE.reset(token)


def _bundle_hash(bundle: RayBundle) -> int:
    return hash(tuple(hash(leaf.detach().cpu().numpy().tobytes()) for leaf in bundle))


class OpticalChain:
    """Source rays + optical elements + description (+ scan metadata)."""

    def __init__(
        self,
        source_rays: RayBundle | None,
        optical_elements: list,
        description: str = "",
        loop_variable_name: str | None = None,
        loop_variable_value: float | None = None,
        source_spec: FusedSourceInfo | None = None,
        device=None,
    ):
        # ``source_rays`` None with a ``source_spec`` defers the factory
        # bundle to its first read (:attr:`source_rays`)
        if source_rays is None and source_spec is None:
            raise ValueError("an OpticalChain needs source rays or a factory source description "
                             "(source_spec)")
        self._set_source(source_rays, source_spec)
        # deepcopy so later mutation of the caller's objects does not change
        # this chain (the reference does the same)
        self.optical_elements = copy.deepcopy(list(optical_elements))
        self.description = description
        self.loop_variable_name = loop_variable_name
        self.loop_variable_value = loop_variable_value
        #: device the chain traces on: None until the caller names one
        #: (``device=`` here, :meth:`to`, or ``run_ART(..., device=)``) or a
        #: CONFIG file is run (:func:`config_device`)
        if device is None:
            device = _CONFIG_DEVICE.get()
        self.device = None if device is None else resolve_device(device)
        self._output_rays = None
        self._last_source_hash = None
        self._last_elements_hash = None
        #: engine used by the most recent trace_final call ("cuda-source",
        #: "torch-source", "cuda-streamed", "torch-streamed", "trace"), or of
        #: the scan engine ("cuda-scan", "torch-scan"); None before the first
        self.last_trace_engine = None

    def to(self, device) -> "OpticalChain":
        """Trace this chain on ``device`` from now on (returns self)."""
        device = resolve_device(device)
        if device != self.device:
            self.device = device
            self._output_rays = None
            self._last_source_hash = None  # retrace on the new device
        return self

    def _device(self) -> torch.device:
        if self.device is None:
            raise RuntimeError(NO_DEVICE)
        return self.device

    # ------------------------------------------------------------------
    @property
    def source_rays(self) -> RayBundle:
        """The source bundle, CPU tensors. A factory source's bundle is
        built on its first read, on the chain's device where that is a card
        (then copied to the host once), and kept."""
        if self._source_rays is None:
            self._source_rays = msource.factory_bundle(self._source_spec,
                                                      device=self._source_device())
        return self._source_rays

    @source_rays.setter
    def source_rays(self, bundle: RayBundle):
        # a user-supplied bundle invalidates the fused-source description —
        # internal mutations that preserve it go through _set_source instead
        self._set_source(bundle, None)

    def _set_source(self, bundle: RayBundle | None, spec: FusedSourceInfo | None):
        self._source_rays = bundle
        self._source_spec = spec
        #: float64 total of the intensity :meth:`_trace_final_fused` last
        #: synthesized for an unread factory bundle (a 0-d device tensor)
        self._source_total = None

    def _source_device(self) -> torch.device:
        """Where a factory source is built: the chain's card, else the CPU."""
        if self.device is not None and self.device.type == "cuda":
            return self.device
        return torch.device("cpu")

    def source_weight(self) -> float:
        """The source's total weight, the float64 sum of its intensity (the
        energy transmission's denominator). For a factory bundle nobody has
        read, the sum of the intensity synthesized on the chain's device."""
        if self._source_rays is not None:
            return float(self._source_rays.weights().double().sum())
        if self._source_total is None:
            self._source_total = msource.factory_intensity(
                self._source_spec, device=self._source_device()).double().sum()
        return float(self._source_total)

    def _n_rays(self) -> int:
        spec = self._source_spec
        return spec.n_rays if spec is not None else self._source_rays.n_rays

    @property
    def source_spec(self) -> FusedSourceInfo | None:
        """Fused-source description when the source bundle is a known
        factory Vogel source (None otherwise)."""
        return self._source_spec

    def resize_source(self, n_rays: int) -> None:
        """Describe the source at a different ray count (CLI ``--rays``); its
        bundle is built on its next read. Raises ValueError for
        user-supplied bundles."""
        spec = self._source_spec
        if spec is None:
            raise ValueError(
                "resize_source needs a synthesizable source (source_spec is "
                "None — the bundle was user-supplied or already consumed)"
            )
        # 'extended' and 'square' emit another count than the one asked for
        n_rays = msource.emitted_rays(spec.kind, int(n_rays), spec.diameter)
        self._set_source(None, spec._replace(n_rays=n_rays))
        self._output_rays = None

    # ------------------------------------------------------------------
    def copy_chain(self) -> "OpticalChain":
        return OpticalChain(self._source_rays, self.optical_elements, self.description,
                            source_spec=self._source_spec, device=self.device)

    def device_elements(self, dtype=None):
        """Element records on the chain's device (default: trace dtype)."""
        return [e.to_device(self._device(), dtype) for e in self.optical_elements]

    def get_output_rays(self, ignore_defects: bool = True, force: bool = False):
        """List of bundles after each element (streamed trace, trace dtype);
        recomputed only when source or elements changed."""
        src_hash = _bundle_hash(self.source_rays)
        el_hash = hash(tuple(hash(e) for e in self.optical_elements))
        if force or src_hash != self._last_source_hash or el_hash != self._last_elements_hash:
            source = self.source_rays.to(self._device(), default_dtype())
            self._output_rays = trace(source, self.device_elements(), ignore_defects,
                                      keep_history=True)
            self._last_source_hash = src_hash
            self._last_elements_hash = el_hash
        return self._output_rays

    def fused_eligible(self) -> bool:
        """True when the fused-source engine takes this chain under
        engine="auto" (the JAX package's rule): a factory source (every
        factory kind) of at least ``PALLAS_MIN_RAYS`` rays. The chain's
        length, element kinds and surface defects (Zernike tables and grid
        maps alike) do not enter: on a card, what the kernels lack (past
        the caps of ``ops/fused_trace.pack_chain``) raises
        NotImplementedError from their wrappers instead of falling back to
        another engine."""
        return self._source_spec is not None and self._n_rays() >= PALLAS_MIN_RAYS

    def takes_plain_trace(self, engine: str | None = None) -> bool:
        """True when :meth:`trace_final` with this ``engine`` runs the plain
        streamed trace, False when it launches a kernel engine."""
        engine = engine or os.environ.get("ART_TPU_ENGINE", "auto")
        engine = ENGINE_ALIASES.get(engine, engine)
        if engine not in ENGINES:
            raise ValueError(f"engine must be one of {ENGINES} or {tuple(ENGINE_ALIASES)}, "
                             f"got {engine!r}")
        return engine == "trace" or (engine == "auto" and self._n_rays() < PALLAS_MIN_RAYS)

    def trace_final(self, ignore_defects: bool = True, engine: str | None = None) -> RayBundle:
        """Only the bundle after the last element — the production path.

        ``engine`` (default: the ``ART_TPU_ENGINE`` variable, else "auto"):
        "auto" routes every bundle of at least ``PALLAS_MIN_RAYS`` rays
        through a kernel engine and smaller ones through the plain streamed
        trace (the JAX package's rule); "fused" forces the kernel engine
        that fits the source: the fused source engine (kernel K1) for a
        factory source, the streamed kernels (K4 for a bundle fresh from a
        factory, else K3) for a bundle the user built; "trace" forces the
        plain streamed trace. The JAX package's names are taken as their
        counterparts (:data:`ENGINE_ALIASES`). On the CPU the kernels' plain
        versions run. The engine used is recorded in
        ``self.last_trace_engine``: "cuda-source"/"torch-source",
        "cuda-streamed"/"torch-streamed" or "trace". ``ignore_defects`` as in
        :func:`~..ops.trace.trace`. A chain whose mirrors carry grid defect
        maps takes the same engines: the JAX package sends it to its XLA
        source engine, whose counterpart here is the fused engine."""
        if not self.takes_plain_trace(engine):
            if self._source_spec is None:
                return self._trace_final_streamed(ignore_defects)
            return self._trace_final_fused(ignore_defects)
        self.last_trace_engine = "trace"
        source = self.source_rays.to(self._device(), default_dtype())
        return trace(source, self.device_elements(), ignore_defects, keep_history=False)

    def _trace_final_streamed(self, ignore_defects: bool = True) -> RayBundle:
        from ..ops.fused_trace import chain_table, streamed_trace

        device = self._device()
        source = self.source_rays
        table = chain_table(None, [e.to_device("cpu", torch.float64) for e in self.optical_elements])
        out = streamed_trace(table, source, device=device, ignore_defects=ignore_defects)
        self.last_trace_engine = "cuda-streamed" if device.type == "cuda" else "torch-streamed"
        return RayBundle(
            p=out.p, d=out.d, opl=out.opl, opl_c=out.opl_c, alive=out.alive,
            intensity=source.intensity.to(device, torch.float32),
            incidence=out.incidence,
            wavelength=source.wavelength.to(device, torch.float32),
        )

    def _trace_final_fused(self, ignore_defects: bool = True) -> RayBundle:
        from ..ops.fused_trace import chain_table, fused_source_trace

        info = self._source_spec
        device = self._device()
        spec = info.baked()
        # the chain table is formed on the host from float64 poses (rounded
        # to float32 once)
        table = chain_table(spec, [e.to_device("cpu", torch.float64) for e in self.optical_elements])
        out = fused_source_trace(table, spec, info.n_rays, device=device,
                                 ignore_defects=ignore_defects)
        self.last_trace_engine = "cuda-source" if device.type == "cuda" else "torch-source"
        # ray i of the in-kernel spiral is ray i of the factory bundle, so the
        # source intensity profile rides along by index; a bundle nobody has
        # read is not built: its intensity is synthesized on the device, and
        # its total kept for the transmission (:meth:`source_weight`)
        if self._source_rays is None:
            intensity = msource.factory_intensity(info, device=device)
            self._source_total = intensity.double().sum()
        else:
            intensity = self._source_rays.intensity
        return RayBundle(
            p=out.p, d=out.d, opl=out.opl, opl_c=out.opl_c, alive=out.alive,
            intensity=intensity.to(device, torch.float32),
            incidence=out.incidence,
            wavelength=torch.tensor(info.wavelength, dtype=torch.float32, device=device),
        )

    # ------------------------------------------------------------------
    # visualization
    def render(self, **kwargs):
        """3D rendering of elements and rays (ART/ModuleOpticalChain.py:204-215)."""
        from ..analysis.plots import RayRenderGraph

        kwargs.setdefault("maxRays", 300)
        kwargs.setdefault("OEpoints", 3000)
        return RayRenderGraph(self, None, **kwargs)

    def quickshow(self, **kwargs):
        """Quick 3D look at the chain (documented but unimplemented in the
        reference, ART/ModuleOpticalChain.py:41)."""
        return self.render(maxRays=100, OEpoints=1000, **kwargs)

    # ------------------------------------------------------------------
    # source misalignment (ART/ModuleOpticalChain.py:219-369)

    def _first_incidence_plane_normal(self):
        central = self.source_rays.d.detach().cpu().double().numpy().mean(axis=0)
        central /= np.linalg.norm(central)
        from .masks import Mask

        for el in self.optical_elements:
            if isinstance(el.type, Mask):
                continue
            if np.linalg.norm(np.cross(central, el.normal)) > 1e-10:
                return central, el.normal
        raise Exception(
            "There doesn't seem to be a non-normal-incidence mirror in this optical chain, "
            "so you should rather give 'axis' as a numpy-array of length 3."
        )

    def shift_source(self, axis, distance: float):
        """Shift the source bundle by ``distance`` mm along ``axis``:
        a lab vector or one of "vert"/"horiz"/"random" relative to the first
        non-normal-incidence mirror's incidence plane
        (ART/ModuleOpticalChain.py:219-292)."""
        if isinstance(axis, np.ndarray) and len(axis) == 3:
            translation = axis
        else:
            central, oe_normal = self._first_incidence_plane_normal()
            perp = np.cross(central, oe_normal)
            horiz = np.cross(perp, central)
            if axis == "vert":
                translation = perp
            elif axis == "horiz":
                translation = horiz
            elif axis == "random":
                translation = np.random.uniform(-1, 1) * perp + np.random.uniform(-1, 1) * horiz
            else:
                raise ValueError('The shift direction must be one of ["vert", "horiz", "random"].')
        shift = distance * hg.normalize(translation)
        spec = self._source_spec
        if spec is not None:  # a rigid shift keeps the source fused-traceable
            spec = spec._replace(origin=tuple(np.asarray(spec.origin) + shift))
        p = self.source_rays.p
        self._set_source(
            self.source_rays._replace(p=p + torch.as_tensor(shift, dtype=p.dtype, device=p.device)),
            spec,
        )

    def tilt_source(self, axis, angle: float):
        """Rotate source directions by ``angle`` deg about an axis: a lab
        vector or "in_plane"/"out_plane"/"random"
        (ART/ModuleOpticalChain.py:294-369)."""
        if isinstance(axis, np.ndarray) and len(axis) == 3:
            rot_axis = axis
        else:
            central, oe_normal = self._first_incidence_plane_normal()
            ax_in = np.cross(central, oe_normal)
            ax_out = np.cross(ax_in, central)
            if axis == "in_plane":
                rot_axis = ax_in
            elif axis == "out_plane":
                rot_axis = ax_out
            elif axis == "random":
                rot_axis = np.random.uniform(-1, 1) * ax_in + np.random.uniform(-1, 1) * ax_out
            else:
                raise ValueError(
                    'The tilt axis must be one of ["in_plane", "out_plane", "random"] or a 3-vector.'
                )
        R = hg.rotation_around_axis(rot_axis, np.deg2rad(angle))
        spec = self._source_spec
        if spec is not None and spec.kind == "cone":
            # a point-source tilt is exactly a rotated cone axis (the spiral
            # rolls about the new axis, but every per-ray radius — and hence
            # the intensity profile and all statistics — is unchanged)
            spec = spec._replace(axis=tuple(R @ np.asarray(spec.axis)))
        else:
            # a tilted plane wave leaves its points on the old disk plane —
            # not a fused disk source any more
            spec = None
        d = self.source_rays.d
        self._set_source(
            self.source_rays._replace(d=d @ torch.as_tensor(R.T, dtype=d.dtype, device=d.device)),
            spec,
        )

    def get_source_loop_list(self, axis: str, loop_variable_values):
        """List of chains with the source tilted/shifted/refocused over the
        given values (ART/ModuleOpticalChain.py:371-446)."""
        names = {
            "tilt_in_plane": "source tilt in-plane (deg)",
            "tilt_out_plane": "source tilt out-of-plane (deg)",
            "tilt_random": "source tilt random axis (deg)",
            "shift_vert": "source shift vertical (mm)",
            "shift_horiz": "source shift horizontal (mm)",
            "shift_random": "source shift random-direction (mm)",
            "divergence": "point-source divergence half-angle (rad)",
        }
        if axis not in names:
            raise ValueError(f"axis must be one of {sorted(names)}")
        source = self.source_rays  # built once, then shared by the copies
        chains = []
        for x in loop_variable_values:
            mod = self.copy_chain()
            mod.loop_variable_name = names[axis]
            mod.loop_variable_value = float(x)
            if axis.startswith("tilt"):
                mod.tilt_source(axis[5:], float(x))
            elif axis.startswith("shift"):
                mod.shift_source(axis[6:], float(x))
            else:  # divergence: rebuild a point source with the same axis
                pts = source.p.detach().cpu().double().numpy()
                if not np.allclose(pts, pts[0], atol=1e-12):
                    raise ValueError(
                        "get_source_loop_list('divergence', ...) requires a point "
                        "source (all rays sharing one origin). This chain's source "
                        "has extended/plane-wave origins, so rebuilding it from ray 0 "
                        "would silently change the scene; build the scan from a fresh "
                        "PointSource instead."
                    )
                p0 = pts[0]
                d0 = source.d[0].detach().cpu().double().numpy()
                # spiral ray 0 IS the axis; the cone's bundle is built on
                # its first read
                mod._set_source(None, FusedSourceInfo(
                    kind="cone", origin=tuple(np.asarray(p0, float)),
                    axis=tuple(d0 / np.linalg.norm(d0)),
                    param=float(x), gaussian_edge=float(source.intensity[-1]),
                    n_rays=source.n_rays, wavelength=float(source.wavelength),
                ))
            chains.append(mod)
        return chains

    # ------------------------------------------------------------------
    # element misalignment (ART/ModuleOpticalChain.py:449-657)

    def rotate_OE(self, OEindx: int, axis: str, angle: float):
        el = self.optical_elements[OEindx]
        if axis == "pitch":
            el.rotate_pitch_by(angle)
        elif axis == "roll":
            el.rotate_roll_by(angle)
        elif axis == "yaw":
            el.rotate_yaw_by(angle)
        elif axis in ("random", "rotate_random"):
            el.rotate_random_by(angle)
        else:
            raise ValueError('axis must be one of ["pitch", "roll", "yaw", "random"].')

    def shift_OE(self, OEindx: int, axis: str, distance: float):
        el = self.optical_elements[OEindx]
        if axis == "normal":
            el.shift_along_normal(distance)
        elif axis == "major":
            el.shift_along_major(distance)
        elif axis == "cross":
            el.shift_along_cross(distance)
        elif axis == "random":
            el.shift_along_random(distance)
        else:
            raise ValueError('axis must be one of ["normal", "major", "cross", "random"].')

    def get_OE_loop_list(self, OEindx: int, axis: str, loop_variable_values):
        """List of chains stepping one degree of freedom of one element
        (ART/ModuleOpticalChain.py:533-614)."""
        oe_name = self.optical_elements[OEindx].type.type + "_idx_" + str(OEindx)
        names = {
            "pitch": oe_name + " pitch rotation (deg)",
            "roll": oe_name + " roll rotation (deg)",
            "yaw": oe_name + " yaw rotation (deg)",
            "rotate_random": oe_name + " random rotation (deg)",
            "shift_normal": oe_name + " shift along normal axis (mm)",
            "shift_major": oe_name + " shift along major axis (mm)",
            "shift_cross": oe_name + " shift along (normal x major)-direction (mm)",
            "shift_random": oe_name + " shift along random axis (mm)",
        }
        if axis not in names:
            raise ValueError(f"axis must be one of {sorted(names)}")
        chains = []
        for x in loop_variable_values:
            mod = self.copy_chain()
            mod.loop_variable_name = names[axis]
            mod.loop_variable_value = float(x)
            if axis in ("pitch", "roll", "yaw", "rotate_random"):
                mod.rotate_OE(OEindx, axis, float(x))
            else:
                mod.shift_OE(OEindx, axis[6:], float(x))
            chains.append(mod)
        return chains

    def get_OE_random_loop_list(self, rotate_std: float, shift_std: float, number_sims: int, rng=None):
        """Monte-Carlo tolerancing: every element randomly rotated and shifted
        with normal-distributed amplitudes (ART/ModuleOpticalChain.py:616-657)."""
        rng = np.random if rng is None else rng
        # loop label ends up in saved results/plots; wording is ours (the
        # reference's label at ART/ModuleOpticalChain.py:641 differs slightly)
        name = (
            "all optical elements randomly rotated with std=" + str(rotate_std)
            + " deg and shifted with std=" + str(shift_std) + " mm"
        )
        chains = []
        for i in range(number_sims):
            mod = self.copy_chain()
            mod.loop_variable_name = name
            mod.loop_variable_value = i
            for j in range(len(self.optical_elements)):
                mod.rotate_OE(j, "random", rng.normal(loc=0, scale=rotate_std))
                mod.shift_OE(j, "random", rng.normal(loc=0, scale=shift_std))
            chains.append(mod)
        return chains
