"""Detector-distance optimization (counterpart of the JAX package's
``analysis/optimizer.py``).

* :func:`FindOptimalDistance` — the reference's grid refinement on a traced
  bundle: scan 2*Amplitude in 20 steps, keep the argmin of the fitness,
  shrink the window 10x, Precision+1 times. Fitness per OptFor: "spotsize"
  = spot SD, "duration" = delay SD, "intensity" = spotsize^2 * duration.
* :func:`FindOptimalDistanceFused` — one pass of kernel K2 (of K5 in a
  parameter scan) yields every per-distance statistic as an exact quadratic
  in the scan distance, and the fitness is minimized on the host in float64.
* :func:`_x64_refine_distance` — when the optimum's duration falls below
  the float32 noise floor, a float64 trace of a reference-semantics source
  and the grid refinement settle it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.bundle import RayBundle
from . import stats

_OPTFOR_ALIASES = {"size": "spotsize", "spotsize": "spotsize", "duration": "duration", "intensity": "intensity"}

#: ~2x the ~0.6 fs float32 OPL noise of the fused moments
DURATION_F32_FLOOR_FS = 1.2


def _opt_for(OptFor):
    if OptFor not in _OPTFOR_ALIASES:
        raise NameError("OptFor must be one of 'intensity', 'spotsize'/'size', or 'duration'.")
    return _OPTFOR_ALIASES[OptFor]


def _fitness_at(bundle, centre, normal, rot, shift, opt_for, w):
    """(fitness, spot, duration) with the detector shifted by ``shift``
    along -normal."""
    c = centre - shift * normal
    spot = duration = 0.0
    if opt_for in ("intensity", "spotsize"):
        spot = float(stats.std_points(stats.detector_points_2d(bundle, c, normal, rot), w))
    if opt_for in ("intensity", "duration"):
        duration = float(stats.std_scalar(stats.detector_delays(bundle, c, normal), w))
    if opt_for == "intensity":
        return spot**2 * duration, spot, duration
    if opt_for == "duration":
        return duration, spot, duration
    return spot, spot, duration


def _scan_fitness(bundle, centre, normal, rot, shifts, opt_for, intensity_weighted):
    """(fitness, spot, duration) float64 arrays over the candidate
    ``shifts`` of the detector along -normal (``opt_for`` a canonical name:
    "spotsize", "duration" or "intensity")."""
    w = bundle.alive.to(bundle.p.dtype)
    if intensity_weighted:
        w = w * bundle.intensity.to(bundle.p.dtype)
    res = [_fitness_at(bundle, centre, normal, rot, float(s), opt_for, w) for s in shifts]
    return tuple(np.array(col, np.float64) for col in zip(*res))


def _auto_amplitude(det, bundle, first_distance):
    xy = det.get_PointList2D(bundle)
    size_spot = 2.0 * float(stats.std_points(xy, bundle.alive.to(xy.dtype)))
    na = float(stats.numerical_aperture(bundle))
    return min(4 * np.ceil(size_spot / np.tan(np.arcsin(min(na, 1.0)))), first_distance)


def FindOptimalDistance(
    Detector,
    bundle: RayBundle,
    OptFor: str = "intensity",
    Amplitude: float | None = None,
    Precision: int = 3,
    IntensityWeighted: bool = False,
    verbose: bool = False,
):
    """Detector distance minimizing the chosen fitness on ``bundle`` (the
    reference's iterative grid refinement; "size" is an alias of
    "spotsize"). Returns (optimal Detector copy, spot SD [mm], duration SD
    [fs])."""
    opt_for = _opt_for(OptFor)
    first_distance = Detector.get_distance()
    if Amplitude is None:
        Amplitude = _auto_amplitude(Detector, bundle, first_distance)
    amplitude = float(Amplitude)
    step = amplitude / 10.0

    det = Detector.copy_detector()
    rot = det._plane_rotation()
    base_shift = 0.0
    opt_spot = opt_duration = np.nan
    for k in range(Precision + 1):
        amp_k = amplitude * 0.1**k
        step_k = step * 0.1**k
        n = int(2 * amp_k / step_k)
        shifts = base_shift + (-amp_k + step_k * np.arange(n))
        fitness, spots, durations = _scan_fitness(bundle, det.centre, det.normal, rot, shifts,
                                                  opt_for, IntensityWeighted)
        ind = int(np.argmin(fitness))
        base_shift = float(shifts[ind])
        opt_spot = float(spots[ind]) if opt_for in ("intensity", "spotsize") else np.nan
        opt_duration = float(durations[ind]) if opt_for in ("intensity", "duration") else np.nan

    det.shiftByDistance(base_shift)
    if not (
        first_distance - amplitude + 10**-Precision
        < det.get_distance()
        < first_distance + amplitude - 10**-Precision
    ):
        print("There`s no minimum-size/duration focus in the searched range.")
    if verbose:
        print(
            f"Optimal detector distance {det.get_distance():.3f} mm "
            f"(spot {opt_spot * 1e3:.3g} um, duration {opt_duration:.3g} fs)"
        )
    return det, opt_spot, opt_duration


def _probe_focus_estimate(bundle, det, amplitude, weights=None):
    """Rough focal shift [mm, shiftByDistance convention] from a small
    traced probe: the closed-form minimum of the host-float64 spot variance
    of the per-ray linear impact model. Only centres the kernel's moment
    expansion point near the focus."""
    alive = bundle.alive.cpu().numpy()
    if not alive.any():
        return 0.0
    p = bundle.p.double().cpu().numpy()[alive]
    dvec = bundle.d.double().cpu().numpy()[alive]
    w = np.ones(len(p)) if weights is None else np.asarray(weights, np.float64)[alive]
    n = np.asarray(det.normal, np.float64)
    c = np.asarray(det.centre, np.float64)
    rot = np.asarray(det._plane_rotation(), np.float64)
    e1, e2 = rot[0], rot[1]
    dn = dvec @ n
    ok = np.abs(dn) > 1e-12
    if not ok.any():
        return 0.0
    p, dvec, dn, w = p[ok], dvec[ok], dn[ok], w[ok]
    wsum = max(w.sum(), 1e-300)
    inv_dn = 1.0 / dn
    t0 = ((c - p) @ n) * inv_dn
    x0 = (p - c) @ e1 + t0 * (dvec @ e1)
    y0 = (p - c) @ e2 + t0 * (dvec @ e2)
    cx = inv_dn * (dvec @ e1)
    cy = inv_dn * (dvec @ e2)

    def _terms(a, b):
        am, bm = (w * a).sum() / wsum, (w * b).sum() / wsum
        return ((w * (b - bm) ** 2).sum() / wsum,
                -2.0 * (w * (a - am) * (b - bm)).sum() / wsum)

    Ax, Bx = _terms(x0, cx)
    Ay, By = _terms(y0, cy)
    A, B = Ax + Ay, Bx + By
    if A <= 0.0:
        return 0.0
    return float(np.clip(-B / (2.0 * A), -amplitude, amplitude))


def FindOptimalDistanceFused(
    spec,
    elements,
    n_rays: int,
    Detector,
    OptFor: str = "intensity",
    Amplitude: float | None = None,
    Precision: int = 3,
    gaussian_edge: float | None = None,
    verbose: bool = False,
    *,
    device,
    moments_fn=None,
    last_moments: dict | None = None,
):
    """Detector-distance optimization from ONE pass of kernel K2 (its plain
    version on the CPU) over all ``n_rays`` rays of the fused source
    ``spec`` (a BakedSource): every per-distance statistic is an exact
    quadratic in the scan distance, so the fitness is minimized on the host
    in float64, zooming until the step reaches the reference's final
    resolution ``Amplitude * 10^-(Precision+1)``.

    A 4096-ray probe on the streamed trace sizes the window (auto
    ``Amplitude``, from spot and NA like the reference) and places the
    moment expansion point near the focus. When the optimal duration is
    below :data:`DURATION_F32_FLOOR_FS`, the float64 refinement
    (:func:`_x64_refine_distance`) settles the distance.
    ``moments_fn(det_centre, det_normal, det_rot, gaussian_edge,
    centre_distance)`` replaces the K2 pass as the moment provider (the scan
    engine passes a closure over kernel K5, ``ops/fused_scan.make_moments_fn``).
    ``last_moments`` (a dict, if given) receives the moment record used.

    Returns (optimal Detector copy, spot SD [mm], duration SD [fs])."""
    from ..ops.fused_trace import (
        moments_to_distance_sums,
        probe_trace,
        source_detector_moments,
        sums_to_stats,
        synth_spec,
    )
    from ..ops.precision import default_dtype

    opt_for = _opt_for(OptFor)
    det = Detector.copy_detector()
    first_distance = det.get_distance()
    probe_spec = spec
    probe_n = min(n_rays, 4096)
    if spec.kind == "extended" and spec.n_sources > 0:
        # the first 4096 rays would all be sub-source 0's central cone: spread
        # the probe over every sub-source with fewer rays per cone
        n_each = max(1, min(spec.n_each, probe_n // spec.n_sources))
        probe_spec = spec._replace(n_each=n_each)
        probe_n = n_each * spec.n_sources
    elif spec.kind == "square":
        # the first 4096 rays would be a strip of rows at one edge: probe a
        # coarse grid over the whole square instead (the JAX package probes
        # the strip)
        n_side = max(1, min(spec.n_each, int(np.sqrt(probe_n))))
        probe_spec = spec._replace(n_each=n_side)
        probe_n = n_side * n_side
    out = probe_trace(probe_spec, elements, probe_n, device=device, dtype=default_dtype())
    # probe weights: the kernel's Gaussian law on the probe's own source
    if gaussian_edge is None:
        probe_w = np.ones(probe_n)
    else:
        _, _, rr = synth_spec(probe_spec, torch.arange(probe_n), probe_n)
        probe_w = np.exp(np.log(gaussian_edge) * rr.double().numpy())
    if Amplitude is None:
        Amplitude = _auto_amplitude(det, out, first_distance)
    amplitude = float(Amplitude)
    d_centre = _probe_focus_estimate(out, det, amplitude, weights=probe_w)

    if moments_fn is None:
        mom = source_detector_moments(
            spec, elements, n_rays, det.centre, det.normal, det._plane_rotation(),
            device=device, gaussian_edge=gaussian_edge, centre_distance=d_centre)
    else:
        mom = moments_fn(det.centre, det.normal, det._plane_rotation(),
                         gaussian_edge=gaussian_edge, centre_distance=d_centre)
    if last_moments is not None:
        last_moments.update(mom)

    def _stats_at(shifts):
        sums = moments_to_distance_sums(mom["moments"], shifts, mom["centre_distance"])
        return sums_to_stats(sums, mom["opl_ref"], shifts)

    def _fitness_of(res):
        if opt_for == "intensity":
            return res["spot_sd"] ** 2 * res["duration_sd"]
        if opt_for == "duration":
            return res["duration_sd"]
        return res["spot_sd"]

    target_step = amplitude * 10.0 ** (-(int(Precision) + 1))
    lo, hi = -amplitude, amplitude
    while True:
        shifts = np.linspace(lo, hi, 2001)
        res = _stats_at(shifts)
        ind = int(np.argmin(_fitness_of(res)))
        base_shift = float(shifts[ind])
        opt_spot = float(res["spot_sd"][ind])
        opt_duration = float(res["duration_sd"][ind])
        step = float(shifts[1] - shifts[0])
        if step <= target_step or step < 1e-12:
            break
        lo, hi = base_shift - step, base_shift + step
    det.shiftByDistance(base_shift)

    if opt_for in ("duration", "intensity") and opt_duration < DURATION_F32_FLOOR_FS:
        det, opt_spot, opt_duration = _x64_refine_distance(
            spec, elements, n_rays, det, OptFor,
            amplitude=amplitude * 0.1 ** max(Precision - 1, 0),
            gaussian_edge=gaussian_edge, verbose=verbose, device=device)
    if verbose:
        print(
            f"Optimal detector distance {det.get_distance():.3f} mm "
            f"(spot {opt_spot * 1e3:.3g} um, duration {opt_duration:.3g} fs)"
        )
    return det, opt_spot, opt_duration


#: the JAX package's name for :func:`FindOptimalDistanceFused`
FindOptimalDistancePallas = FindOptimalDistanceFused


def _x64_refine_distance(spec, elements, n_rays, det, OptFor, amplitude,
                         gaussian_edge, verbose, *, device, max_rays: int = 20000):
    """Float64 refinement for sub-noise-floor duration optima: rebuild the
    reference-semantics source (float64, at most ``max_rays`` rays), trace it
    in float64 on ``device``, and run the grid refinement in the last window
    of the moment scan. Returns (det, spot, duration)."""
    from ..models import sources as msource
    from ..ops.fused_trace import elements_to
    from ..ops.trace import trace

    axis = np.asarray(spec.rot, np.float64) @ np.array([0.0, 0.0, 1.0])
    origin = np.asarray(spec.origin)
    n = min(n_rays, max_rays)
    f64 = torch.float64
    if spec.kind == "cone":
        bundle = msource.PointSource(origin, axis, float(np.arctan(spec.radius)), n, dtype=f64)
    elif spec.kind == "extended":
        bundle = msource.ExtendedSource(origin, axis, 2.0 * spec.pos_radius,
                                        float(np.arctan(spec.radius)), n, dtype=f64)
    elif spec.kind == "square":
        bundle = msource.PlaneWaveSquare(origin, axis, float(spec.radius), n, dtype=f64)
    else:
        bundle = msource.PlaneWaveDisk(origin, axis, float(spec.radius), n, dtype=f64)
    if gaussian_edge is not None:
        bundle = msource.ApplyGaussianIntensityToRayList(bundle, gaussian_edge)
    out = trace(bundle.to(device, f64), elements_to(elements, device, f64), keep_history=False)
    det2, spot, duration = FindOptimalDistance(
        det, out, OptFor, Amplitude=float(amplitude), Precision=2,
        IntensityWeighted=gaussian_edge is not None, verbose=False)
    if verbose:
        print("(duration near the float32 noise floor: refined with the "
              "two-pass float64 optimizer)")
    return det2, float(spot), float(duration)


# ---------------------------------------------------------------------------
# closed-form focus finder
# ---------------------------------------------------------------------------


def optimal_shift_closed_form(bundle: RayBundle, centre, normal, rot,
                              intensity_weighted: bool = False):
    """Detector shift minimizing the spot variance, and the spot SD there
    (0-d tensors in the bundle's dtype). On a fixed bundle each ray's
    in-plane impact point is affine in the shift s, so the (weighted) spot
    variance is an exact quadratic in s with one minimum: no search."""
    w = bundle.alive.to(bundle.p.dtype)
    if intensity_weighted:
        w = w * bundle.intensity.to(bundle.p.dtype)
    centre = torch.as_tensor(centre, dtype=bundle.p.dtype, device=bundle.p.device)
    normal = torch.as_tensor(normal, dtype=bundle.p.dtype, device=bundle.p.device)
    xy0 = stats.detector_points_2d(bundle, centre, normal, rot)
    g = stats.detector_points_2d(bundle, centre - normal, normal, rot) - xy0  # d(xy)/ds, exact
    a = xy0 - stats.masked_mean(xy0, w[:, None], dim=0)
    b = g - stats.masked_mean(g, w[:, None], dim=0)
    num = -torch.sum(stats.masked_mean(a * b, w[:, None], dim=0))
    den = torch.sum(stats.masked_mean(b * b, w[:, None], dim=0))
    s_opt = num / torch.clamp(den, min=1e-30)
    var = stats.masked_mean(torch.sum((a + s_opt * b) ** 2, dim=-1), w)
    return s_opt, torch.sqrt(var)


def delay_stats_for_shift(bundle: RayBundle, centre, normal, shift):
    """Duration SD [fs] with the detector shifted by ``shift`` along
    -normal (alive rays, unweighted)."""
    centre = torch.as_tensor(centre, dtype=bundle.p.dtype, device=bundle.p.device)
    normal = torch.as_tensor(normal, dtype=bundle.p.dtype, device=bundle.p.device)
    delays = stats.detector_delays(bundle, centre - shift * normal, normal)
    return stats.std_scalar(delays, bundle.alive.to(bundle.p.dtype))
