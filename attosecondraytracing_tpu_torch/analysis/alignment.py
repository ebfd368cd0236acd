"""Gradient-based alignment (counterpart of the JAX package's
``analysis/alignment.py``): gradient descent on the alignment of a chain,
this system's training step.

    params (pitch/roll/yaw + shifts per element)
      -> perturbed element poses
      -> trace -> detector spot/duration statistics -> loss
      -> gradient -> Adam update

Two engines give the gradient: ``"autograd"``, reverse mode through the
lab-frame trace (:func:`focus_loss`), and ``"fused"``, forward mode through
kernel K6 (``ops/fused_grad.py``: O(1) gradient memory at any ray count).
Support clipping enters only through the alive mask; gradients flow through
the smooth geometry of surviving rays.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..analysis import stats
from ..ops.bundle import RayBundle
from ..ops.geometry import rotation_around_axis
from ..ops.precision import default_dtype
from ..ops.trace import trace

#: engines of :func:`gradient_align` (the JAX package's "pallas" is
#: "fused", its "xla" is "autograd")
ENGINES = ("auto", "fused", "autograd")


class AlignmentParams(NamedTuple):
    """Per-element pose perturbations: ``angles[k] = (pitch, roll, yaw)``
    [rad] and ``shifts[k] = (normal, major, cross)`` [mm]."""

    angles: torch.Tensor  # (K, 3)
    shifts: torch.Tensor  # (K, 3)


def zero_params(n_elements: int, dtype=torch.float32, device="cpu") -> AlignmentParams:
    return AlignmentParams(angles=torch.zeros((n_elements, 3), dtype=dtype, device=device),
                           shifts=torch.zeros((n_elements, 3), dtype=dtype, device=device))


def _perturb_one(element, angles, shifts):
    """Rotate by (pitch, roll, yaw) about the element's (cross, major,
    normal) axes and shift along (normal, major, cross), differentiably in
    the parameters."""
    rot = element.rot  # rows: majoraxis, cross (= n x m), normal
    m, c, n = rot[0], rot[1], rot[2]
    kw = dict(dtype=rot.dtype, device=rot.device)
    R_delta = (rotation_around_axis(c.detach(), angles[0].to(rot.dtype), **kw)
               @ rotation_around_axis(m.detach(), angles[1].to(rot.dtype), **kw)
               @ rotation_around_axis(n.detach(), angles[2].to(rot.dtype), **kw))
    new_rot = rot @ R_delta.T
    new_pos = element.position + shifts[0] * n + shifts[1] * m + shifts[2] * c
    return element._replace(rot=new_rot, position=new_pos)


def apply_params(elements, params: AlignmentParams):
    """Perturb every element's pose by its parameter row."""
    return [_perturb_one(el, params.angles[k], params.shifts[k]) for k, el in enumerate(elements)]


def focus_loss(params: AlignmentParams, source: RayBundle, elements, det_centre, det_normal,
               det_rot, duration_weight: float = 0.0, survival_weight: float = 1.0,
               ignore_defects: bool = True):
    """Scalar figure of merit: spot variance (+ weighted duration variance)
    on a fixed detector plane, for the chain perturbed by ``params``.
    ``survival_weight`` penalizes lost energy [mm^2 per unit transmission
    loss]: a purely survivor-weighted variance would reward walking the beam
    off the optics. The bundle, the elements and the parameters share a
    device; the bundle's dtype is the trace dtype. ``ignore_defects`` as in
    :func:`~..ops.trace.trace`."""
    out = trace(source, apply_params(elements, params), ignore_defects=ignore_defects,
                keep_history=False)
    w = out.alive.to(out.p.dtype) * out.intensity.to(out.p.dtype)
    xy = stats.detector_points_2d(out, det_centre, det_normal, det_rot)
    loss = stats.std_points(xy, w) ** 2
    if duration_weight:
        delays = stats.detector_delays(out, det_centre, det_normal)
        loss = loss + duration_weight * stats.std_scalar(delays, w) ** 2
    if survival_weight:
        transmission = torch.sum(w) / torch.clamp(torch.sum(source.intensity.to(w.dtype)), min=1e-30)
        loss = loss + survival_weight * (1.0 - transmission)
    return loss


def alignment_step(params: AlignmentParams, lr: float, source: RayBundle, elements, det_centre,
                   det_normal, det_rot, duration_weight: float = 0.0,
                   survival_weight: float = 1.0, ignore_defects: bool = True):
    """One SGD step on the alignment parameters through ``torch.autograd``.
    Returns (new_params, loss)."""
    p = AlignmentParams(*(x.detach().requires_grad_(True) for x in params))
    loss = focus_loss(p, source, elements, det_centre, det_normal, det_rot,
                      duration_weight=duration_weight, survival_weight=survival_weight,
                      ignore_defects=ignore_defects)
    loss.backward()
    new = AlignmentParams(*(x.detach() - lr * x.grad for x in p))
    return new, loss.detach()


def _unflatten(flat, K):
    return AlignmentParams(angles=flat[:3 * K].reshape(K, 3), shifts=flat[3 * K:].reshape(K, 3))


def gradient_align(chain, detector, iters: int = 100, lr: float = 1e-5,
                   duration_weight: float = 0.0, survival_weight: float = 1.0,
                   params: AlignmentParams | None = None, verbose: bool = False,
                   engine: str = "auto"):
    """Adam-descend the alignment of a chain onto a fixed detector plane;
    returns (params, loss history).

    Adam's per-parameter normalization matters here: spot-variance
    gradients w.r.t. angles are ~f^2 larger than w.r.t. shifts, so ``lr``
    is an angle/shift step scale (radians/mm per iteration ceiling). Adam
    is optax's (b1 0.9, b2 0.999, eps 1e-8) on float32 parameters.

    ``engine``: "auto" takes the fused engine exactly when
    ``chain.fused_eligible()`` (a factory source of at least
    ``PALLAS_MIN_RAYS`` rays), on either device, else "autograd"; "fused"
    and "autograd" force either. The fused engine launches kernel K6 on a
    CUDA device and runs its plain version on the CPU; "autograd" is
    reverse mode through the trace. The engine used is recorded in
    ``gradient_align.last_engine``: "cuda-grad", "torch-grad" or
    "autograd"."""
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
    device = chain._device()
    elements = chain.device_elements()
    K = len(elements)
    det_rot = detector._plane_rotation()
    use_fused = engine == "fused" or (engine == "auto" and chain.fused_eligible())
    if params is None:
        params = zero_params(K)
    flat = torch.cat([params.angles.reshape(-1), params.shifts.reshape(-1)]).to(
        device=torch.device("cpu") if use_fused else device, dtype=torch.float32).detach()

    if use_fused:
        from ..ops import fused_grad as fg

        info = chain.source_spec
        if info is None:
            raise ValueError("the fused gradient engine needs a factory source (source_spec)")
        spec = fg.make_loss_spec(info, elements, detector.centre, detector.normal,
                                 duration_weight=duration_weight, survival_weight=survival_weight,
                                 device=device)
        src_rot = np.asarray(info.baked().rot, np.float64)
        src_origin = np.asarray(info.origin, np.float64)
        host = [e.to_device("cpu", torch.float64) for e in chain.optical_elements]
        gradient_align.last_engine = "cuda-grad" if device.type == "cuda" else "torch-grad"

        def value_and_grad(x):
            loss, grads = fg.fused_focus_value_and_grad(
                _unflatten(x, K), spec, host, src_rot, src_origin, detector.centre,
                detector.normal, det_rot, device=device)
            return loss, torch.cat([grads.angles.reshape(-1), grads.shifts.reshape(-1)])
    else:
        source = chain.source_rays.to(device, default_dtype())
        gradient_align.last_engine = "autograd"

        def value_and_grad(x):
            x = x.clone().requires_grad_(True)
            loss = focus_loss(_unflatten(x, K), source, elements, detector.centre,
                              detector.normal, det_rot, duration_weight=duration_weight,
                              survival_weight=survival_weight)
            loss.backward()
            return float(loss.detach()), x.grad

    # Adam as optax.adam computes it (b1 0.9, b2 0.999, eps 1e-8, bias-
    # corrected moments), on the flat float32 parameter vector
    b1, b2, eps = 0.9, 0.999, 1e-8
    mu = torch.zeros_like(flat)
    nu = torch.zeros_like(flat)
    history = []
    for i in range(iters):
        loss, grad = value_and_grad(flat)
        mu = (1.0 - b1) * grad + b1 * mu
        nu = (1.0 - b2) * grad * grad + b2 * nu
        mu_hat = mu / (1.0 - b1 ** (i + 1))
        nu_hat = nu / (1.0 - b2 ** (i + 1))
        flat = flat - lr * (mu_hat / (torch.sqrt(nu_hat) + eps))
        history.append(float(loss))
        if verbose and (i % max(1, iters // 10) == 0):
            print(f"align iter {i}: loss {history[-1]:.6g}")
    return _unflatten(flat, K), history


gradient_align.last_engine = None
