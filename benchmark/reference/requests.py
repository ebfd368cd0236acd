"""What each kind of request should answer, worked out by the plain optics
of :mod:`.optics` (float64 for the reference; the control passes a lower
dtype). Each function takes the configuration file's dict and the request
as the traffic generator drew it, and returns the answer in the form the
kind's program side reports it (``benchmark/kinds/*.py``). The source's
rays and weights come from its kind's module (``benchmark/sources``)."""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import sources
from . import optics as op


def _setup(cfg, second_distance, *, dtype, host_dtype, device):
    """The optics and their poses, placed in ``host_dtype`` and handed to
    the trace in ``dtype``."""
    optics = op.optics_from_config(cfg)
    distances = list(cfg["distances_mm"][:-1]) + [float(second_distance)]
    poses = op.place(optics, distances, cfg["incidence_deg"], cfg["incidence_plane_deg"],
                     dtype=host_dtype, device=device)
    return optics, [op.Pose(*(t.to(dtype) for t in p)) for p in poses]


def _pose_rows(poses):
    return np.stack([np.concatenate([t.double().cpu().numpy() for t in p]) for p in poses])


def _n_rays(cfg):
    return int(cfg["source"]["NumberRays"])


def _detector(cfg, optics, poses, distance, *, dtype, host_dtype, device, chunk):
    """The detector autoplaced ``distance`` from the chain's traced source
    (ART's Detector.autoplace on the whole bundle, alive-weighted means)."""
    n, source = _n_rays(cfg), sources.of(cfg)
    sums = torch.zeros(7, dtype=host_dtype, device=device)
    for k0 in range(0, n, chunk):
        m = min(chunk, n - k0)
        rays, _ = op.trace_survivors(source.rays(k0, m, n, dtype=dtype, device=device), optics,
                                     poses)
        sums += torch.stack([torch.tensor(float(rays.opl.shape[0]), device=device)]
                            + [c.sum() for c in rays.d + rays.p]).to(host_dtype)
    cv = sums[1:4] / sums[0]
    cv = cv / torch.linalg.vector_norm(cv)
    cp = sums[4:7] / sums[0]
    return _cast_plane(op.plane(cp + cv * distance, -cv, cp), dtype)


def _cast_plane(pl, dtype):
    return op.Plane(*(t.to(dtype) for t in pl))


# ---------------------------------------------------------------------------
# design: placement, source, trace, optimal distance, statistics
# ---------------------------------------------------------------------------


def _quadratics(rays, w, pl: op.Plane, host_dtype):
    """Weighted variances of the in-plane x, y and of the delays as exact
    quadratics a s^2 + b s + c in the plane's shift s (each ray's impact
    point and path are affine in s): rows x, y, delay [fs]."""
    x0, y0, t0 = op.on_plane(rays, pl)
    x1, y1, t1 = op.on_plane(rays, pl.shifted(1.0))
    delay0 = (rays.opl + t0) * op.FS_PER_MM
    delay1 = (rays.opl + t1) * op.FS_PER_MM
    w = w.to(host_dtype)
    ws = w.sum()
    rows = []
    for a0, a1 in ((x0, x1), (y0, y1), (delay0, delay1)):
        a0, a1 = a0.to(host_dtype), a1.to(host_dtype)
        b = a1 - a0
        a0 = a0 - (w * a0).sum() / ws
        b = b - (w * b).sum() / ws
        rows.append([float((w * b * b).sum() / ws), float(2.0 * (w * a0 * b).sum() / ws),
                     float((w * a0 * a0).sum() / ws)])
    return np.asarray(rows, np.float64)


def _spot_duration(q, s):
    v = q[:, 0] * s * s + q[:, 1] * s + q[:, 2]
    return math.sqrt(max(v[0] + v[1], 0.0)), math.sqrt(max(v[2], 0.0))


def _optimal_shift(q, half_width):
    """The shift minimizing spot^2 x duration: a grid over +-half_width,
    then a golden-section search about its best point."""
    def f(s):
        spot, dur = _spot_duration(q, s)
        return spot * spot * dur

    grid = np.linspace(-half_width, half_width, 40001)
    v = q[None, :, 0] * grid[:, None] ** 2 + q[None, :, 1] * grid[:, None] + q[None, :, 2]
    fit = (v[:, 0] + v[:, 1]) * np.sqrt(np.maximum(v[:, 2], 0.0))
    i = int(np.argmin(fit))
    lo, hi = grid[max(i - 1, 0)], grid[min(i + 1, len(grid) - 1)]
    g = (math.sqrt(5.0) - 1.0) / 2.0
    for _ in range(80):
        a, b = hi - g * (hi - lo), lo + g * (hi - lo)
        if f(a) < f(b):
            hi = b
        else:
            lo = a
    return 0.5 * (lo + hi)


def design(cfg, request, sample, *, dtype=torch.float64, host_dtype=torch.float64,
           device="cuda", weights="bundle"):
    """One design: the chain placed with the request's second distance, the
    whole source traced, the transmission of ART's Gaussian profile, the
    detector autoplaced at the configured distance and moved to the
    distance minimizing spot^2 x duration (intensity-weighted), and the
    spot and duration SDs there, at the distance the program reports.
    ``sample``: ray indices whose source and traced state are returned.
    ``request["reported_distance_mm"]`` (the program's answer), where
    given, is where the spot and duration are read, to judge the program's;
    else they are read at the optimum found here. ``plane``: the detector
    plane at that optimum, on which the sampled rays are compared.
    ``weights``: the rays' intensity law, ``"bundle"`` the one ART applies
    to the source bundle (what a design reads), ``"index"`` the one the
    fused kernels give ray k (what the scan engine sums)."""
    optics, placed = _setup(cfg, request["second_distance_mm"], dtype=host_dtype,
                            host_dtype=host_dtype, device=device)
    poses = [op.Pose(*(t.to(dtype) for t in p)) for p in placed]
    n, source = _n_rays(cfg), sources.of(cfg)
    src = source.rays(0, n, n, dtype=dtype, device=device)
    if weights == "index":
        w = source.index_weights(0, n, n, dtype=dtype, device=device)
    else:
        w = source.bundle_weights(src)
    idx = torch.as_tensor(sample, device=device)
    sampled = source.sampled(src, w, idx)
    out = op.trace(src, optics, poses)
    bundle = {"p": torch.stack([c[idx] for c in out.p], -1).double().cpu().numpy(),
              "d": torch.stack([c[idx] for c in out.d], -1).double().cpu().numpy(),
              "opl": out.opl[idx].double().cpu().numpy(),
              "alive": out.alive[idx].cpu().numpy()}
    alive_w = torch.where(out.alive, w, torch.zeros_like(w))
    transmission = 100.0 * float(alive_w.to(host_dtype).sum() / w.to(host_dtype).sum())
    base = float(cfg["detector"]["DistanceDetector"])
    out = op.Rays(tuple(c.to(host_dtype) for c in out.p), tuple(c.to(host_dtype) for c in out.d),
                  out.opl.to(host_dtype), out.alive)
    pl = op.autoplace(out, base)
    keep = torch.nonzero(out.alive).reshape(-1)
    alive = op.Rays(tuple(c[keep] for c in out.p), tuple(c[keep] for c in out.d), out.opl[keep],
                    out.alive[keep])
    q = _quadratics(alive, w[keep], pl, host_dtype)
    s_opt = _optimal_shift(q, float(cfg["detector"]["search_half_width_mm"]))
    reported = request.get("reported_distance_mm", base + s_opt)
    spot, duration = _spot_duration(q, float(reported) - base)
    at = pl.shifted(s_opt)
    plane = {k: getattr(at, k).double().cpu().numpy() for k in ("centre", "normal", "e1", "e2")}
    return {"poses": _pose_rows(placed), "source": sampled, "bundle": bundle,
            "transmission": transmission, "distance": base + s_opt, "spot": spot,
            "duration": duration, "plane": plane}


# ---------------------------------------------------------------------------
# align: Adam on the pose parameters, gradients by autograd
# ---------------------------------------------------------------------------


def _focus_sums(params, optics, poses, pl, k0, m, n, source, *, dtype, host_dtype, device):
    """(w, wx, wy, wxx, wyy) over rays k0 .. k0 + m - 1 of the source for the
    chain perturbed by ``params`` ((K, 6): pitch, roll, yaw, then shifts
    along normal, major, normal x major), summed in ``host_dtype``."""
    moved = [op.perturb(p, params[i, :3], params[i, 3:]) for i, p in enumerate(poses)]
    rays, index = op.trace_survivors(source.rays(k0, m, n, dtype=dtype, device=device), optics,
                                     moved)
    w = source.index_weights(k0, m, n, dtype=dtype, device=device)[index]
    x, y, _ = op.on_plane(rays, pl)
    w, x, y = w.to(host_dtype), x.to(host_dtype), y.to(host_dtype)
    return torch.stack([w.sum(), (w * x).sum(), (w * y).sum(), (w * x * x).sum(),
                        (w * y * y).sum()])


def _focus_loss(s, total_weight, survival_weight):
    w = torch.clamp(s[0], min=1e-30)
    return (s[3] / w - (s[1] / w) ** 2 + s[4] / w - (s[2] / w) ** 2
            + survival_weight * (1.0 - s[0] / total_weight))


def align(cfg, request, *, iters, lr, survival_weight, dtype=torch.float64,
          host_dtype=torch.float64, device="cuda", chunk=1 << 22):
    """One alignment: the chain placed at the request's second distance,
    its detector autoplaced there on the unperturbed chain, the request's
    optic rolled, then ``iters`` Adam steps (b1 0.9, b2 0.999, eps 1e-8,
    bias-corrected) from zero pose parameters on the loss spot variance +
    survival_weight (1 - transmission) over the source weighted by its
    kernels' law (the cone's edge^(k/n)) on that fixed plane. Each gradient
    is exact autograd over every ray, the chunks' tapes held together for
    one backward pass. Returns the parameters (K, 6), the loss of every step
    and the first step's gradient."""
    optics, poses = _setup(cfg, request["second_distance_mm"], dtype=dtype, host_dtype=host_dtype,
                           device=device)
    n, source = _n_rays(cfg), sources.of(cfg)
    pl = _detector(cfg, optics, poses, float(cfg["detector"]["DistanceDetector"]),
                   dtype=dtype, host_dtype=host_dtype, device=device, chunk=chunk)
    poses = op.misaligned(poses, request)
    total = source.index_weight_total(n)
    K = len(poses)
    params = torch.zeros((K, 6), dtype=host_dtype, device=device)
    mu = torch.zeros_like(params)
    nu = torch.zeros_like(params)
    history, first_grad = [], None
    for i in range(iters):
        q = params.to(dtype).detach().requires_grad_(True)
        sums = sum(_focus_sums(q, optics, poses, pl, k0, min(chunk, n - k0), n, source,
                               dtype=dtype, host_dtype=host_dtype, device=device)
                   for k0 in range(0, n, chunk))
        loss = _focus_loss(sums, total, survival_weight)
        (g,) = torch.autograd.grad(loss, q)
        grad = g.to(host_dtype)
        if first_grad is None:
            first_grad = grad.clone()
        mu = 0.1 * grad + 0.9 * mu
        nu = 0.001 * grad * grad + 0.999 * nu
        params = params - lr * ((mu / (1.0 - 0.9 ** (i + 1)))
                                / (torch.sqrt(nu / (1.0 - 0.999 ** (i + 1))) + 1e-8))
        history.append(float(loss.detach()))
    return {"params": params.cpu().numpy(), "history": np.asarray(history),
            "first_grad": first_grad.cpu().numpy()}


# ---------------------------------------------------------------------------
# image: the intensity image and delay map of a giga-ray source
# ---------------------------------------------------------------------------


def image(cfg, request, *, n_total, bins, probe_rays, dtype=torch.float64,
          host_dtype=torch.float64, device="cuda", chunk=1 << 24):
    """One image: the chain placed at the request's second distance, its
    detector autoplaced on the unperturbed chain, the request's optic
    rolled; the window the bounding box of a ``probe_rays``-ray source's
    impact points padded 5 % about its middle; then every ray of the
    ``n_total``-ray source binned by truncation (counted where 0 <= f <=
    bins, the last pixel taking its upper edge) with its kernels' weight
    (the cone's edge^(k/n)) and its delay [fs] against the first surviving
    ray of an 8-ray probe. ``request["window"]`` ((lo, hi), the program's answer),
    where given, is the window binned into, so that the images are held
    pixel for pixel; the window found here is returned all the same.
    Returns the weight image, the mean-delay map (re-centred to the global
    weighted mean, NaN where empty), the window and the surviving
    weight."""
    optics, poses = _setup(cfg, request["second_distance_mm"], dtype=dtype, host_dtype=host_dtype,
                           device=device)
    source = sources.of(cfg)
    pl = _detector(cfg, optics, poses, float(cfg["detector"]["DistanceDetector"]),
                   dtype=dtype, host_dtype=host_dtype, device=device, chunk=chunk)
    poses = op.misaligned(poses, request)

    probe, _ = op.trace_survivors(source.rays(0, probe_rays, probe_rays, dtype=dtype,
                                              device=device), optics, poses)
    px, py, _ = op.on_plane(probe, pl)
    if px.numel():
        lo = torch.stack([px.min(), py.min()]).to(host_dtype)
        hi = torch.stack([px.max(), py.max()]).to(host_dtype)
    else:  # no probe ray survives (the control's lowest precision): an empty window
        lo = hi = torch.zeros(2, dtype=host_dtype, device=device)
    mid, half = 0.5 * (lo + hi), 0.5 * (hi - lo) * 1.05 + 1e-12
    lo, hi = (mid - half), (mid + half)
    extent = (lo.double().cpu().numpy(), hi.double().cpu().numpy())
    if "window" in request:
        lo, hi = (torch.as_tensor(np.asarray(v, np.float64), device=device).to(host_dtype)
                  for v in request["window"])
    chief, _ = op.trace_survivors(source.rays(0, 8, 8, dtype=dtype, device=device), optics,
                                  poses)
    _, _, t_chief = op.on_plane(chief, pl)
    opl_ref = float(chief.opl[0] + t_chief[0]) if chief.opl.numel() else 0.0

    nx, ny = int(bins[0]), int(bins[1])
    scale = torch.tensor([nx, ny], dtype=host_dtype, device=device) / (hi - lo)
    w_img = torch.zeros(nx * ny, dtype=host_dtype, device=device)
    wd_img = torch.zeros_like(w_img)
    lo_d, scale_d = lo.to(dtype), scale.to(dtype)
    for k0 in range(0, n_total, chunk):
        m = min(chunk, n_total - k0)
        rays, index = op.trace_survivors(source.rays(k0, m, n_total, dtype=dtype,
                                                     device=device), optics, poses)
        w = source.index_weights(k0, m, n_total, dtype=dtype, device=device)[index]
        x, y, t = op.on_plane(rays, pl)
        delay = ((rays.opl - opl_ref) + t) * op.FS_PER_MM
        fx = (x - lo_d[0]) * scale_d[0]
        fy = (y - lo_d[1]) * scale_d[1]
        counted = (fx >= 0) & (fx <= nx) & (fy >= 0) & (fy <= ny)
        ix = torch.clamp(torch.floor(fx[counted]).long(), 0, nx - 1)
        iy = torch.clamp(torch.floor(fy[counted]).long(), 0, ny - 1)
        flat = ix * ny + iy
        wc = w[counted].to(host_dtype)
        w_img.index_add_(0, flat, wc)
        wd_img.index_add_(0, flat, wc * delay[counted].to(host_dtype))
    w_img = w_img.reshape(nx, ny).double().cpu().numpy()
    wd_img = wd_img.reshape(nx, ny).double().cpu().numpy()
    sum_w = float(w_img.sum())
    has = w_img > 0
    global_mean = wd_img.sum() / max(sum_w, 1e-300)
    mean_delay = np.where(has, wd_img / np.where(has, w_img, 1.0) - global_mean, np.nan)
    return {"image": w_img, "mean_delay": mean_delay, "sum_w": sum_w, "extent": extent}
