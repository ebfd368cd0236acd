"""The numbers that decide ``correct``: each kind's answer held against the
reference's, one number per property, larger meaning further apart. Each
kind's module (``benchmark/kinds/<kind>.py``) judges by its ``compare``,
which the checks and the control (``benchmark/control.py``) both call, so the
lower and the upper readings of every limit come from the same code."""

from __future__ import annotations

import numpy as np

from .optics import FS_PER_MM


def _max(a) -> float:
    a = np.asarray(a, np.float64)
    if a.size == 0:
        return 0.0
    return float(np.nanmax(a)) if np.isfinite(a).any() else float("inf")


def _finite(x) -> float:
    x = float(x)
    return x if np.isfinite(x) else float("inf")


def on_plane(bundle: dict, plane: dict):
    """In-plane coordinates [mm] (N, 2) of the rays where they meet the
    plane, and their optical paths [mm] there."""
    p, d = np.asarray(bundle["p"], np.float64), np.asarray(bundle["d"], np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        t = ((plane["centre"] - p) @ plane["normal"]) / (d @ plane["normal"])
    hit = p + t[:, None] * d - plane["centre"]
    return np.stack([hit @ plane["e1"], hit @ plane["e2"]], -1), np.asarray(bundle["opl"]) + t


def source_gap(got: dict, ref: dict) -> float:
    """Largest gap of a sampled source field the reference gives: of the
    intensity relative to the reference's, of the others (directions,
    points) absolute."""
    gaps = []
    for key, value in ref.items():
        if key == "intensity":
            gaps.append(_max(np.abs(got[key] / value - 1.0)))
        else:
            gaps.append(_max(np.abs(got[key] - value)))
    return max(gaps)


def design_results(got: dict, ref: dict) -> dict:
    """transmission: gap [percentage points]; distance: gap of the reported
    optimal detector distance to the reference's optimum [mm]; spot:
    relative gap of the spot SD at the reported distance; duration: gap of
    the duration SD there [fs]."""
    out = {
        "transmission": abs(_finite(got["transmission"]) - ref["transmission"]),
        "distance": abs(_finite(got["distance"]) - ref["distance"]),
        "spot": abs(_finite(got["spot"]) / ref["spot"] - 1.0),
        "duration": abs(_finite(got["duration"]) - ref["duration"]),
    }
    return {k: _finite(v) for k, v in out.items()}


def design(got: dict, ref: dict) -> dict:
    """placement: largest gap of a position [mm] or unit vector; source:
    :func:`source_gap`; rays_alive: share of sampled rays alive on one side
    only; over sampled rays alive on both sides, the largest gap of
    rays_position [mm] and rays_path [fs] on the reference's detector plane
    at its optimum (where the rays leave the last mirror, a ray's hit slides
    along the ray with its grazing angle, which says nothing of the ray),
    and of rays_direction; then :func:`design_results`."""
    gb, rb = got["bundle"], ref["bundle"]
    both = gb["alive"] & rb["alive"]
    xy_got, path_got = on_plane(gb, ref["plane"])
    xy_ref, path_ref = on_plane(rb, ref["plane"])
    # where the reference keeps sampled rays and the program none of them,
    # no ray's state can be held: that reads as an infinite gap
    lost = float("inf") if rb["alive"].any() and not both.any() else 0.0
    out = {
        "placement": _max(np.abs(got["poses"] - ref["poses"])),
        "source": source_gap(got["source"], ref["source"]),
        "rays_alive": float(np.mean(gb["alive"] != rb["alive"])),
        "rays_position": max(lost, _max(np.abs(xy_got[both] - xy_ref[both]))),
        "rays_direction": max(lost, _max(np.abs(gb["d"][both] - rb["d"][both]))),
        "rays_path": max(lost, _max(np.abs(path_got[both] - path_ref[both])) * FS_PER_MM),
    }
    out = {k: _finite(v) for k, v in out.items()}
    out.update(design_results(got, ref))
    return out


def kept_parameters(first_grad, floor=1e-3) -> np.ndarray:
    """The pose parameters the alignment check holds: those whose
    reference gradient at the first step is at least ``floor`` times the
    median of the nonzero ones. The others (a mask's pose moves no
    surviving ray) move under Adam by round-off alone."""
    g = np.abs(np.asarray(first_grad, np.float64)).ravel()
    nonzero = g[g > 0]
    if nonzero.size == 0:
        return np.zeros_like(g, dtype=bool)
    return g >= floor * np.median(nonzero)


def align(got: dict, ref: dict) -> dict:
    """loss: largest relative gap of a step's loss; poses: largest gap of a
    held parameter after the last step, over the larger of its own move
    and the median held move in the reference."""
    hist_got = np.asarray(got["history"], np.float64)
    hist_ref = np.asarray(ref["history"], np.float64)
    if hist_got.shape != hist_ref.shape:
        loss = float("inf")
    else:
        loss = _max(np.abs(hist_got / hist_ref - 1.0))
    keep = kept_parameters(ref["first_grad"])
    p_got = np.asarray(got["params"], np.float64).ravel()[keep]
    p_ref = np.asarray(ref["params"], np.float64).ravel()[keep]
    scale = np.maximum(np.abs(p_ref), np.median(np.abs(p_ref)) if p_ref.size else 0.0)
    poses = _max(np.abs(p_got - p_ref) / np.maximum(scale, 1e-300))
    return {"loss": _finite(loss), "poses": _finite(poses)}


BLOCK = 8


def _blocks(a, block=BLOCK):
    nx, ny = a.shape
    return a[: nx - nx % block, : ny - ny % block].reshape(
        nx // block, block, ny // block, block).sum(axis=(1, 3))


def _delay_moments(w, answer):
    """Weighted mean and standard deviation [fs] of a delay map over its
    lit pixels (infinite where none is lit)."""
    md = np.asarray(answer["mean_delay"], np.float64)
    lit = np.isfinite(md) & (w > 0)
    total = w[lit].sum()
    if not total > 0:
        return np.inf, np.inf
    mu = (w[lit] * md[lit]).sum() / total
    return mu, float(np.sqrt((w[lit] * (md[lit] - mu) ** 2).sum() / total))


def image(got: dict, ref: dict, min_block_share=1e-4) -> dict:
    """extent: largest gap of a window edge [reference pixels]; sum_w:
    relative gap of the surviving weight; image: L1 gap of the weight
    images summed on 8 x 8-pixel blocks, over the reference's total;
    delay: the largest delay gap [fs] both images can show: of the blocks'
    weighted mean delays over blocks that hold at least ``min_block_share``
    of the weight on both sides (a block lit on one side only is the
    image's to catch), and of the image-wide weighted mean and standard
    deviation of the delay map (what is left to compare where no block is
    lit on both sides, as in a window far off). The
    reference bins into the program's window (``benchmark/kinds/image.py``),
    so the images are held pixel for pixel and ``extent`` alone holds the
    window."""
    lo_r, hi_r = (np.asarray(v, np.float64) for v in ref["extent"])
    lo_g, hi_g = (np.asarray(v, np.float64) for v in got["extent"])
    pixel = (hi_r - lo_r) / np.asarray(ref["image"].shape, np.float64)
    extent = _max(np.concatenate([np.abs(lo_g - lo_r) / pixel, np.abs(hi_g - hi_r) / pixel]))
    w_got, w_ref = np.asarray(got["image"], np.float64), np.asarray(ref["image"], np.float64)
    if w_got.shape != w_ref.shape:
        return {"extent": extent, "sum_w": float("inf"), "image": float("inf"),
                "delay": float("inf")}
    b_got, b_ref = _blocks(w_got), _blocks(w_ref)
    wd_got = _blocks(np.nan_to_num(np.asarray(got["mean_delay"], np.float64)) * w_got)
    wd_ref = _blocks(np.nan_to_num(np.asarray(ref["mean_delay"], np.float64)) * w_ref)
    held = (b_ref >= min_block_share * b_ref.sum()) & (b_got >= min_block_share * b_got.sum())
    with np.errstate(invalid="ignore", divide="ignore"):
        d_got = wd_got / b_got
        d_ref = wd_ref / b_ref
    delay_gap = np.abs(d_got - d_ref)[held]
    (mu_got, sd_got), (mu_ref, sd_ref) = _delay_moments(w_got, got), _delay_moments(w_ref, ref)
    delay_gap = np.concatenate([delay_gap, [abs(mu_got - mu_ref), abs(sd_got - sd_ref)]])
    return {
        "extent": _finite(extent),
        "sum_w": _finite(abs(float(got["sum_w"]) / float(ref["sum_w"]) - 1.0)),
        "image": _finite(np.abs(b_got - b_ref).sum() / b_ref.sum()),
        "delay": _finite(_max(np.where(np.isfinite(delay_gap), delay_gap, np.inf))),
    }

