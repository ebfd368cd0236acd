"""A Fourier-PSD height error (upstream ART's ModuleDefects Fourrier): a
random rough surface whose spectrum falls as k^slope between the spatial
frequencies 2 / biggest and 2 / smallest [1/mm], synthesized by an inverse
real FFT over the rectangle circumscribing the mirror's support and scaled
to the given RMS [mm]. ``seed`` draws the phases (ART draws them from
NumPy's global generator).

The reference synthesizes the map itself from the seed, in the semantics
the port's ``models/defects.Fourrier`` records: the spatial-frequency grid
and its band mask in float32 (the inner cutoff falls on grid nodes, so the
precision of the comparison decides which modes are in), the phases
``numpy.random.default_rng(seed).uniform(0, 2 pi)`` over that grid, the
spectrum shifted along y, its inverse transform ``irfft2``, and the map
scaled to ``RMS`` by its standard deviation. Node (iy, ix) of the map lies
at (x0 + ix dx, y0 + iy dy), the grid spanning the rectangle; heights
between nodes are clamped bilinear interpolations."""

from __future__ import annotations

import numpy as np
import torch

from ..reference import optics as op

#: csrc/trace_common.cuh deformed_hit with one grid map (ignore_defects
#: True), besides the bare surface's two normals that the optic's module
#: counts: the support coordinates (2), grid_sums' height (fractional
#: indices by divide 4, weights 8, the four corners' sum 7), its sum into
#: the height (1), cos alpha (5), the shifted t (2) and point (6)
SHIFT_OPS = 35

#: synthesized maps: (parameters, dtype, device) -> (ny, nx) tensor
_MAPS: dict = {}


def _rect(support) -> tuple:
    """The circumscribed rectangle (X, Y) [mm] of a reference support."""
    if support[0] == "rectangle":
        return float(support[1]), float(support[2])
    return 2.0 * float(support[1]), 2.0 * float(support[1])


def port(spec, support):
    from attosecondraytracing_tpu_torch.models import defects

    return defects.Fourrier(support, RMS=spec["RMS"], slope=spec["slope"],
                            smallest=spec["smallest"], biggest=spec.get("biggest"),
                            seed=int(spec["seed"]))


def reference(spec, support) -> op.Defect:
    rect = _rect(support)
    biggest = spec.get("biggest")
    return op.Defect("fourier", {
        "RMS": float(spec["RMS"]), "slope": float(spec["slope"]),
        "smallest": float(spec["smallest"]),
        "biggest": float(max(rect) if biggest is None else biggest),
        "seed": int(spec["seed"]), "rect": rect})


def grid(defect) -> dict:
    """The map's shape and node coordinates: res_x spatial frequencies along
    x (irfft2 makes nx = 2 (res_x - 1) nodes of them), ny along y."""
    p = defect.params
    X, Y = p["rect"]
    k_max = 2.0 / p["smallest"]
    res_x = int(round(k_max * X / 2)) + 1
    ny = int(round(k_max * Y))
    nx = 2 * (res_x - 1)
    return {"res_x": res_x, "nx": nx, "ny": ny, "x0": -X / 2, "y0": -Y / 2,
            "dx": X / (nx - 1), "dy": Y / (ny - 1)}


def synthesize(defect, *, dtype, device):
    """The (ny, nx) height map [mm] in ``dtype`` on ``device``, made once
    per dtype and device. float64 and float32 are computed in themselves; a
    coarser dtype (the control's bfloat16) rounds the spectrum's moduli and
    phases to it, transforms in float32 (the FFTs take nothing coarser)
    and rounds the heights to it."""
    p = defect.params
    key = (tuple(sorted((k, v) for k, v in p.items())), dtype, str(device))
    if key in _MAPS:
        return _MAPS[key]
    work = dtype if dtype in (torch.float32, torch.float64) else torch.float32
    g = grid(defect)
    k_max = 2.0 / p["smallest"]
    kx = np.linspace(0.0, k_max, num=g["res_x"], endpoint=False, dtype=np.float32)[None, :]
    ky = np.linspace(-k_max, k_max, num=g["ny"], endpoint=False, dtype=np.float32)[:, None]
    k_abs = np.sqrt(kx**2 + ky**2)
    in_band = (k_abs >= np.float32(2.0 / p["biggest"])) & (k_abs <= np.float32(k_max))
    phases = np.random.default_rng(p["seed"]).uniform(0.0, 2.0 * np.pi, size=k_abs.shape)
    k = torch.from_numpy(np.where(in_band, k_abs, np.float32(1.0))).to(device=device, dtype=dtype)
    amp = torch.where(torch.from_numpy(in_band).to(device), k ** p["slope"], 0.0).to(work)
    del k
    theta = torch.from_numpy(phases).to(device=device, dtype=dtype).to(work)
    spectrum = torch.polar(amp, theta)
    del amp, theta
    rows = torch.fft.ifft(torch.fft.ifftshift(spectrum, dim=0), dim=0)
    del spectrum
    # irfft takes the real parts of the zero and the Nyquist frequencies
    rows[:, 0] = rows[:, 0].real.to(rows.dtype)
    rows[:, -1] = rows[:, -1].real.to(rows.dtype)
    h = torch.fft.irfft(rows, n=g["nx"], dim=1)
    del rows
    h = (h * (p["RMS"] / torch.std(h, unbiased=False))).to(dtype)
    _MAPS[key] = h
    return h


def nodes(defect, iy, ix, *, dtype, device) -> np.ndarray:
    """Heights [mm] of the map's nodes (iy, ix), synthesized in ``dtype``."""
    h = synthesize(defect, dtype=dtype, device=device)
    iy, ix = (torch.as_tensor(np.asarray(i), device=device) for i in (iy, ix))
    return h[iy, ix].double().cpu().numpy()


def height(defect, x, y):
    """The clamped bilinear height at support points (x, y), read from the
    float64 map and rounded to the points' dtype."""
    g = grid(defect)
    h = synthesize(defect, dtype=torch.float64, device=x.device)
    nx, ny = g["nx"], g["ny"]
    fx = torch.clamp((x - g["x0"]) / g["dx"], 0.0, nx - 1.0)
    fy = torch.clamp((y - g["y0"]) / g["dy"], 0.0, ny - 1.0)
    ix = torch.clamp(torch.floor(fx).long(), 0, nx - 2)
    iy = torch.clamp(torch.floor(fy).long(), 0, ny - 2)
    wx, wy = fx - ix.to(fx.dtype), fy - iy.to(fy.dtype)
    c00, c10, c01, c11 = (h[j, i].to(x.dtype) for j, i in ((iy, ix), (iy, ix + 1),
                                                            (iy + 1, ix), (iy + 1, ix + 1)))
    return ((1 - wx) * (1 - wy) * c00 + wx * (1 - wy) * c10 + (1 - wx) * wy * c01
            + wx * wy * c11)


def ops(defect) -> int:
    return SHIFT_OPS


def map_nodes(defect) -> int:
    g = grid(defect)
    return g["nx"] * g["ny"]
