"""Constants and the dtype policy of the PyTorch port.

float32 is the trace dtype, as in the JAX package on its accelerator: the
tracer stays accurate in float32 because intersections are computed in the
element-local frame, every closed-form root is Newton-polished, and the
optical path is Kahan-compensated (see the JAX package's ``ops/precision.py``).

float64 is used only when the caller asks for it: parity tests set
``ART_TPU_DTYPE=float64`` (the variable the JAX package reads too), and the
optimizer's float64 refinement passes the dtype explicitly. Nothing here
depends on a global "x64" switch.
"""

from __future__ import annotations

import os

import torch

#: Speed of light in mm/s (the reference uses mm everywhere).
LIGHT_SPEED_MM_S = 299792458000.0

#: Minimum ray-advance distance for a hit to count as "in front of" the ray.
T_EPS = 1e-9

#: A polished candidate root is a real hit within this distance [mm] of the
#: surface (the float32 toroid widens it, see ``surfaces._hit_tol_for``).
HIT_TOL = 1e-3

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def env_dtype() -> torch.dtype | None:
    """Explicit dtype override from ``ART_TPU_DTYPE`` (None when unset)."""
    name = os.environ.get("ART_TPU_DTYPE")
    if not name:
        return None
    if name not in _DTYPES:
        raise ValueError(f"ART_TPU_DTYPE must be one of {sorted(_DTYPES)}, got {name!r}")
    return _DTYPES[name]


def default_dtype() -> torch.dtype:
    """Trace dtype: float32 unless ``ART_TPU_DTYPE`` asks for float64."""
    return env_dtype() or torch.float32


def rsqrt(x: torch.Tensor) -> torch.Tensor:
    """``torch.rsqrt``, correctly rounded for float32 on the CPU.

    PyTorch's CPU rsqrt is ``1 / sqrt`` (two roundings) and its vectorized
    float32 sqrt is not correctly rounded either; the float32 toroid's
    residual cancels ``rho - R`` at metre radii, so an ulp there moves the
    root. Through float64 the result is the correctly rounded value, as
    XLA's. On CUDA this is ``torch.rsqrt`` (the ``rsqrtf`` the kernels
    take), so the card's plain versions keep their arithmetic."""
    if x.dtype == torch.float32 and x.device.type == "cpu":
        return torch.rsqrt(x.double()).float()
    return torch.rsqrt(x)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """``torch.sqrt``, correctly rounded for float32 on the CPU (as
    :func:`rsqrt`); the kernels' ``sqrtf`` is IEEE-rounded."""
    if x.dtype == torch.float32 and x.device.type == "cpu":
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def resolve_device(device) -> torch.device:
    """A ``torch.device`` from a name or device; a CUDA device must exist
    (there is no silent CPU fallback)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions"
        )
    return device
