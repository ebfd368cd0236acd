"""Pose scalars of the runtime-scalar kernels (counterpart of the host side
of the JAX package's ``ops/pallas_grad.py``).

The scan kernel K5 (``ops/fused_scan.py``) takes every pose-dependent
constant of a chain as a runtime vector instead of a baked record: per
element the composed chained-frame affine ``(M_k, b_k)`` (the first with the
source frame folded in), then the detector plane in the final element's
frame. :func:`chain_scalars_np` forms that vector; the gradient kernels K6
and K7 of the JAX package read the same layout and land here when they are
ported.

The composition runs in float64 NumPy on the host and the vector is rounded
to float32 once. The JAX package records why (``pallas_grad.py:101-107``): a
float32 (there: bfloat16-pass) composition displaced the traced geometry by
~0.5 mm and corrupted the moments by tens of percent.
"""

from __future__ import annotations

import numpy as np

from .trace import compose_chain, fold_source

#: scalars of the detector plane at the end of the vector: centre, normal,
#: e1, e2 in the final element's frame
N_DET_SCALARS = 12


def n_scalars(n_elements: int) -> int:
    """Length of the pose vector of a chain of ``n_elements`` elements."""
    return 12 * n_elements + N_DET_SCALARS


def chain_scalars_np(elements, source_rot, source_origin, det_centre, det_normal,
                     det_rot) -> np.ndarray:
    """The (n_scalars,) float32 pose vector of a chain, composed in host
    float64: per element k the composed map ``M_k`` (9, row-major) then
    ``b_k`` (3), element 0's map taking canonical source-frame coordinates
    (``source_rot``, ``source_origin``) straight into its surface frame;
    then the detector centre, normal, e1 and e2 in the final element's
    frame. Element poses may be tensors on any device and dtype."""
    maps, (R_K, pos_K) = compose_chain(elements)
    maps = fold_source(maps, elements, source_rot, source_origin)
    parts = []
    for M, b in maps:
        parts.append(np.asarray(M).reshape(-1))
        parts.append(np.asarray(b))
    rot = np.asarray(det_rot, np.float64)
    parts += [R_K @ (np.asarray(det_centre, np.float64) - pos_K),
              R_K @ np.asarray(det_normal, np.float64), R_K @ rot[0], R_K @ rot[1]]
    return np.concatenate(parts).astype(np.float32)


def _unpack_scalars(scal, n_elements: int):
    """Inverse of :func:`chain_scalars_np`: per-element ``(M, b)`` as nested
    tuples of the vector's entries, and the detector ``(centre, normal, e1,
    e2)``."""
    maps = []
    i = 0
    for _ in range(n_elements):
        M = tuple(tuple(scal[i + 3 * r + c] for c in range(3)) for r in range(3))
        b = tuple(scal[i + 9 + c] for c in range(3))
        maps.append((M, b))
        i += 12
    det = tuple(tuple(scal[i + 3 * g + c] for c in range(3)) for g in range(4))
    return maps, det
