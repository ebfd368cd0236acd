"""Zernike circle polynomials and their Cartesian gradients (counterpart of
the JAX package's ``ops/zernike.py``).

The recurrence of T. B. Andersen, "Efficient and robust recurrence relations
for the Zernike circle polynomials and their derivatives in Cartesian
coordinates," Opt. Express 26, 18878 (2018), over whole arrays, with the
reference's (n, m) indexing (m = 0..n, azimuthal frequency 2m - n), so user
coefficient dictionaries behave identically. The same special cases and the
same order of operations as the JAX package, so the two agree to the last
bit in float64. Works on NumPy arrays (the host defect models) and on torch
tensors (the trace, differentiable). The CUDA kernels evaluate the same
recurrence row by row (``csrc/trace_common.cuh``, ``zernike_sums``).
"""

from __future__ import annotations

import numpy as np
import torch


def zernike_value_and_grad(x, y, max_order: int):
    """Evaluate all Zernike polynomials and their x/y gradients up to
    ``max_order`` at coordinates (x, y) on the unit disk.

    Returns three dicts keyed by (n, m), m = 0..n: values, d/dx, d/dy, each
    shaped like ``x`` (tensors for tensor inputs, NumPy arrays otherwise)."""
    max_order = max(int(max_order), 2)
    if torch.is_tensor(x) or torch.is_tensor(y):
        x = torch.as_tensor(x)
        y = torch.as_tensor(y, dtype=x.dtype, device=x.device)
        one = torch.ones_like(x)
        zero = torch.zeros_like(x)
    else:
        x = np.asarray(x)
        y = np.asarray(y)
        one = np.ones_like(x)
        zero = np.zeros_like(x)

    Z = {(0, 0): one, (1, 0): y, (1, 1): x}
    DX = {(0, 0): zero, (1, 0): zero, (1, 1): one}
    DY = {(0, 0): zero, (1, 0): one, (1, 1): zero}

    for n in range(2, max_order + 1):
        for m in range(0, n + 1):
            if m == 0:
                Z[(n, 0)] = x * Z[(n - 1, 0)] + y * Z[(n - 1, n - 1)]
                DX[(n, 0)] = n * Z[(n - 1, 0)]
                DY[(n, 0)] = n * Z[(n - 1, n - 1)]
            elif m == n:
                Z[(n, n)] = x * Z[(n - 1, n - 1)] - y * Z[(n - 1, 0)]
                DX[(n, n)] = n * Z[(n - 1, n - 1)]
                DY[(n, n)] = -n * Z[(n - 1, 0)]
            elif n % 2 != 0 and m == (n - 1) // 2:
                Z[(n, m)] = (
                    y * Z[(n - 1, n - 1 - m)]
                    + x * Z[(n - 1, m - 1)]
                    - y * Z[(n - 1, n - m)]
                    - Z[(n - 2, m - 1)]
                )
                DX[(n, m)] = n * Z[(n - 1, m - 1)] + DX[(n - 2, m - 1)]
                DY[(n, m)] = n * Z[(n - 1, n - 1 - m)] - n * Z[(n - 1, n - m)] + DY[(n - 2, m - 1)]
            elif n % 2 != 0 and m == (n - 1) // 2 + 1:
                Z[(n, m)] = (
                    x * Z[(n - 1, m)]
                    + y * Z[(n - 1, n - 1 - m)]
                    + x * Z[(n - 1, m - 1)]
                    - Z[(n - 2, m - 1)]
                )
                DX[(n, m)] = n * Z[(n - 1, m)] + n * Z[(n - 1, m - 1)] + DX[(n - 2, m - 1)]
                DY[(n, m)] = n * Z[(n - 1, n - 1 - m)] + DY[(n - 2, m - 1)]
            elif n % 2 == 0 and m == n // 2:
                Z[(n, m)] = 2.0 * x * Z[(n - 1, m)] + 2.0 * y * Z[(n - 1, m - 1)] - Z[(n - 2, m - 1)]
                DX[(n, m)] = 2.0 * n * Z[(n - 1, m)] + DX[(n - 2, m - 1)]
                DY[(n, m)] = 2.0 * n * Z[(n - 1, n - 1 - m)] + DY[(n - 2, m - 1)]
            else:
                Z[(n, m)] = (
                    x * Z[(n - 1, m)]
                    + y * Z[(n - 1, n - 1 - m)]
                    + x * Z[(n - 1, m - 1)]
                    - y * Z[(n - 1, n - m)]
                    - Z[(n - 2, m - 1)]
                )
                DX[(n, m)] = n * Z[(n - 1, m)] + n * Z[(n - 1, m - 1)] + DX[(n - 2, m - 1)]
                DY[(n, m)] = n * Z[(n - 1, n - 1 - m)] - n * Z[(n - 1, n - m)] + DY[(n - 2, m - 1)]

    return Z, DX, DY


def zernike_value_grad_hessian(x, y, max_order: int):
    """:func:`zernike_value_and_grad` and the second derivatives, by the
    same recurrence differentiated once more: each gradient row of the
    recurrence reads row n - 1's values and row n - 2's gradient, so the
    Hessian row reads row n - 1's gradient and row n - 2's Hessian
    (d2Z(n, m)/dx2 = n dZ(n - 1, .)/dx + d2Z(n - 2, m - 1)/dx2, and so on).
    The gradient kernel K6 composes a mirror's slope tangents from these
    rows (``csrc/trace_common.cuh``, ``zernike_hessian``: the recurrence
    with slopes on dual numbers seeded along x and y); this is its plain
    twin for the tests, which nothing on the kernels' path calls.

    Returns six dicts keyed by (n, m): values, d/dx, d/dy, d2/dx2, d2/dxdy,
    d2/dy2."""
    max_order = max(int(max_order), 2)
    Z, DX, DY = zernike_value_and_grad(x, y, max_order)
    zero = DX[(0, 0)]
    DXX = {k: zero for k in ((0, 0), (1, 0), (1, 1))}
    DXY = dict(DXX)
    DYY = dict(DXX)
    for n in range(2, max_order + 1):
        for m in range(0, n + 1):
            # (row n - 1 entries with their signs) of DX and DY, as the
            # recurrence reads them from Z
            if m == 0:
                dx_terms, dy_terms, two = [(1, 0)], [(1, n - 1)], False
            elif m == n:
                dx_terms, dy_terms, two = [(1, n - 1)], [(-1, 0)], False
            elif n % 2 != 0 and m == (n - 1) // 2:
                dx_terms, dy_terms, two = [(1, m - 1)], [(1, n - 1 - m), (-1, n - m)], True
            elif n % 2 != 0 and m == (n - 1) // 2 + 1:
                dx_terms, dy_terms, two = [(1, m), (1, m - 1)], [(1, n - 1 - m)], True
            elif n % 2 == 0 and m == n // 2:
                dx_terms, dy_terms, two = [(2, m)], [(2, n - 1 - m)], True
            else:
                dx_terms, dy_terms, two = [(1, m), (1, m - 1)], [(1, n - 1 - m), (-1, n - m)], True

            def row(terms, D):
                return sum(sign * n * D[(n - 1, j)] for sign, j in terms)

            DXX[(n, m)] = row(dx_terms, DX) + (DXX[(n - 2, m - 1)] if two else 0)
            DXY[(n, m)] = row(dx_terms, DY) + (DXY[(n - 2, m - 1)] if two else 0)
            DYY[(n, m)] = row(dy_terms, DY) + (DYY[(n - 2, m - 1)] if two else 0)
    return Z, DX, DY, DXX, DXY, DYY
