"""The pose vector as a differentiable torch function: the oracle that
``torch.func.jacfwd`` differentiates to hold the closed-form tangent rows
(``ops/fused_grad.scalar_jacobian``) and the float32 pose vector
(``ops/fused_grad.chain_scalars_np``) against. Read by
tests/test_torch_pose_tangents.py, tests/test_torch_fused_grad.py and
``chip_smoke.py``'s ``grad tangents:`` line; no path of the program calls it."""

import torch

from attosecondraytracing_tpu_torch.ops.trace import MaskElement


def chain_scalars(elements, source_rot, source_origin, det_centre, det_normal, det_rot):
    """``ops/fused_grad.chain_scalars_np`` as a differentiable float64 torch
    function of the elements' ``rot``/``position`` tensors (same layout, not
    rounded): the function whose Jacobian gives K6 its tangent rows."""
    f64 = torch.float64

    def t(x):
        return torch.as_tensor(x, dtype=f64) if not torch.is_tensor(x) else x.to(dtype=f64)

    rots = [t(el.rot) for el in elements]
    poss = [t(el.position) for el in elements]
    dev = rots[0].device
    cens = [torch.zeros(3, dtype=f64, device=dev) if isinstance(el, MaskElement)
            else t(el.centre).to(dev) for el in elements]
    maps = []
    for k, (R, pos, cen) in enumerate(zip(rots, poss, cens)):
        if k == 0:
            maps.append((R, -R @ pos + cen))
        else:
            maps.append((R @ rots[k - 1].T, R @ (poss[k - 1] - pos) + cen))
    M0 = maps[0][0]
    maps[0] = (M0 @ t(source_rot).to(dev), M0 @ (t(source_origin).to(dev) - poss[0]) + cens[0])
    parts = []
    for M, b in maps:
        parts += [M.reshape(-1), b]
    R_K, pos_K = rots[-1], poss[-1]
    rot = t(det_rot).to(dev)
    parts += [R_K @ (t(det_centre).to(dev) - pos_K), R_K @ t(det_normal).to(dev),
              R_K @ rot[0], R_K @ rot[1]]
    return torch.cat(parts)
