"""Each cell's check catches the faults its timed path can have: a run
driven on the CPU at a small size (the harness's look for a card skipped)
is correct, and the same run with the program broken underneath reads
``correct`` false. Faults: half of the rays left out, an answer altered
where it is produced, an alignment step that returns its state unchanged.
The exchange between cards has no cell here (every cell takes one card)."""

import numpy as np
import pytest

from cells_small import ROOT, bench as load_bench, kernel_engines, overrides
from benchmark import harness


def _run(cell, seed=5, seconds=0.5):
    bench = load_bench()
    with kernel_engines():
        return harness.run_cell(bench, cell, seed, seconds, False, device="cpu",
                                overrides=overrides(bench.cell(cell)))


def _half_the_rays(monkeypatch):
    """The fused trace returns every other ray dead (the outer half of the
    cone dies at the mask anyway), the images trace half of the rays they
    were asked for, and the scan's moment passes sum only the rays from the
    middle of the source on."""
    from attosecondraytracing_tpu_torch.analysis import gigascan
    from attosecondraytracing_tpu_torch.ops import fused_scan as fs
    from attosecondraytracing_tpu_torch.ops import fused_trace as ft

    trace = ft.fused_source_trace

    def half(*args, **kwargs):
        out = trace(*args, **kwargs)
        alive = out.alive.clone()
        alive[::2] = False
        return out._replace(alive=alive)

    monkeypatch.setattr(ft, "fused_source_trace", half)
    images = gigascan.fused_source_images

    def half_images(*args, n_total=None, **kwargs):
        res = images(*args, n_total=n_total // 2, **kwargs)
        return dict(res, n_total=n_total)

    monkeypatch.setattr(gigascan, "fused_source_images", half_images)
    def second_half(spec, n_rays, phase=0.0, k_frac=0.0):
        off = n_rays // 2
        return ft.source_chunks(spec.source_kind, n_rays - off, spec.n_total, ft.CHUNK,
                                float(np.mod(phase + off * ft._PHI_FRAC, 1.0)),
                                k_frac + off / spec.n_total, n_each=spec.n_each,
                                n_sources=spec.n_sources)

    monkeypatch.setattr(fs, "scan_chunks", second_half)


def _altered_answers(monkeypatch):
    """The optimizer reports its detector 1 mm off (a design's and each
    chain's of a scan), the alignment's loss history 1 % high, the delay map
    10 fs off."""
    from attosecondraytracing_tpu_torch.analysis import alignment, gigascan, optimizer

    find = optimizer.FindOptimalDistanceFused

    def shifted(*args, **kwargs):
        det, spot, duration = find(*args, **kwargs)
        det.shiftByDistance(1.0)
        return det, spot, duration

    monkeypatch.setattr(optimizer, "FindOptimalDistanceFused", shifted)
    align = alignment.gradient_align

    def scaled(*args, **kwargs):
        params, history = align(*args, **kwargs)
        return params, [1.01 * h for h in history]

    scaled.last_engine = None
    monkeypatch.setattr(alignment, "gradient_align", scaled)
    images = gigascan.fused_source_images

    def delayed(*args, **kwargs):
        res = images(*args, **kwargs)
        return dict(res, mean_delay=np.asarray(res["mean_delay"]) + 10.0)

    monkeypatch.setattr(gigascan, "fused_source_images", delayed)


def _state_unchanged(monkeypatch):
    """Every alignment step returns the poses it was given: the gradient is
    zero."""
    import torch

    from attosecondraytracing_tpu_torch.ops import fused_grad

    value_and_grad = fused_grad.fused_focus_value_and_grad

    def frozen(*args, **kwargs):
        loss, grads = value_and_grad(*args, **kwargs)
        return loss, type(grads)(*(torch.zeros_like(g) for g in grads))

    monkeypatch.setattr(fused_grad, "fused_focus_value_and_grad", frozen)


FAULTS = {
    "fxf.design": [_half_the_rays, _altered_answers],
    "fxf.align": [_altered_answers, _state_unchanged],
    "fxf.image": [_half_the_rays, _altered_answers],
    "fxf.scan": [_half_the_rays, _altered_answers],
}


@pytest.mark.parametrize("cell", sorted(FAULTS))
def test_sound_run_is_correct(cell):
    res = _run(cell)
    assert res["attempted"] >= 1
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("cell,fault", [(c, f) for c, fs in sorted(FAULTS.items()) for f in fs],
                         ids=lambda x: x if isinstance(x, str) else x.__name__.strip("_"))
def test_fault_reads_incorrect(cell, fault, monkeypatch):
    fault(monkeypatch)
    res = _run(cell)
    assert not res["correct"], res["checks"]
