"""The metric arithmetic replayed on a recorded run: end-to-end readers on
request walls, device idle share and roofline share on a device window
with overlapping kernels, the breakdown's idle gaps labelled by host spans,
and a roofline share above 105 % refused."""

import pytest

from cells_small import ROOT
from benchmark import harness, readers


def _run(least):
    device = harness.DeviceWindow(
        events=[("void k_a(float*)", 1.0, 2.0), ("void k_b(int)", 1.5, 3.0),
                ("Memcpy HtoD", 5.0, 5.5), ("void k_a(float*)", 9.0, 12.0)],
        window=(0.0, 10.0))
    requests = [harness.Request(0.5, 4.5, 1), harness.Request(4.6, 9.9, 1)]
    spans = [("image", 0.5, 4.5), ("fused_source_images", 0.6, 4.4),
             ("image", 4.6, 9.9), ("fused_source_images", 4.7, 9.8)]
    return harness.Run("fxf.image", "image", requests, 12.5, spans, device, least)


def test_device_window_arithmetic():
    run = _run([0.5, 0.5])
    assert run.device.busy_intervals() == [(1.0, 3.0), (5.0, 5.5), (9.0, 10.0)]
    assert run.device.busy_seconds() == pytest.approx(3.5)
    assert readers.device_idle_percent(run) == pytest.approx(65.0)
    assert readers.roofline_percent(run) == pytest.approx(100.0 * 1.0 / 3.5)
    assert run.device.gaps() == [(0.0, 1.0), (3.0, 5.0), (5.5, 9.0)]


def test_breakdown_labels_gaps_by_host_spans():
    b = harness.breakdown(_run(None).device, _run(None).spans, "image")
    assert b["device_ops"][0] == ["void k_a", pytest.approx(2.0)]
    gaps = {round(s, 6): n for n, s in b["idle_gaps"]}
    assert gaps[3.5] == "fused_source_images"
    assert gaps[2.0] == "fused_source_images"
    assert gaps[1.0] == "image"


def test_read_metrics_reports_the_cells_per_layer_metrics():
    bench = harness.load_benchmark(ROOT)
    got = harness.read_metrics(bench, "fxf.image", "per_layer", _run([0.5, 0.5]))
    assert set(got) == {"device_idle.image", "roofline.image"}
    assert got["roofline.image"] == {"value": pytest.approx(100.0 / 3.5), "unit": "%"}


@pytest.mark.parametrize("lost", [(), (0,), (2,), (3,), (0, 1, 2), (3, 4, 5), (0, 4)])
def test_clock_offset_from_the_markers_the_trace_holds(lost):
    """Device clock 100 s behind the host's, drifting 20 us over a 50 s
    window; three markers at each end, 40 us apart, any of them lost."""
    host = [[1.0, 1.00004, 1.00008], [51.0, 51.00004, 51.00008]]
    device = [t - 100.0 - (2e-5 if t > 50 else 0.0) for end in host for t in end]
    found = [d for i, d in enumerate(device) if i not in lost]
    offset, drift = harness.clock_offset(host, found, inside=-75.0)
    start_whole, end_whole = not {0, 1, 2} <= set(lost), not {3, 4, 5} <= set(lost)
    assert offset == pytest.approx(100.0 if start_whole else 100.00002, abs=4.1e-5)
    assert drift == pytest.approx(2e-5 if start_whole and end_whole else 0.0, abs=4.1e-5)


def test_clock_offset_needs_a_marker():
    with pytest.raises(RuntimeError, match="no marker"):
        harness.clock_offset([[1.0], [51.0]], [], inside=0.0)


def test_roofline_share_above_105_percent_is_refused():
    bench = harness.load_benchmark(ROOT)
    with pytest.raises(ValueError, match="roofline.image"):
        harness.read_metrics(bench, "fxf.image", "per_layer", _run([2.0, 2.0]))


def test_wall_readers():
    reqs = [harness.Request(float(i), i + 0.5 + 0.01 * i, 20) for i in range(40)]
    run = harness.Run("c", "k", reqs, 1.0, [], None, None)
    # the window (first start to last end) over the units: the half
    # seconds between requests count
    assert readers.window_per_unit_s(run) == pytest.approx((39 + 0.5 + 0.39) / 800)
    assert readers.window_per_unit_s(harness.Run("c", "k", [], 1.0, [], None, None)) is None
    assert readers.wall_quantile_ms(run, 0.95) == pytest.approx(
        1e3 * (0.5 + 0.01 * 37.95), rel=1e-3)
    assert readers.wall_quantile_ms(harness.Run("c", "k", reqs[:10], 1.0, [], None, None),
                                    0.95) is None
    assert readers.device_idle_percent(run) is None


def test_reservoir_follows_the_seed():
    import numpy as np

    def sample(seed, n):
        r = harness.Reservoir(2, np.random.default_rng(seed))
        for i in range(n):
            slot = r.wants()
            if slot is not None:
                r.put(slot, i)
        return sorted(r.items)

    assert sample(1, 50) == sample(1, 50)
    assert len(sample(1, 50)) == 2 and len(sample(1, 1)) == 1
    seen = {tuple(sample(s, 10)) for s in range(200)}
    assert len(seen) > 20
