"""Nothing a check needs is read inside the timed window: no run of any
cell builds a factory source bundle between the window's first request and
its last (the port's counter ``models.sources.factory_bundle.builds``),
while the design's check still compares the sampled source, read from the
kept chain after the window."""

import pytest

from cells_small import ROOT, bench as load_bench, kernel_engines, overrides
from benchmark import harness


def _recorded(monkeypatch, kind_module, readings):
    """The kind's calls wrapped to note the count of bundles built at each."""
    from attosecondraytracing_tpu_torch.models import sources

    cls = kind_module.Kind

    def noted(name, in_window):
        method = getattr(cls, name)

        def wrapper(self, request, arg):
            if in_window(arg):
                readings.append((name, sources.factory_bundle.builds))
            out = method(self, request, arg)
            if in_window(arg):
                readings.append((name + " done", sources.factory_bundle.builds))
            return out

        monkeypatch.setattr(cls, name, wrapper)

    # the warm-up request is served without spans, before the window
    noted("serve", lambda spans: spans is not None)
    noted("keep", lambda raw: True)
    noted("answer", lambda kept: True)


@pytest.mark.parametrize("cell", ["fxf.design", "fxf.align", "fxf.image", "fxf.scan"])
def test_no_bundle_built_in_the_window(cell, monkeypatch):
    bench = load_bench()
    traffic = harness.load_cell(bench, cell).traffic
    readings = []
    _recorded(monkeypatch, harness.load_kind(traffic["kind"]), readings)
    with kernel_engines():
        res = harness.run_cell(bench, cell, 6, 0.5, False, device="cpu",
                               overrides=overrides(bench.cell(cell)))
    assert res["correct"], res["checks"]
    window = [n for name, n in readings if not name.startswith("answer")]
    assert len([name for name, _ in readings if name == "serve"]) == res["attempted"]
    assert len(set(window)) == 1, readings
    if cell == "fxf.design":
        # each kept design's source is built once, after the window, and compared
        answered = [n for name, n in readings if name == "answer done"]
        assert answered[-1] == window[-1] + len(answered)
        sources = [c for key, c in res["checks"].items() if key.endswith(".source")]
        assert len(sources) == len(answered) and all(c["value"] <= c["limit"] for c in sources)
