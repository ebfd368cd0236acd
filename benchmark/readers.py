"""Arithmetic the metric readers (``benchmark/metrics/*.py``) share: each
takes a :class:`benchmark.harness.Run` and returns a number, or None where
the run holds nothing to read."""

from __future__ import annotations

import statistics


def window_per_unit_s(run):
    """The window's wall seconds, from the first request's start to the last
    finished request's end, over the units (designs, Adam steps, images)
    those requests made: a stall between requests counts too."""
    units = sum(r.units for r in run.requests)
    if not units:
        return None
    return (run.requests[-1].end - run.requests[0].start) / units


def wall_quantile_ms(run, q: float):
    """The ``q`` quantile [ms] of the request walls (Python's exclusive
    method over 100 cut points), where at least 20 requests finished."""
    walls = [1e3 * (r.end - r.start) for r in run.requests]
    if len(walls) < 20:
        return None
    return statistics.quantiles(walls, n=100)[int(round(q * 100)) - 1]


def span_ms(run, name: str):
    """Mean duration [ms] of the host spans called ``name``."""
    walls = [e - s for n, s, e in run.spans if n == name]
    return 1e3 * sum(walls) / len(walls) if walls else None


def device_idle_percent(run):
    """Share [%] of the traced window in which the device ran no kernel and
    no copy."""
    if run.device is None or run.device.window_seconds() <= 0:
        return None
    return 100.0 * (1.0 - run.device.busy_seconds() / run.device.window_seconds())


def roofline_percent(run):
    """The work model's least seconds of the window's requests over the
    device's busy seconds in the window [%]: all device time counts, so the
    share means the same whatever kernels implement the work."""
    if run.device is None or not run.least_seconds:
        return None
    busy = run.device.busy_seconds()
    if busy <= 0:
        return None
    lo, hi = run.device.window
    inside = [s for r, s in zip(run.requests, run.least_seconds) if r.start >= lo and r.end <= hi]
    return 100.0 * sum(inside) / busy
