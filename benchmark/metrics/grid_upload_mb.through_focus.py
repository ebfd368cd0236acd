"""grid_upload_mb.through_focus: MB [1e6 bytes] of grid maps the program
packed into rows or copied onto a device per design inside the window,
from its counters (ops/fused_trace.grid_rows.packed_bytes, ops/defects.
grid_to.copied_bytes) read around each request (benchmark/kinds/
fixed_design.py). None where the program has no such counters."""

from benchmark.kinds import fixed_design


def read(run):
    if not run.requests:
        return None
    lo, hi = run.requests[0].start, run.requests[-1].end
    inside = [n for s, e, n in fixed_design.UPLOADS if s >= lo and e <= hi]
    if not inside or any(n is None for n in inside):
        return None
    return 1e-6 * sum(inside) / len(inside)
