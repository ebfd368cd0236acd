"""placement_ms.through_focus: mean wall [ms] of OEPlacement (the chain
over the shared map, and its host source) per design at a fixed detector,
from the benchmark's span around it."""

from benchmark import readers


def read(run):
    return readers.span_ms(run, "placement")
