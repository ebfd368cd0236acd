"""placement_ms.design: mean wall [ms] of OEPlacement (the chain and its
host source) per design, from the benchmark's span around it."""

from benchmark import readers


def read(run):
    return readers.span_ms(run, "placement")
