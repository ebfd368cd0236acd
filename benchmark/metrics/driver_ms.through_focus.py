"""driver_ms.through_focus: mean wall [ms] of main.main per design at a
fixed detector, ending in synchronize(), from the benchmark's span around
it."""

from benchmark import readers


def read(run):
    return readers.span_ms(run, "driver")
