"""driver_ms.design: mean wall [ms] of main.main per design, ending in
synchronize(), from the benchmark's span around it."""

from benchmark import readers


def read(run):
    return readers.span_ms(run, "driver")
