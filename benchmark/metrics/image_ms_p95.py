"""image_ms_p95: 95th percentile of the images' walls [ms], each from its
start to its synchronize()."""

from benchmark import readers


def read(run):
    return readers.wall_quantile_ms(run, 0.95)
