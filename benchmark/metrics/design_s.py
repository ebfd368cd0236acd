"""design_s: wall seconds per design, from the first design's start to the
last finished design's end, over their count."""

from benchmark import readers


def read(run):
    return readers.window_per_unit_s(run)
