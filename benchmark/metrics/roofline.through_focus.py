"""roofline.through_focus: the least time the window's designs need by the
work model (benchmark/kinds/fixed_design.py: K1's trace with its outputs
stored, the summary's read of them, the map's touched nodes) over the
device's busy time in the window [%]."""

from benchmark import readers


def read(run):
    return readers.roofline_percent(run)
