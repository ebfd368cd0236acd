"""roofline.design: the least time the window's requests need by the work
model (benchmark/work/model.py) over the device's busy time in the
window [%]."""

from benchmark import readers


def read(run):
    return readers.roofline_percent(run)
