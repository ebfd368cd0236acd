"""roofline.scan: the least time the window's scans need by the work model
(one K5 pass per chain, benchmark/kinds/scan.py) over the device's busy
time in the window [%]."""

from benchmark import readers


def read(run):
    return readers.roofline_percent(run)
