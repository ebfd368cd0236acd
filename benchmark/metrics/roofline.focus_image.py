"""roofline.focus_image: the least time the window's images need by the
work model (benchmark/work/model.py image_seconds) over the device's busy
time in the window [%]."""

from benchmark import readers


def read(run):
    return readers.roofline_percent(run)
