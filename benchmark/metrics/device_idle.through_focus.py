"""device_idle.through_focus: share [%] of the traced window in which the
device ran neither a kernel nor a copy (torch.profiler, CUDA activity)."""

from benchmark import readers


def read(run):
    return readers.device_idle_percent(run)
