"""align_step_ms: wall of the gradient_align calls finished in the window,
from the first call's start to the last one's end, over the Adam steps they
made [ms]."""

from benchmark import readers


def read(run):
    wall = readers.window_per_unit_s(run)
    return None if wall is None else 1e3 * wall
