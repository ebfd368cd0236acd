"""image_ms: wall of the images finished in the window over their count
[ms], from the first image's start to the last one's end."""

from benchmark import readers


def read(run):
    wall = readers.window_per_unit_s(run)
    return None if wall is None else 1e3 * wall
