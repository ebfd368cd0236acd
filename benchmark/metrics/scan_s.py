"""scan_s: wall seconds per 11-chain scan, from the first scan's start to
the last finished scan's end, over their count."""

from benchmark import readers


def read(run):
    return readers.window_per_unit_s(run)
