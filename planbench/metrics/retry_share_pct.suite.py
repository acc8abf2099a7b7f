"""The retry's share of planning time over the window."""

from planbench import readers


def read(run):
    return readers.phase_share_pct(run, ("retry",), ("plan", "retry"))
