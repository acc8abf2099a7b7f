"""Every problem of every suite completed in the window, over the window's time."""

from planbench import readers


def read(run):
    return readers.problems_per_s(run)
