"""The median simplified path cost (rad) over every problem the window solved."""

from planbench import readers


def read(run):
    return readers.path_cost(run)
