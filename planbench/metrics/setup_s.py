"""Process start to the window's start."""

from planbench import readers


def read(run):
    return readers.setup_s(run)
