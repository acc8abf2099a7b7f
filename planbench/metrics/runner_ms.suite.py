"""The suite runner's own phases a suite: build_batch, validity and gather."""

from planbench import readers


def read(run):
    return readers.phase_ms(run, "build_batch", "validity", "gather")
