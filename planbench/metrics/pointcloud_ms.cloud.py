"""The runner's pointcloud phase a request: sampling, filter and builds on the host, the move to the card."""

from planbench import readers


def read(run):
    return readers.phase_ms(run, "pointcloud")
