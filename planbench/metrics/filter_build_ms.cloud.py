"""The filter's and the builds' own time a request (the runner's filter_ns + build_ns)."""

from planbench import readers


def read(run):
    return readers.item_mean(run, "filter_build_ns", 1e-6)
