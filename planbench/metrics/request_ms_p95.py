"""The 95th percentile of every request's time, handed in to held on the host."""

from planbench import readers


def read(run):
    return readers.request_ms_p95(run)
