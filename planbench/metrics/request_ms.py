"""The window's time over the requests it completed (one client, closed loop)."""

from planbench import readers


def read(run):
    return readers.request_ms(run)
