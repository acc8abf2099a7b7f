"""Share of the traced slice in which no kernel or copy ran on the card."""

from planbench import readers


def read(run):
    return readers.device_idle_pct(run)
