"""The simplifier megakernel's phase a request."""

from planbench import readers


def read(run):
    return readers.phase_ms(run, "simplify")
