"""Device time of the planner kernel (rrtc_mega_kernel) a suite of the traced slice."""

from planbench import readers


def read(run):
    return readers.kernel_ms(run, "rrtc_mega")
