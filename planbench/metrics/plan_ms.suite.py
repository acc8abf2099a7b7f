"""The planner megakernel's phases a suite: plan and the 32x retry."""

from planbench import readers


def read(run):
    return readers.phase_ms(run, "plan", "retry")
