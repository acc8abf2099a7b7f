"""The planner megakernel's phases a request: plan and the 16x retry."""

from planbench import readers


def read(run):
    return readers.phase_ms(run, "plan", "retry")
