"""The staging: the environments built and stacked, the endpoint arrays and
the move to the card, ms a request: the runner's span pc_stage in its
phases; nothing where the runner has no such span."""

import numpy as np


def read(run):
    vals = [it["timings"]["pc_stage"] for it in run.items
            if "pc_stage" in it.get("timings", {})]
    return 1e3 * float(np.mean(vals)) if vals else None
