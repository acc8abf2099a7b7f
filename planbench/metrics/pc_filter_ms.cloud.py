"""The SCDF filter, ms a request: the runner's span pc_filter in its phases;
nothing where the runner has no such span."""

import numpy as np


def read(run):
    vals = [it["timings"]["pc_filter"] for it in run.items
            if "pc_filter" in it.get("timings", {})]
    return 1e3 * float(np.mean(vals)) if vals else None
