"""The CAPT build (no planner on the card reads it; it is built for its
build time), ms a request: the runner's span pc_build_capt in its phases;
nothing where the runner has no such span."""

import numpy as np


def read(run):
    vals = [it["timings"]["pc_build_capt"] for it in run.items
            if "pc_build_capt" in it.get("timings", {})]
    return 1e3 * float(np.mean(vals)) if vals else None
