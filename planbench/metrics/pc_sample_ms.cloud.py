"""The surface sampling of the cylinders and boxes, ms a request: the
runner's span pc_sample in its phases; nothing where the runner has no such
span."""

import numpy as np


def read(run):
    vals = [it["timings"]["pc_sample"] for it in run.items
            if "pc_sample" in it.get("timings", {})]
    return 1e3 * float(np.mean(vals)) if vals else None
