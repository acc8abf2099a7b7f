"""The build of the cloud's kernel form, which the megakernels read, ms a
request: the runner's span pc_build_kernel in its phases; nothing where the
runner has no such span."""

import numpy as np


def read(run):
    vals = [it["timings"]["pc_build_kernel"] for it in run.items
            if "pc_build_kernel" in it.get("timings", {})]
    return 1e3 * float(np.mean(vals)) if vals else None
