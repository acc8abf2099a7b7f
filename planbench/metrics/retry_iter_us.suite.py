"""The retry's slowest block's time an iteration, in us (the runner's count
retry_iter_us), averaged over the window's suites; nothing where the runner
does not count it."""

import numpy as np


def read(run):
    vals = [it["timings"]["retry_iter_us"] for it in run.items
            if "retry_iter_us" in it.get("timings", {})]
    return float(np.mean(vals)) if vals else None
