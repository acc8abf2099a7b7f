"""Rows the suite's retry plans with their own goals (the runner's count
retry_live), a suite; nothing where the runner does not count it."""

import numpy as np


def read(run):
    vals = [it["timings"]["retry_live"] for it in run.items
            if "retry_live" in it.get("timings", {})]
    return float(np.mean(vals)) if vals else None
