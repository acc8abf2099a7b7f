"""Readers the metric files share.  Each takes a finished run (harness.Run)
and returns a number, or None where the run holds nothing to read."""

from __future__ import annotations

import numpy as np

from planbench import stats


def _requests(run):
    return run.items if run.items and "problems" not in run.items[0] else None


def _suites(run):
    return run.items if run.items and "problems" in run.items[0] else None


def problems_per_s(run):
    items = _suites(run)
    return None if items is None else stats.rate(sum(it["problems"] for it in items),
                                                 run.window_s)


def request_ms(run):
    items = _requests(run)
    return None if items is None else 1e3 * run.window_s / len(items)


def request_ms_p95(run):
    items = _requests(run)
    return None if items is None else 1e3 * stats.p95([it["t1"] - it["t0"] for it in items])


def path_cost(run):
    costs = []
    for it in run.items:
        if "cost" not in it or "error" in it:
            continue
        if np.ndim(it["cost"]):
            costs.extend(np.asarray(it["cost"], np.float64).tolist())
        elif it["solved"]:
            costs.append(float(it["cost"]))
    return float(np.median(costs)) if costs else None


def setup_s(run):
    return run.setup_s


def phase_ms(run, *names):
    """Mean over the window's items of the sum of the runner's phases."""
    vals = [sum(it["timings"].get(n, 0.0) for n in names)
            for it in run.items if "timings" in it]
    return 1e3 * float(np.mean(vals)) if vals else None


def phase_share_pct(run, part, whole):
    num = sum(sum(it["timings"].get(n, 0.0) for n in part) for it in run.items if "timings" in it)
    den = sum(sum(it["timings"].get(n, 0.0) for n in whole) for it in run.items
              if "timings" in it)
    return 100.0 * num / den if den > 0 else None


def item_mean(run, key, scale=1.0):
    vals = [it[key] for it in run.items if key in it]
    return scale * float(np.mean(vals)) if vals else None


def span_ms(run, name):
    vals = [it["spans"][name] for it in run.items if "spans" in it and name in it["spans"]]
    return 1e3 * float(np.mean(vals)) if vals else None


def device_idle_pct(run):
    t = run.device_trace
    if t is None or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return stats.idle_pct(t["busy_s"], t["window_s"])


def kernel_ms(run, fragment):
    """Device time of the kernels whose name holds `fragment`, ms an item
    of the traced slice."""
    t = run.device_trace
    if t is None:
        return None
    sec = sum(v for k, v in t["kernels"].items() if fragment in k)
    return 1e3 * sec / t["items"] if sec > 0 else None
