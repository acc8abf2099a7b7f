"""Profiling and timing utilities.

Port of `vamp_mvt_tpu/utils/profiling.py`.  The reference times planner
bodies with steady_clock deltas surfaced as PlanningResult::nanoseconds:

- `device_timer`: wall-clock ns around a block, the device synchronised at
  both ends (CUDA devices; the CPU has nothing to wait for).
- `trace`: a `torch.profiler` trace of the host and, with a GPU, the card,
  written into `log_dir` as a Chrome trace.
- `op_breakdown`: a trace directory's complete events ("ph": "X") summed by
  name: (name, total_us, count).
"""

from __future__ import annotations

import collections
import contextlib
import gzip
import json
import os
import time

import torch

from vamp_mvt_tpu_torch.device import resolve_device

TRACE_FILE = "trace.json"


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def device_timer(result: dict, key: str = "nanoseconds", device=None):
    """Times the block in ns into result[key], synchronising `device`
    (default: the GPU) at both ends."""
    dev = resolve_device(device)
    _sync(dev)
    t0 = time.perf_counter_ns()
    yield
    _sync(dev)
    result[key] = time.perf_counter_ns() - t0


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block (CPU activity, and CUDA activity where a GPU is
    present) into `log_dir`/trace.json."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def op_breakdown(log_dir: str, top: int = 20):
    """The `top` names of the newest trace in `log_dir` by summed duration
    of its complete events: [(name, total_us, count), ...]."""
    names = [f for f in os.listdir(log_dir) if f.endswith((".json", ".json.gz"))]
    if not names:
        raise FileNotFoundError(f"no trace in {log_dir}")
    path = max((os.path.join(log_dir, f) for f in names), key=os.path.getmtime)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fh:
        data = json.load(fh)
    agg = collections.Counter()
    cnt = collections.Counter()
    for e in data["traceEvents"]:
        if e.get("ph") == "X" and "dur" in e:
            agg[e["name"]] += e["dur"]
            cnt[e["name"]] += 1
    return [(name, dur, cnt[name]) for name, dur in agg.most_common(top)]
