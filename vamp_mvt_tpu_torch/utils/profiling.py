"""Profiling and timing utilities.

Port of `vamp_mvt_tpu/utils/profiling.py`.  The reference times planner
bodies with steady_clock deltas surfaced as PlanningResult::nanoseconds:

- `device_timer`: wall-clock ns around a block, the device synchronised at
  both ends (CUDA devices; the CPU has nothing to wait for).
- `trace`: a `torch.profiler` trace of the host and, with a GPU, the card,
  written into `log_dir` as a Chrome trace.
- `op_breakdown`: a trace directory's complete events ("ph": "X") summed by
  name: (name, total_us, count).

The port's own spans and counts (not in the JAX package): a runner makes
its `timings` dict the active recorder for one call (`recording`); inside
it `span(name)` adds the block's seconds to `timings[name]` and logs
(request_id, name, parent, t0, t1) on time.perf_counter under
`timings["spans"]`, and `count(name, value)` sums a value, a CUDA tensor
left on the card, into `timings[name]` when the runner calls `read_counts`.
Under `torch.profiler` a span is also a host range "vmt.<name>".  With no
recorder a span is one check and a shared no-op context.
"""

from __future__ import annotations

import collections
import contextlib
import gzip
import itertools
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


# The active recorder (a runner call's), or None.
_ACTIVE = None
_IDS = itertools.count(1)
_OFF = contextlib.nullcontext()


class Recorder:
    """The spans and counts of one runner call, kept in `into` (its
    `timings` dict); every span of the call carries `request_id`.  `counts`
    is None where the call counts nothing."""

    __slots__ = ("into", "request_id", "spans", "stack", "counts")

    def __init__(self, into: dict, counts: bool = True):
        self.into = into
        self.request_id = next(_IDS)
        self.spans: list[tuple] = []
        self.stack: list[str] = []
        self.counts: dict | None = {} if counts else None


class _Span:
    __slots__ = ("rec", "name", "parent", "t0", "rf")

    def __init__(self, rec: Recorder, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        rec = self.rec
        self.parent = rec.stack[-1] if rec.stack else None
        rec.stack.append(self.name)
        self.rf = None
        if torch.autograd._profiler_enabled():
            # a FUNCTION-scope range: the profiler shows it on the host, and
            # does not mirror it onto the card's timeline as it mirrors
            # record_function's user ranges
            self.rf = torch._C._profiler._RecordFunctionFast("vmt." + self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        rec = self.rec
        rec.stack.pop()
        rec.spans.append((rec.request_id, self.name, self.parent, self.t0, t1))
        rec.into[self.name] = rec.into.get(self.name, 0.0) + (t1 - self.t0)
        return False


def span(name: str):
    """A span of the active recorder: the block's seconds add to its dict
    under `name` (see the module doc).  With no recorder, a shared no-op."""
    rec = _ACTIVE
    if rec is None:
        return _OFF
    return _Span(rec, name)


def counting() -> bool:
    """Whether the active recorder counts: the gate of work done only to
    compute a count."""
    return _ACTIVE is not None and _ACTIVE.counts is not None


def count(name: str, value) -> None:
    """Adds `value` (a number or a tensor; a tensor stays where it is, no
    sync) to the active recorder's count `name`; nothing with no recorder
    or one that counts nothing."""
    rec = _ACTIVE
    if rec is None or rec.counts is None:
        return
    c = rec.counts
    c[name] = c[name] + value if name in c else value


def read_counts() -> None:
    """Adds the active recorder's counts to its dict and clears them,
    copying the tensors to the host at once (a runner call's counts are on
    its one device): the runner calls it where it copies its results to the
    host anyway."""
    rec = _ACTIVE
    if rec is None or not rec.counts:
        return
    counts = rec.counts
    tensors = [n for n, v in counts.items() if isinstance(v, torch.Tensor)]
    if tensors:
        got = torch.stack([counts[n].reshape(()).to(torch.float64) for n in tensors]).tolist()
        counts.update(zip(tensors, got))
    for n, v in counts.items():
        rec.into[n] = rec.into.get(n, 0.0) + float(v)
    counts.clear()


@contextlib.contextmanager
def recording(into: dict | None, counts: bool = True):
    """Makes `into` (a runner's `timings`) the active recorder for the
    block, one request id; None turns spans and counts off inside it, and
    counts=False the counts alone.  On leaving, counts not yet read are read
    and the spans are appended to `into["spans"]`."""
    global _ACTIVE
    prev = _ACTIVE
    rec = _ACTIVE = None if into is None else Recorder(into, counts)
    try:
        yield rec
    finally:
        if rec is not None:
            read_counts()
            into.setdefault("spans", []).extend(rec.spans)
        _ACTIVE = prev
