"""The benchmark harness: one run of one cell.

A cell (`BENCHMARK.json`, `workloads`) names a configuration and a traffic
mix.  The harness finds everything else by those names, never by a list of
its own:

- `planbench/configs/<config>.json`: the deployment (robot, scene kind,
  entry settings), named by the `file` of its entry in `BENCHMARK.json`;
- `planbench/traffic/<traffic>.json`: the traffic mix, with the name of its
  driver, `planbench/drivers/<driver>.py`;
- `planbench/cells/<cell>.json`: what the correctness check samples and the
  limit of each number it compares;
- `planbench/metrics/<metric>.py`: one reader a metric, `read(run)`,
  returning a number, or None where it finds nothing to read.

A run: set-up (the driver's pool and warm-up), a closed-loop window of at
least `--seconds` and whole passes over the pool, with `--trace 1` a
profiled slice of a few more items after it, the peak memory, then the
reference check of the window's answers, and one JSON line on standard
output.  The reference's own seconds in set-up (its checks of the pool's
endpoints) are kept out of `setup_s`.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np

PLANBENCH = Path(__file__).resolve().parent
ROOT = PLANBENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "vamp_mvt_tpu")


class HarnessError(RuntimeError):
    """A run that cannot give a result."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """Import one file by its path (file names may hold dots)."""
    if not path.is_file():
        raise HarnessError(f"missing {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is JAX's
    or the JAX package's, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)


class Cell:
    """Everything one cell's run reads, found by name from BENCHMARK.json."""

    def __init__(self, name: str, manifest: dict | None = None, root: Path = ROOT):
        self.manifest = manifest if manifest is not None else load_json(root / "BENCHMARK.json")
        by_name = {w["name"]: w for w in self.manifest["workloads"]}
        if name not in by_name:
            raise HarnessError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.workload = by_name[name]
        entry = {c["name"]: c for c in self.manifest["configs"]}[self.workload["config"]]
        self.root = root
        self.config = load_json(root / entry["file"])
        self.traffic = load_json(root / "planbench" / "traffic"
                                 / f"{self.workload['traffic']}.json")
        self.limits = load_json(root / "planbench" / "cells" / f"{name}.json")
        self.chips = int(self.workload["chips"])

    def metrics(self, trace: bool) -> list[dict]:
        """This cell's end-to-end metrics (trace False) or per-layer ones."""
        group = self.manifest["per_layer" if trace else "end_to_end"]
        return [m for m in group if "workloads" not in m or self.name in m["workloads"]]

    def driver(self):
        return load_module(self.root / "planbench" / "drivers" / f"{self.traffic['driver']}.py",
                           f"planbench_driver_{self.traffic['driver']}")


def reader(name: str, root: Path = ROOT):
    return load_module(root / "planbench" / "metrics" / f"{name}.py",
                       "planbench_metric_" + name.replace(".", "_")).read


class Run:
    """One run's record: what the driver did in the window and after it,
    read by the metric readers."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool, device,
                 t_process: float):
        self.cell, self.seed, self.seconds, self.trace = cell, seed, seconds, trace
        self.device = device
        self.t_process = t_process
        self.items: list[dict] = []        # the window's items, in order
        self.trace_items: list[dict] = []  # the profiled slice's items
        self.t_window = self.t_end = 0.0
        self.setup_s = 0.0
        self.profiling = False
        self.device_trace: dict | None = None
        self.spans: list[tuple] = []        # (name, t0, t1) on the host clock

    @contextlib.contextmanager
    def span(self, name: str):
        """A host span around a call into the program; under the profiler
        also a labelled range in its trace."""
        t0 = time.perf_counter()
        if self.profiling:
            import torch

            with torch.profiler.record_function("pb:" + name):
                yield
        else:
            yield
        self.spans.append((name, t0, time.perf_counter()))

    @property
    def window_s(self) -> float:
        return self.t_end - self.t_window


def fresh_peak(device) -> None:
    """Forget the memory the reference took while the pool was made, so that
    the peak the run reports is the program's (its warm-up and window)."""
    import torch

    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def window(run: Run, drv) -> None:
    """Closed loop: items one after another until `seconds` have passed and
    a pass over the pool has ended, so that every window holds whole passes
    (the same work for every seed)."""
    sync(run.device)
    run.t_window = time.perf_counter()
    while True:
        run.items.append(drv.step(run))
        elapsed = time.perf_counter() - run.t_window
        if elapsed >= run.seconds and len(run.items) % drv.pool_len == 0:
            break
    run.t_end = run.items[-1]["t1"]


def traced_slice(run: Run, drv) -> None:
    """The profiled slice after the window: `trace_items` more items under
    torch.profiler, then the device's busy time and the host's idle gaps."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from planbench import tracing

    n = int(run.cell.traffic.get("trace_items", 1))
    sync(run.device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run.profiling = True
        with torch.profiler.record_function("pb:slice"):
            t0 = time.perf_counter()
            for _ in range(n):
                run.trace_items.append(drv.step(run))
            sync(run.device)
            t1 = time.perf_counter()
        run.profiling = False
    run.device_trace = tracing.summarize(prof.events(), t1 - t0, n)


def execute(cell: Cell, seed: int, seconds: float, trace: bool, device, t_process: float,
            control: bool = False) -> dict:
    """One run; returns the result object (without printing it).  With
    `control`, the verdict also holds the control's readings (the reference
    in bfloat16 in the program's place) on the same decisions."""
    import torch

    from planbench.reference import check
    from planbench.reference import robot as ref_robot

    run = Run(cell, seed, seconds, trace, device, t_process)
    run.robot = ref_robot.load(cell.config["robot"])
    drv = cell.driver().Driver(run)
    t_setup, ref_s = time.perf_counter(), check.SECONDS
    drv.setup(run)
    sync(device)
    ref_s = check.SECONDS - ref_s
    run.setup_parts = {"before_setup_s": t_setup - t_process,
                       "driver_setup_s": time.perf_counter() - t_setup,
                       "reference_in_setup_s": ref_s}
    window(run, drv)
    run.setup_s = run.t_window - t_process - ref_s
    if trace:
        traced_slice(run, drv)
    found = forbidden_modules()
    if found:
        raise HarnessError("the run loaded " + ", ".join(found))
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    metrics = {}
    for m in cell.metrics(trace):
        value = reader(m["name"], cell.root)(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    if device.type == "cuda":
        torch.cuda.empty_cache()
    dec, scene = drv.decisions(run, np.random.default_rng(
        np.random.SeedSequence([seed % (1 << 63), 7])))
    verdict = check.judge(run.robot, dec, scene, device)
    attempted, failed, valid = drv.tally(run)
    verdict["unsolved_valid_pct"] = 100.0 * failed / max(valid, 1)
    compared, correct = compare(verdict, cell.limits["limits"])
    if control:
        verdict["control"] = check.judge(run.robot, dec, scene, device, control=True)
        verdict["control"]["unsolved_valid_pct"] = verdict["unsolved_valid_pct"]
        run.decisions = (dec, scene)
    result = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
              "metrics": metrics, "device": device_info(device, peak, run)}
    if trace and run.device_trace is not None:
        result["breakdown"] = run.device_trace["breakdown"]
    result["compared"] = compared
    result["_verdict"] = verdict
    result["_run"] = run
    return result


def compare(verdict: dict, limits: dict) -> tuple[dict, bool]:
    """Each compared number beside its limit, and whether all are within."""
    compared = {k: {"value": verdict[k], "limit": float(lim)} for k, lim in limits.items()}
    return compared, all(c["value"] <= c["limit"] for c in compared.values())


def device_info(device, peak: int, run: Run) -> dict:
    import torch

    if device.type != "cuda":
        info = {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    else:
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": run.cell.chips, "memory_peak_bytes": int(peak)}
    if run.trace and run.device_trace is not None:
        info["busy_s"] = run.device_trace["busy_s"]
        info["window_s"] = run.device_trace["window_s"]
    return info
