"""The port's benchmark: plan and simplify 700 Panda problems on the card.

    python -m vamp_mvt_tpu_torch.bench [--device cuda] [--planner mega]
                                       [--max-problems 700]

The counterpart of the JAX package's `bench.py`: a warm run, then a timed
run, of `run_suite("panda", planner=..., timings=...)` over 700 problems.
The problems are the MBM Panda suite's seven standard scenarios where its
problem file is present (`mbm.RESOURCES`/panda/problems.tar.bz2), else the
700 seeded sphere cages of `mbm.cage_suite`.  Prints on stdout one JSON line,

    {"metric": "mbm_panda_problems_per_sec", "value": ..., "unit": "problems/s",
     "vs_baseline": ..., "source": ..., "problems": ..., "device": ...}

where `value` is the warm run's problems/s (plan and simplify) and
`vs_baseline` its ratio to the reference's 700 problems in 210.9 ms (one
7950X core, reference resources/README.md:147-148), given only for the MBM
suite the reference timed (null on the cages); then on stderr a JSON
`detail` line (the warm run's summary with the timed run's end-to-end wall
and phases) and the percentile table.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from vamp_mvt_tpu_torch.bench import mbm, scenes
from vamp_mvt_tpu_torch.device import resolve_device

PROBLEMS = 700
BASELINE_PROBLEMS_PER_SEC = 700 / 0.2109


def load_suite(robot: str, n: int, source: str = "auto", device=None):
    """(data, problem_names, source name) of the suite to run: with source
    "auto", the MBM suite of `robot` (its standard scenarios) where its
    problem file is present, else `n` seeded stand-ins: the sphere cages of
    `mbm.cage_suite` for the Panda, the MBM-shaped scenes of
    `scenes.mbm_shaped_suite` for the other robots (their endpoints checked
    on `device`); "cages" or "mbm_shaped" names a stand-in."""
    tar = mbm.RESOURCES / robot / "problems.tar.bz2"
    if source == "auto" and tar.exists():
        return mbm.load_problems(robot), list(mbm.STANDARD_SCENARIOS), f"mbm:{tar}"
    if source == "auto":
        source = "cages" if robot == "panda" else "mbm_shaped"
    if source == "cages":
        if robot != "panda":
            raise ValueError("the sphere cages are Panda problems")
        return mbm.cage_suite(n, seed=0), None, f"cage_suite({n}, seed=0)"
    if source == "mbm_shaped":
        return (scenes.mbm_shaped_suite(robot, n, device=device), None,
                f"mbm_shaped_suite({robot!r}, {n}, seed=1)")
    raise ValueError(f"unknown source {source!r}")


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--planner", default="mega", choices=("mega", "xla"))
    ap.add_argument("--max-problems", type=int, default=PROBLEMS)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    data, names, source = load_suite("panda", args.max_problems, device=dev)
    n = min(args.max_problems, sum(len(v) for k, v in data["problems"].items()
                                   if names is None or k in names))
    kw = dict(problem_names=names, max_problems=n, batch_size=n, planner=args.planner,
              data=data, device=dev)

    t0 = time.perf_counter()
    summary = mbm.run_suite("panda", **kw).summary()
    value = summary["problems_per_sec"]
    phases = {}
    t1 = time.perf_counter()
    res = mbm.run_suite("panda", warmup=False, timings=phases, **kw)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    e2e = time.perf_counter() - t1
    summary |= {"e2e_wall_s": e2e, "e2e_problems_per_sec": n / e2e, "e2e_phases": phases}

    line = {"metric": "mbm_panda_problems_per_sec", "value": value, "unit": "problems/s",
            "vs_baseline": value / BASELINE_PROBLEMS_PER_SEC if names else None,
            "source": source, "problems": n, "planner": args.planner,
            "device": device_name(dev)}
    print(json.dumps(line), flush=True)
    print(json.dumps({"detail": summary, "total_wall_s": time.perf_counter() - t0}),
          file=sys.stderr)
    print(res.percentile_table(), file=sys.stderr, flush=True)
    return line


if __name__ == "__main__":
    main()
