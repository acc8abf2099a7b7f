"""A/B of the planner megakernel's two connect cadences on one suite.

    python -m vamp_mvt_tpu_torch.bench.interleave [robot] [batch_size]
        [--source auto|cages|mbm_shaped] [--device cuda] [--planner mega]
        [--max-problems N]

The counterpart of the JAX package's `tools/bench_interleave.py`: runs
`run_suite(robot, settings=...)` twice with the same settings except
`interleave` (False: grow and connect steps alternate; True: the grow part
runs every step and an active connect chain advances in the same step), and
prints for each problems/s, solved / valid, median simplified cost, median
samples and the plan and simplify walls, then the speedup and the cost
delta, and last one JSON line with both summaries and the problem source.

The settings are the tool's (range of the robot, budget 4096, max_path 96,
K 16, C 8, W 4) except max_samples: 16384 node rows instead of the tool's
2048, because the port's mega path refuses a 32x retry that a problem
filling 2048 rows within the first budget would fill again
(`mbm._check_retry_room`); 16384 is `run_suite`'s own (`default_settings`).
The problems are the robot's MBM suite where its problem file is present,
else seeded stand-ins (`bench.__main__.load_suite`).  A run that the suite
runner's retry guard refuses (a problem filled the node buffer within the
first budget, so the retry would replay the same search) is reported as
refused, with no speedup: under interleave=True a problem the search does
not solve keeps a connect chain active almost every step, and the loop runs
past the budget while one is active, so such a problem can fill the buffer.  planner="xla" runs
the lockstep planner, which ignores `interleave`: it checks the entry on a
machine without a GPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

from vamp_mvt_tpu_torch.bench import mbm
from vamp_mvt_tpu_torch.bench.__main__ import device_name, load_suite
from vamp_mvt_tpu_torch.device import resolve_device
from vamp_mvt_tpu_torch.planning import rrtc
from vamp_mvt_tpu_torch.robots import registry


def settings(robot: str) -> rrtc.RRTCSettings:
    """tools/bench_interleave.py's settings, at 16384 node rows."""
    return rrtc.RRTCSettings(range=registry.RRT_RANGES.get(robot, 1.0), max_iterations=4096,
                             max_samples=16384, max_path=96, samples_per_step=16,
                             connect_segments=8, sample_window=4)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("robot", nargs="?", default="panda")
    ap.add_argument("batch", nargs="?", type=int, default=700)
    ap.add_argument("--source", default="auto", choices=("auto", "cages", "mbm_shaped"))
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--planner", default="mega", choices=("mega", "xla"))
    ap.add_argument("--max-problems", type=int, default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n = args.max_problems or args.batch
    data, names, source = load_suite(args.robot, n, args.source, dev)

    rows = {}
    for inter in (False, True):
        try:
            res = mbm.run_suite(args.robot, problem_names=names, max_problems=args.max_problems,
                                settings=dataclasses.replace(settings(args.robot),
                                                             interleave=inter),
                                batch_size=args.batch, planner=args.planner, data=data,
                                device=dev)
        except ValueError as e:
            if "cannot hold" not in str(e):
                raise
            rows[inter] = {"refused": str(e)}
            print(f"interleave={inter}: refused: {e}", flush=True)
            continue
        summ = res.summary()
        rows[inter] = summ
        cost, samples = summ["median_simplified_cost"], summ["median_iterations"]
        print(f"interleave={inter}: {summ['problems_per_sec']:8.1f} problems/s  "
              f"solved {summ['solved_problems']}/{summ['valid_problems']}  "
              f"median cost {cost if cost is None else f'{cost:.3f}'}  "
              f"median samples {samples if samples is None else f'{samples:.0f}'}  "
              f"plan {summ['plan_wall_s']:.3f}s simp {summ['simplify_wall_s']:.3f}s", flush=True)
    a, b = rows[False], rows[True]
    ran = "refused" not in a and "refused" not in b
    speedup = b["problems_per_sec"] / a["problems_per_sec"] if ran else None
    delta = (b["median_simplified_cost"] - a["median_simplified_cost"]
             if ran and None not in (a["median_simplified_cost"], b["median_simplified_cost"])
             else None)
    print(f"speedup: {speedup if speedup is None else f'{speedup:.3f}x'}  cost delta: "
          f"{delta if delta is None else f'{delta:+.4f}'}", flush=True)
    line = {"robot": args.robot, "source": source, "planner": args.planner,
            "device": device_name(dev), "alternating": a, "interleaved": b,
            "speedup": speedup, "cost_delta": delta}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
