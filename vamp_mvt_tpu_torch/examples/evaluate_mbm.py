"""MBM evaluation CLI (reference scripts/evaluate_mbm.py): plan and simplify a
robot's MotionBenchMaker suite as batched device work.

Port of `examples/evaluate_mbm.py`, the command line of the main path,
`bench/mbm.py::run_suite` (or `run_suite_pointcloud` with --pointcloud).
Problems come from `mbm.load_problems(robot)` (the tarball under
VAMP_MVT_TPU_RESOURCES, which needs PyYAML, or its cached parse under
VAMP_MVT_TPU_CACHE), or from a pre-converted pickle with --problems_pkl.
Runs on the GPU unless --device (or `device`) names another.

    python -m vamp_mvt_tpu_torch.examples.evaluate_mbm --problems_pkl P [--table]
"""

from __future__ import annotations

import argparse
import json


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--robot", default="panda")
    ap.add_argument("--problem", nargs="*", default=None,
                    help="scenario names (default: the standard suite)")
    ap.add_argument("--problems_pkl", default=None,
                    help="pre-converted problem pickle (e.g. a robometrics "
                         "dataset) instead of the MBM tarball")
    ap.add_argument("--max_problems", type=int, default=None)
    ap.add_argument("--batch_size", type=int, default=700)
    ap.add_argument("--planner", default="auto", choices=["auto", "mega", "xla"])
    ap.add_argument("--table", action="store_true",
                    help="print the percentile table as well")
    ap.add_argument("--pointcloud", action="store_true",
                    help="plan against sampled pointclouds instead of "
                         "primitives (reference evaluate_mbm.py:106-136)")
    ap.add_argument("--pc_repr", default="capt", choices=["capt", "mvt"])
    ap.add_argument("--filter_type", default="scdf", choices=["scdf", "centervox"])
    ap.add_argument("--samples_per_object", type=int, default=10000)
    ap.add_argument("--device", default=None, help="default: the GPU")
    return ap.parse_args(argv)


def main(argv=None, device=None) -> dict:
    """Prints what the JAX script prints; returns {"summary": the printed
    dict, "suite": the SuiteResult, "table": the percentile table or None,
    "timings": run_suite_pointcloud's timings or None}."""
    from vamp_mvt_tpu_torch.bench import mbm

    args = parse_args(argv)
    device = args.device if device is None else device
    data = None
    names = args.problem
    if args.problems_pkl:
        data = mbm.load_problems_pkl(args.problems_pkl)
    elif names is None and args.robot == "panda":
        names = list(mbm.STANDARD_SCENARIOS)
    timings = None
    if args.pointcloud:
        res, timings = mbm.run_suite_pointcloud(
            args.robot, pc_repr=args.pc_repr, filter_type=args.filter_type,
            problem_names=names, max_problems=args.max_problems,
            batch_size=args.batch_size, data=data,
            samples_per_object=args.samples_per_object, device=device,
        )
        out = res.summary()
        for k in ("filter_median_ms", "build_median_ms", "pc_repr", "filter_type"):
            out[k] = timings[k]
    else:
        res = mbm.run_suite(
            args.robot, problem_names=names, max_problems=args.max_problems,
            batch_size=args.batch_size, planner=args.planner, data=data, device=device,
        )
        out = res.summary()
    print(json.dumps(out, indent=2))
    table = res.percentile_table() if args.table else None
    if table is not None:
        print(table)
    return {"summary": out, "suite": res, "table": table, "timings": timings}


if __name__ == "__main__":
    main()
