"""MPNet-vs-MBM evaluation (reference scripts/evaluate_mbm_mpnet.py).

Port of `examples/evaluate_mbm_mpnet.py`: the MPNet neural planner
(`planning/mpnet.py::plan_with_mpnet`) over MotionBenchMaker problems with
pointcloud (MVT or CAPT) environments (on the GPU with the kernel form the
fkcc kernel reads), with RRT-Connect fallback
accounting; prints per-problem results and an aggregate.  Without
checkpoints the MLPs run with the seeded initial weights (which exercises
the pipeline only); --encoder/--planner load torch state dicts, e.g. those
`python -m vamp_mvt_tpu_torch.tools.train_mpnet` saves.  Problems come from
`mbm.load_problems(robot)` (the tarball, which needs PyYAML, or its cached
parse).  Runs on the GPU unless --device (or `device`) names another.

    python -m vamp_mvt_tpu_torch.examples.evaluate_mbm_mpnet [--problem NAME ...]
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--robot", default="panda")
    ap.add_argument("--problem", nargs="*", default=["bookshelf_small"])
    ap.add_argument("--index", type=int, nargs="*", default=None)
    ap.add_argument("--max_problems", type=int, default=10)
    ap.add_argument("--encoder", default=None, help="encoder state-dict path")
    ap.add_argument("--planner", default=None, help="planner state-dict path")
    ap.add_argument("--pc_repr", default="mvt", choices=["mvt", "capt"])
    ap.add_argument("--filter_type", default="scdf", choices=["scdf", "centervox"])
    ap.add_argument("--samples_per_object", type=int, default=10000)
    ap.add_argument("--no_fallback", action="store_true")
    ap.add_argument("--device", default=None, help="default: the GPU")
    return ap.parse_args(argv)


def main(argv=None, device=None) -> dict:
    """Prints what the JAX script prints; returns {"rows": [{"problem",
    "index", "method", "cost", "ms", "path"}, ...], "solved", "neural"}."""
    from vamp_mvt_tpu_torch.bench import mbm
    from vamp_mvt_tpu_torch.device import resolve_device
    from vamp_mvt_tpu_torch.planning import mpnet
    from vamp_mvt_tpu_torch.pointcloud import pipeline

    args = parse_args(argv)
    dev = resolve_device(args.device if device is None else device)
    data = mbm.load_problems(args.robot)
    rows = []
    for pname in args.problem:
        plist = data["problems"][pname]
        if args.index:
            plist = [p for p in plist if p["index"] in args.index]
        for problem in plist[: args.max_problems]:
            builder, _, filtered, _, _ = pipeline.problem_to_pointcloud_env(
                args.robot, problem, pc_repr=args.pc_repr,
                samples_per_object=args.samples_per_object, filter_type=args.filter_type,
                kernel_pc=dev.type == "cuda")
            t0 = time.perf_counter()
            path, mode = mpnet.plan_with_mpnet(
                args.robot, problem["start"], problem["goals"][0], builder, filtered,
                encoder_path=args.encoder, planner_path=args.planner,
                rrtc_fallback=not args.no_fallback, device=dev)
            dt = time.perf_counter() - t0
            cost = (sum(float(np.linalg.norm(np.asarray(b) - np.asarray(a)))
                        for a, b in zip(path[:-1], path[1:]))
                    if path is not None and len(path) >= 2 else float("inf"))
            rows.append({"problem": pname, "index": problem["index"], "method": mode,
                         "cost": cost, "ms": dt * 1e3, "path": path})
            print(f"{pname}[{problem['index']}]: {mode} cost={cost:.3f} {dt*1e3:.1f} ms")

    solved = [r for r in rows if r["method"] in ("mpnet", "rrtc_fallback")]
    neural = [r for r in rows if r["method"] == "mpnet"]
    print(f"\n{len(solved)}/{len(rows)} solved "
          f"({len(neural)} purely neural, "
          f"{len(solved) - len(neural)} via RRTC fallback)")
    if solved:
        print(f"median cost {np.median([r['cost'] for r in solved]):.3f}, "
              f"median wall {np.median([r['ms'] for r in solved]):.1f} ms")
    return {"rows": rows, "solved": len(solved), "neural": len(neural)}


if __name__ == "__main__":
    main()
