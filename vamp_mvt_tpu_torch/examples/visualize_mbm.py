"""Visualize an MBM problem and a planned path (reference scripts/visualize_mbm.py).

Port of `examples/visualize_mbm.py`: loads one MotionBenchMaker problem,
builds its environment (primitives, or with --pointcloud an MVT / CAPT
cloud), plans with the chosen planner of the user API, simplifies, and
renders through the port's `visualize.py`: a matplotlib workspace plot (the
path's end-effector trace through the scene) and a per-joint trajectory
plot, and with --pybullet URDF a PyBullet animation.  Problems come from
`mbm.load_problems(robot)` (the tarball, which needs PyYAML, or its cached
parse); the plots need matplotlib.  Plans on the GPU unless --device (or
`device`) names another.

    python -m vamp_mvt_tpu_torch.examples.visualize_mbm [--problem NAME] [--index I]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--robot", default="panda")
    ap.add_argument("--planner", default="rrtc", choices=["rrtc", "prm", "fcit", "aorrtc"])
    ap.add_argument("--problem", default="bookshelf_small")
    ap.add_argument("--index", type=int, default=1)
    ap.add_argument("--pointcloud", action="store_true")
    ap.add_argument("--pc_repr", default="mvt", choices=["mvt", "capt"])
    ap.add_argument("--filter_type", default="scdf", choices=["scdf", "centervox"])
    ap.add_argument("--samples_per_object", type=int, default=10000)
    ap.add_argument("--out", default=None, help="output image path prefix")
    ap.add_argument("--pybullet", default=None, metavar="URDF",
                    help="animate in PyBullet with this robot URDF")
    ap.add_argument("--device", default=None, help="default: the GPU")
    return ap.parse_args(argv)


def main(argv=None, device=None) -> dict:
    """Prints what the JAX script prints; returns {"solved", "path" (the
    simplified path's vertices), "images"} ({"solved": False} when the
    planner fails, where the JAX script returns 1)."""
    from vamp_mvt_tpu_torch import api, visualize
    from vamp_mvt_tpu_torch.bench import mbm
    from vamp_mvt_tpu_torch.device import resolve_device
    from vamp_mvt_tpu_torch.pointcloud import pipeline

    args = parse_args(argv)
    dev = resolve_device(args.device if device is None else device)
    data = mbm.load_problems(args.robot)
    plist = data["problems"][args.problem]
    problem = next(p for p in plist if p["index"] == args.index)

    module = api.RobotModule(args.robot)
    filtered = None
    if args.pointcloud:
        builder, _, filtered, filter_ns, build_ns = pipeline.problem_to_pointcloud_env(
            args.robot, problem, pc_repr=args.pc_repr,
            samples_per_object=args.samples_per_object, filter_type=args.filter_type,
            kernel_pc=dev.type == "cuda")
        print(f"filter {filter_ns/1e6:.2f} ms, {args.pc_repr} build "
              f"{build_ns/1e6:.2f} ms, {len(filtered)} points")
        env = builder
    else:
        env = mbm.problem_to_builder(problem)

    res = getattr(module, args.planner)(problem["start"], problem["goals"], env, device=dev)
    if not bool(res.solved):
        print("problem not solved within budget")
        return {"solved": False}
    simp = module.simplify(res.path, res.path_length, env, device=dev)
    L = int(simp.path_length)
    path = np.asarray(simp.path.cpu().numpy())[:L]
    print(f"solved: cost {float(res.cost):.3f} -> {float(simp.cost):.3f}, {L} vertices")

    prefix = args.out or str(Path.cwd() / f"mbm_{args.robot}_{args.problem}_{args.index}")
    # one helper call: problem scene + solved path (+ pointcloud overlay)
    visualize.render_problem(args.robot, problem, path=path, pointcloud=filtered,
                             out_path=prefix + "_workspace.png", device=dev)
    visualize.plot_joint_trajectories(path, L, out_path=prefix + "_joints.png")
    print(f"wrote {prefix}_workspace.png, {prefix}_joints.png")

    if args.pybullet:
        sim = visualize.PyBulletVisualizer(args.pybullet, gui=True)
        sim.add_environment_from_problem_dict(problem)
        if args.pointcloud:
            sim.draw_pointcloud(filtered)
        sim.animate(path)
    return {"solved": True, "path": path,
            "images": [prefix + "_workspace.png", prefix + "_joints.png"]}


if __name__ == "__main__":
    main()
