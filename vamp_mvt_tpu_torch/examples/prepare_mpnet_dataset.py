"""Dump MPNet training data (reference scripts/prepare_mpnet_dataset.py): per
problem, the filtered pointcloud and an RRT-Connect + simplify solution path.

Port of `examples/prepare_mpnet_dataset.py`.  Each problem of
`mbm.load_problems(robot)["problems"][--problem]` (the tarball, which needs
PyYAML, or its cached parse) gets its pointcloud environment
(`problem_to_pointcloud_env`: MVT, and on the GPU the kernel form the fkcc
kernel reads), is planned by the
user API's `rrtc` and simplified on it; a solved problem is written as
`<problem>_<i>.npz` (pointcloud, path, start, goal), an unsolved one is
skipped.  Runs on the GPU unless --device (or `device`) names another.

    python -m vamp_mvt_tpu_torch.examples.prepare_mpnet_dataset [--count 10] [--out DIR]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--robot", default="panda")
    ap.add_argument("--problem", default="cage")
    ap.add_argument("--count", type=int, default=10)
    ap.add_argument("--out", default="/tmp/mpnet_dataset")
    ap.add_argument("--samples_per_object", type=int, default=2000)
    ap.add_argument("--device", default=None, help="default: the GPU")
    return ap.parse_args(argv)


def main(argv=None, device=None) -> dict:
    """Prints the JAX script's JSON line; returns it with "files", the paths
    written in order."""
    from vamp_mvt_tpu_torch import api
    from vamp_mvt_tpu_torch.bench import mbm
    from vamp_mvt_tpu_torch.device import resolve_device
    from vamp_mvt_tpu_torch.pointcloud import pipeline

    args = parse_args(argv)
    dev = resolve_device(args.device if device is None else device)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    data = mbm.load_problems(args.robot)
    module = api.RobotModule(args.robot)
    files = []
    for i, prob in enumerate(data["problems"][args.problem][: args.count]):
        b, _orig, filt, _, _ = pipeline.problem_to_pointcloud_env(
            args.robot, prob, pc_repr="mvt", samples_per_object=args.samples_per_object,
            kernel_pc=dev.type == "cuda")
        env = b.build(device=dev)
        res = module.rrtc(prob["start"], prob["goals"], env, device=dev)
        if not bool(res.solved):
            continue
        simple = module.simplify(res.path, res.path_length, env, device=dev)
        L = int(simple.path_length)
        f = out / f"{args.problem}_{i}.npz"
        np.savez(f, pointcloud=np.asarray(filt, np.float32),
                 path=simple.path[:L].cpu().numpy(),
                 start=np.asarray(prob["start"], np.float32),
                 goal=np.asarray(prob["goals"][0], np.float32))
        files.append(str(f))
    line = {"written": len(files), "dir": str(out)}
    print(json.dumps(line))
    return line | {"files": files}


if __name__ == "__main__":
    main()
