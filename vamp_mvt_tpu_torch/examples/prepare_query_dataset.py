"""Dump filtered clouds and collision queries for comparison with external
nearest-neighbour libraries (reference scripts/prepare_nanoflann_dataset.py).

Port of `examples/prepare_query_dataset.py`: for each problem, the filtered
pointcloud (`problem_to_pointcloud_env`, MVT, 2000 samples an object) and
the robot's collision spheres at 64 configurations drawn uniformly within
its limits (`default_rng(0)`, one stream over all problems), each sphere
with its radius and whether it collides with the cloud
(`collision/mvt.py::mvt_collides`), written as `<problem>_<i>.npz`.
Problems come from `mbm.load_problems(robot)` (the tarball, which needs
PyYAML, or its cached parse).  Runs on the GPU unless --device (or
`device`) names another.

    python -m vamp_mvt_tpu_torch.examples.prepare_query_dataset [--count 5] [--out DIR]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--robot", default="panda")
    ap.add_argument("--problem", default="cage")
    ap.add_argument("--count", type=int, default=5)
    ap.add_argument("--out", default="/tmp/query_dataset")
    ap.add_argument("--device", default=None, help="default: the GPU")
    return ap.parse_args(argv)


def main(argv=None, device=None) -> dict:
    """Prints the JAX script's JSON line; returns it with "files", the paths
    written in order."""
    from vamp_mvt_tpu_torch.bench import mbm
    from vamp_mvt_tpu_torch.collision.mvt import mvt_collides
    from vamp_mvt_tpu_torch.device import resolve_device
    from vamp_mvt_tpu_torch.ops import fk
    from vamp_mvt_tpu_torch.pointcloud import pipeline
    from vamp_mvt_tpu_torch.robots import registry

    args = parse_args(argv)
    dev = resolve_device(args.device if device is None else device)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    spec = registry.load(args.robot)
    data = mbm.load_problems(args.robot)
    rng = np.random.default_rng(0)
    files = []
    for i, prob in enumerate(data["problems"][args.problem][: args.count]):
        b, _, filt, _, _ = pipeline.problem_to_pointcloud_env(
            args.robot, prob, pc_repr="mvt", samples_per_object=2000, kernel_pc=False)
        env = b.build(device=dev)
        qs = rng.uniform(spec.limits_low, spec.limits_high, (64, spec.dimension))
        with torch.no_grad():
            centers = fk.sphere_positions(
                spec, torch.as_tensor(qs, dtype=torch.float32, device=dev)).reshape(-1, 3)
            radii = np.tile(spec.sphere_radius, 64)
            hits = mvt_collides(env.mvt, centers,
                                torch.as_tensor(radii, dtype=torch.float32, device=dev))
        f = out / f"{args.problem}_{i}.npz"
        np.savez(f, pointcloud=np.asarray(filt, np.float32),
                 query_centers=centers.cpu().numpy().astype(np.float32),
                 query_radii=radii.astype(np.float32), collides=hits.cpu().numpy())
        files.append(str(f))
    line = {"written": args.count, "dir": str(out)}
    print(json.dumps(line))
    return line | {"files": files}


if __name__ == "__main__":
    main()
