"""PRM roadmap for an R^3 point robot over a PNG heightfield maze
(reference scripts/flying_sphere.py).

Port of `examples/flying_sphere.py`: the maze is `heightfields/maze.png`
under the reference's resources (`bench/mbm.py::RESOURCES`) when present,
else the JAX script's own obstacle row of nine spheres.

    python -m vamp_mvt_tpu_torch.examples.flying_sphere [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

import vamp_mvt_tpu_torch as vmt
from vamp_mvt_tpu_torch.bench import mbm
from vamp_mvt_tpu_torch.device import resolve_device
from vamp_mvt_tpu_torch.planning import prm
from vamp_mvt_tpu_torch.robots import registry

HEIGHTFIELD = mbm.RESOURCES / "heightfields" / "maze.png"


def main(max_samples: int = 2048, roadmap_samples: int = 512, device=None) -> dict:
    dev = resolve_device(device)
    spec = registry.sphere_spec(lows=(-5, -5, 0), highs=(5, 5, 5), radius=0.2)
    env = vmt.Environment()
    if HEIGHTFIELD.exists():
        meta, data = vmt.png_to_heightfield(HEIGHTFIELD, (0, 0, 0.5), (0.05, 0.05, 0.5))
        env.add_heightfield(meta, data)
    else:  # the JAX script's obstacle course
        for x in np.linspace(-4, 4, 9):
            env.add_sphere(vmt.Sphere([x, 0.0, 1.0], 0.4))

    start, goal = [-4.0, -4.0, 1.0], [4.0, 4.0, 1.0]
    res = prm.solve(
        spec, env.build(dev), start, [goal],
        prm.PRMSettings(max_samples=max_samples, wave=64,
                        neighbor_params=prm.PRMStarNeighborParams(3, spec.space_measure())),
        device=dev,
    )
    print("solved:", res.solved, "cost:", res.cost, "nodes:", res.size)
    rm = vmt.sphere.roadmap(start, goal, env,
                            prm.PRMSettings(max_samples=roadmap_samples, wave=64,
                                            neighbor_params=prm.PRMStarNeighborParams(
                                                3, spec.space_measure())),
                            device=dev)
    print("roadmap:", rm.vertices.shape[0], "vertices,", len(rm.edges), "edges")
    return {"maze_png": HEIGHTFIELD.exists(), "solved": bool(res.solved),
            "cost": float(res.cost), "nodes": int(res.size),
            "roadmap_vertices": int(rm.vertices.shape[0]), "roadmap_edges": len(rm.edges)}


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None)
    main(device=p.parse_args().device)
