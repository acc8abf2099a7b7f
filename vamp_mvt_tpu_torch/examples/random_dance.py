"""Random replanning smoke test (reference scripts/random_dance.py): plan
between random valid configurations in the sphere cage, repeatedly.

Port of `examples/random_dance.py`, through the user API.

    python -m vamp_mvt_tpu_torch.examples.random_dance [rounds] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

import vamp_mvt_tpu_torch as vmt
from vamp_mvt_tpu_torch.examples.sphere_cage_example import CAGE


def main(rounds: int = 5, device=None) -> list[dict]:
    env = vmt.Environment()
    for c in CAGE:
        env.add_sphere(vmt.Sphere(c, 0.2))
    spec = vmt.panda.spec
    rng = np.random.default_rng(0)

    def random_valid():
        while True:
            q = rng.uniform(spec.limits_low, spec.limits_high)
            if vmt.panda.validate(q, env, device=device):
                return q

    cur = random_valid()
    out = []
    for i in range(rounds):
        goal = random_valid()
        res = vmt.panda.rrtc(cur, goal, env, device=device)
        solved = bool(res.solved)
        print(f"round {i}: {'ok' if solved else 'FAILED'} cost={float(res.cost):.2f}")
        out.append({"solved": solved, "cost": float(res.cost),
                    "path_length": int(res.path_length)})
        if solved:
            cur = goal
    return out


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("rounds", type=int, nargs="?", default=5)
    p.add_argument("--device", default=None)
    a = p.parse_args()
    main(a.rounds, device=a.device)
