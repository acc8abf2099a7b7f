"""Seeded MotionBenchMaker-shaped scenes and valid endpoints in them.

The MotionBenchMaker problem files are not in the repository, so the card
checks (`chip_smoke.py`) and the parity tests plan on seeded scenes with
MotionBenchMaker's object counts and kinds, start and goal the first two of
a set of seeded configurations that the collision check finds valid there.
"""

from __future__ import annotations

import numpy as np
import torch

from vamp_mvt_tpu_torch.bench import mbm
from vamp_mvt_tpu_torch.bench.mbm import STANDARD_SCENARIOS
from vamp_mvt_tpu_torch.planning import validate
from vamp_mvt_tpu_torch.robots import registry


def mbm_shaped_problems(n: int, seed: int) -> list[dict]:
    """Seeded scenes with MotionBenchMaker's object counts and kinds: a few
    spheres, cylinders (some z-aligned; the 'box' scenario turns them into
    cuboids) and boxes (some rotated only about z) in front of the Panda.
    The first k scenes of a call do not depend on n."""
    spec = registry.load("panda")
    rng = np.random.default_rng(seed)
    lo, hi = np.array([0.2, -0.6, 0.0]), np.array([0.9, 0.6, 1.2])
    problems = []
    for i in range(n):
        p = {"problem": STANDARD_SCENARIOS[i % len(STANDARD_SCENARIOS)], "index": i,
             "sphere": [], "cylinder": [], "box": [],
             "start": rng.uniform(spec.limits_low, spec.limits_high).tolist(),
             "goals": [rng.uniform(spec.limits_low, spec.limits_high).tolist()]}
        for _ in range(rng.integers(1, 4)):
            p["sphere"].append({"position": rng.uniform(lo, hi).tolist(),
                                "radius": float(rng.uniform(0.03, 0.12))})
        for j in range(rng.integers(2, 7)):
            e = rng.uniform(-np.pi, np.pi, 3) if j % 2 else np.zeros(3)
            p["cylinder"].append({"position": rng.uniform(lo, hi).tolist(),
                                  "orientation_euler_xyz": e.tolist(),
                                  "radius": float(rng.uniform(0.02, 0.06)),
                                  "length": float(rng.uniform(0.1, 0.4))})
        for j in range(rng.integers(4, 17)):
            e = (rng.uniform(-np.pi, np.pi, 3) if j % 3
                 else np.array([0.0, 0.0, rng.uniform(-np.pi, np.pi)]))
            p["box"].append({"position": rng.uniform(lo, hi).tolist(),
                             "orientation_euler_xyz": e.tolist(),
                             "half_extents": rng.uniform(0.02, 0.3, 3).tolist()})
        problems.append(p)
    return problems


def seeded_configs(spec, n_scenes: int, n_configs: int, seed: int, device=None) -> torch.Tensor:
    """(n_scenes, n_configs, d) float32 configurations drawn uniformly within
    the robot's limits.  The first k scenes' rows do not depend on n_scenes."""
    q = np.random.default_rng(seed).uniform(spec.limits_low, spec.limits_high,
                                            (n_scenes, n_configs, spec.dimension))
    return torch.as_tensor(q.astype(np.float32), device=device)


def first_two_valid(q: torch.Tensor, ok: torch.Tensor, keep: int | None = None):
    """The first `keep` (every one when None) problems that have two
    configurations of q (B, N, d) that `ok` (B, N) calls valid, and the
    first two as start and goal: (rows, starts (R, d), goals (R, 1, d),
    masks (R, 1))."""
    ok_np = ok.cpu().numpy()
    rows = [i for i in range(len(ok_np)) if ok_np[i].sum() >= 2][:keep]
    first2 = [np.flatnonzero(ok_np[i])[:2] for i in rows]
    st = torch.stack([q[i, j[0]] for i, j in zip(rows, first2)])
    gl = torch.stack([q[i, j[1]] for i, j in zip(rows, first2)])[:, None]
    return rows, st, gl, torch.ones((len(rows), 1), dtype=torch.bool, device=q.device)


def mbm_shaped_suite(robot: str, n: int, seed: int = 1, n_configs: int = 1024,
                     device=None) -> dict:
    """A suite of `n` problems for `robot` in the MBM data layout (problem
    kind "mbm_shaped"): the first `n` MBM-shaped scenes (seed `seed`) in
    which two of `n_configs` seeded configurations (seed `seed + 1`) are
    valid, those two as start and goal.  Scenes are drawn in rounds of
    doubling size until `n` qualify; the first k problems do not depend on
    `n`.  The check runs on `device` (default: the GPU)."""
    spec = registry.load(robot)
    pool = n
    while True:
        scenes = mbm_shaped_problems(pool, seed)
        envs = mbm.build_batch(scenes, device=device)[0]
        q = seeded_configs(spec, pool, n_configs, seed + 1, envs.spheres.device)
        ok = validate.fkcc_valid(spec, envs, q)
        if int((ok.sum(1) >= 2).sum()) >= n:
            break
        pool *= 2
    rows, st, gl, _ = first_two_valid(q, ok, keep=n)
    problems = [dict(scenes[r], start=s_, goals=[g_])
                for r, s_, g_ in zip(rows, st.tolist(), gl[:, 0].tolist())]
    return {"robot": robot, "joints": list(spec.joint_names),
            "problems": {"mbm_shaped": problems}}
