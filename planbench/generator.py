"""The one traffic generator: seeded MotionBenchMaker-shaped problems for
the configuration's robot.

Scenes are a frozen copy of the port's `bench/scenes.py::mbm_shaped_problems`
(MotionBenchMaker's object counts and kinds: 1-3 spheres, 2-6 cylinders and
4-16 boxes in front of the robot, the seven scenario names in turn).  Every
object's centre is drawn in the configuration's `scene_box`, `[[x0, y0, z0],
[x1, y1, z1]]` in metres in the robot's base frame; without one, in the
Panda's workspace (`PANDA_BOX`, the port's own box).  The endpoints are the
benchmark's own, checked by the plain reference (`reference/`), never by the
program:

- start and goal: the first two of a problem's `DRAWS` uniform draws within
  the joint limits that the reference finds free.  Nothing else shapes them:
  a problem the planner cannot solve in its budget stays in the pool, and
  counts as failed in every run;
- `invalid` problems of each pool get a goal in contact instead (MBM's Panda
  suite has one such problem in 700).

Against a cloud (`obstacles: "cloud"`) the spheres are left out, since a
cloud samples none, and the cylinders and boxes are grown by `pad` (the point
radius and a margin), so that a state free of the grown shapes is free of
any point sampled on their surfaces.

The traffic file gives `problems` a pool item, `pool` items, `invalid` a
pool item, and `pool_seed` where the pool is fixed (the run's seed then
orders it); otherwise the pool comes from the run's seed.
"""

from __future__ import annotations

import numpy as np
import torch

from planbench.reference import check, geometry

# uniform draws a problem, checked at once: enough that a scene with any
# free room gives two
DRAWS = 32

# where the objects of a configuration without a `scene_box` go: the port's
# box in front of the Panda
PANDA_BOX = ((0.2, -0.6, 0.0), (0.9, 0.6, 1.2))

SCENARIOS = ("bookshelf_small", "bookshelf_tall", "bookshelf_thin", "box", "cage",
             "table_pick", "table_under_pick")


def mbm_shaped_problems(n: int, seed: int, low, high, box=PANDA_BOX) -> list[dict]:
    """Frozen copy of the port's bench/scenes.py::mbm_shaped_problems (the
    same draws in the same order, so the same scenes for the same seed), with
    the objects' centres drawn in `box` (the port's at the default)."""
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(box, dtype=np.float64)
    problems = []
    for i in range(n):
        p = {"problem": SCENARIOS[i % len(SCENARIOS)], "index": i,
             "sphere": [], "cylinder": [], "box": [],
             "start": rng.uniform(low, high).tolist(),
             "goals": [rng.uniform(low, high).tolist()]}
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


def scene_obstacles(problems, kind: str, pad: float) -> list[dict]:
    """The obstacle rows endpoints are checked against: the primitives, or,
    for a cloud, the cylinders and boxes grown by `pad`."""
    if kind == "cloud":
        return [geometry.obstacles(p, pad=pad, spheres=False) for p in problems]
    return [geometry.obstacles(p) for p in problems]


def endpoints(robot, problems, obs, rng, device, invalid: int, within: int):
    """Give each problem a start and a goal as the module says; returns the
    problems that got them (those with fewer than two free draws are
    dropped).  The `invalid` problems are drawn among the first `within`."""
    d = robot.dimension
    low, high = np.asarray(robot.low), np.asarray(robot.high)
    n = len(problems)
    q = rng.uniform(low, high, (n, DRAWS, d))
    rows = np.repeat(np.arange(n), DRAWS)
    v = check.values(robot, q.reshape(-1, d), rows, ("obstacles", obs), torch.float64,
                     device).reshape(n, DRAWS)
    free = v >= 0
    within = min(within, n)
    bad = (set(rng.choice(within, size=min(invalid, within), replace=False).tolist())
           if invalid else set())
    out = []
    for i in range(n):
        ok = np.flatnonzero(free[i])
        if len(ok) < 2:
            continue
        if i in bad:
            if free[i].all():
                continue
            # a goal clearly in contact: the first below -0.01 m^2, else the deepest
            deep = np.flatnonzero(v[i] < -0.01)
            goal = q[i, deep[0] if len(deep) else int(np.argmin(v[i]))]
        else:
            goal = q[i, ok[1]]
        out.append(dict(problems[i], start=q[i, ok[0]].tolist(), goals=[goal.tolist()]))
    return out


def seed_seq(*parts) -> np.random.SeedSequence:
    return np.random.SeedSequence([int(p) % (1 << 63) for p in parts])


def pool(robot, traffic: dict, config: dict, seed: int, device) -> list[list[dict]]:
    """`traffic["pool"]` items of `traffic["problems"]` problems each."""
    n, items = int(traffic["problems"]), int(traffic["pool"])
    base = int(traffic["pool_seed"]) if "pool_seed" in traffic else seed
    kind = config["obstacles"]
    pad = float(config.get("pad", 0.0))
    box = np.asarray(config.get("scene_box", PANDA_BOX), dtype=np.float64)
    if box.shape != (2, 3) or not (box[0] < box[1]).all():
        raise ValueError("scene_box is [[x0, y0, z0], [x1, y1, z1]] with each low below "
                         f"its high; got {config['scene_box']!r}")
    out = []
    for k in range(items):
        ss = seed_seq(base, k)
        scene_seed, draw_seed = (int(s.generate_state(1)[0]) for s in ss.spawn(2))
        rng = np.random.default_rng(draw_seed)
        got: list[dict] = []
        m = 0
        while len(got) < n:
            want = n - len(got)
            extra = mbm_shaped_problems(m + want + want // 4 + 4, scene_seed,
                                        robot.low, robot.high, box)[m:]
            m += len(extra)
            obs = scene_obstacles(extra, kind, pad)
            got += endpoints(robot, extra, obs, rng, device,
                             invalid=int(traffic.get("invalid", 0)) if not got else 0,
                             within=want)
            if m > 50 * n + 100:
                raise RuntimeError("the scenes give too few problems with valid endpoints")
        got = got[:n]
        for i, p in enumerate(got):
            p["index"] = i
        out.append(got)
    return out


def as_suite(problems: list[dict], robot: str) -> tuple[dict, list[dict]]:
    """A pool item in the MBM data layout that run_suite reads, for `robot`
    (its name), and its problems in the order of run_suite's result rows."""
    by: dict = {}
    for p in problems:
        by.setdefault(p["problem"], []).append(p)
    return {"robot": robot, "problems": by}, [p for ps in by.values() for p in ps]
