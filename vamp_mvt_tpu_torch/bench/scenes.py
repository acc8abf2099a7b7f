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


# ---------------------------------------------------------------------------
# Payloads, terrains and mazes (the attachment and heightfield checks)
# ---------------------------------------------------------------------------

ATTACH_ROWS = 4  # payload rows a problem: 1-4 live, the rest radius 0
MAZE_META = ((0.0, 0.0, 0.5), (0.04, 0.04, 0.5))  # examples/flying_sphere.py's center, z scale


def payloads(n: int, seed: int, spec, device):
    """n seeded payloads (an Attachment of tensors, leading dim n): 1-4
    spheres 0.05-0.25 m along the EE axis under a seeded rotation about that
    axis and a seeded shift of up to 1 cm; radii 0.02 m up to the robot's
    largest class radius (below their class radius), and in one payload of
    ten above every class radius up to 0.15 m.  Each payload has ATTACH_ROWS
    rows: the rows past its spheres repeat its first at radius 0, which can
    lower no signed value."""
    from vamp_mvt_tpu_torch.collision import environment as envmod
    from vamp_mvt_tpu_torch.collision import pc_kernel

    top = float(pc_kernel.radius_classes(spec.sphere_radius)[-1])
    rng = np.random.default_rng(seed)
    sph = np.zeros((n, ATTACH_ROWS, 4), np.float32)
    rot = np.zeros((n, 3, 3), np.float32)
    pos = rng.uniform(-0.01, 0.01, (n, 3)).astype(np.float32)
    live = rng.integers(1, ATTACH_ROWS + 1, n)
    for i in range(n):
        a = live[i]
        sph[i, :a, 2] = rng.uniform(0.05, 0.25, a)
        sph[i, :a, 3] = rng.uniform(top + 0.005, 0.15, a) if i % 10 == 0 else \
            rng.uniform(0.02, top, a)
        sph[i, a:, :3] = sph[i, 0, :3]
        th = rng.uniform(-np.pi, np.pi)
        rot[i] = [[np.cos(th), -np.sin(th), 0.0], [np.sin(th), np.cos(th), 0.0], [0, 0, 1]]
    return envmod.Attachment(*(torch.as_tensor(a, device=device) for a in (rot, pos, sph)))


def terrain_tables(n: int, seed: int, device):
    """n seeded terrains of 250 x 250 cells of 1 cm around the Panda: hills
    0.2-0.6 m high (a seeded 11 x 11 grid, bilinear), below the base (-0.1 m)
    within 0.25 m of it; the grid sits a third of a cell off the origin, so
    that no base sphere lies on a cell edge.  (hf_meta (n, 1, 10), hf_data
    (n, 1, 62500))."""
    from vamp_mvt_tpu_torch.collision import environment as envmod

    rng = np.random.default_rng(seed)
    coarse = torch.as_tensor(rng.uniform(0.2, 0.6, (n, 1, 11, 11)).astype(np.float32),
                             device=device)
    h = torch.nn.functional.interpolate(coarse, size=(250, 250), mode="bilinear",
                                        align_corners=True)[:, 0]
    xy = (torch.arange(250, device=device) - 125 + 0.5) * 0.01
    h[:, torch.hypot(xy[None, :], xy[:, None]) < 0.25] = -0.1
    meta, _ = envmod.make_heightfield((0.0033, 0.0033, 0.0), (0.01, 0.01, 1.0),
                                      np.zeros((250, 250), np.float32))
    return (torch.as_tensor(meta, device=device).expand(n, 1, 10).contiguous(),
            h.reshape(n, 1, -1).contiguous())


def maze(rng):
    """A seeded 200 x 200 maze (walls 1, floor 0): a depth-first maze of 9 x 9
    cells in blocks of 10 pixels, inside an open margin of 5 pixels."""
    n = 9
    blocks = np.ones((2 * n + 1, 2 * n + 1), np.float32)
    seen = np.zeros((n, n), bool)
    stack = [(0, 0)]
    seen[0, 0] = True
    blocks[1, 1] = 0.0
    while stack:
        i, j = stack[-1]
        nxt = [(i + di, j + dj) for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1))
               if 0 <= i + di < n and 0 <= j + dj < n and not seen[i + di, j + dj]]
        if not nxt:
            stack.pop()
            continue
        a, b = nxt[rng.integers(len(nxt))]
        seen[a, b] = True
        blocks[2 * a + 1, 2 * b + 1] = 0.0
        blocks[i + a + 1, j + b + 1] = 0.0
        stack.append((a, b))
    out = np.zeros((200, 200), np.float32)
    out[5:195, 5:195] = np.kron(blocks, np.ones((10, 10), np.float32))
    return out
