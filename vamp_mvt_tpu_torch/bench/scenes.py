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


WALL_LIMITS = dict(lows=(-3, -3, 0), highs=(3, 3, 3), radius=0.1)


def center_wall(B: int, device=None):
    """The sphere robot's wall with a centre hole, B problems whose goals
    differ by 0.05 each (tests/test_sharding.py's batch): spec, envs (B, ...),
    starts (B, 3), goals (B, 1, 3), masks (B, 1)."""
    from vamp_mvt_tpu_torch.collision import environment as envmod

    b = envmod.EnvironmentBuilder()
    for y in np.linspace(-3, 3, 13):
        for z in np.linspace(0, 3, 7):
            if abs(y) < 1.0 and abs(z - 1.0) < 1.0:
                continue
            b.add_sphere([0.0, y, z], 0.3)
    envs = envmod.broadcast_environment(b.build(device=device), B)
    starts = torch.tensor([[-2.0, 0.0, 1.0]] * B, device=device)
    goals = (torch.tensor([[[2.0, 0.0, 1.0]]] * B, device=device)
             + torch.arange(B, dtype=torch.float32, device=device)[:, None, None] * 0.05)
    masks = torch.ones((B, 1), dtype=torch.bool, device=device)
    return registry.sphere_spec(**WALL_LIMITS), envs, starts, goals, masks


def cage_cloud(per_sphere: int = 1000) -> np.ndarray:
    """The sphere cage's pointcloud: `per_sphere` seeded surface points a
    cage sphere (pointcloud/sampling.py::sphere_surface), (14 per_sphere, 3)."""
    from vamp_mvt_tpu_torch.pointcloud import sampling

    np.random.seed(0)
    return np.vstack([sampling.sphere_surface(c, mbm.CAGE_RADIUS, per_sphere)
                      for c in mbm.CAGE_CENTERS])


def api_cage():
    """examples/attachments.py's scenario through the user API: the sphere
    cage with the payload [[0, 0, 0.12, 0.06]], VAMP's start A and goal B."""
    import vamp_mvt_tpu_torch as vmt

    env = vmt.Environment()
    for c in mbm.CAGE_CENTERS:
        env.add_sphere(vmt.Sphere(c, mbm.CAGE_RADIUS))
    env.attach(vmt.Attachment(spheres=[[0.0, 0.0, 0.12, 0.06]]))
    return env, mbm.PANDA_START, mbm.PANDA_GOAL


def cage_requests(spec, n: int, seed: int = 40, device=None) -> list[tuple]:
    """`n` (start, goal) pairs of seeded configurations valid in the sphere
    cage: the first 2n valid of 1024 drawn, in order (numpy float32)."""
    from vamp_mvt_tpu_torch.collision import environment as envmod
    from vamp_mvt_tpu_torch.ops.kernels import fkcc_cuda

    b = envmod.EnvironmentBuilder()
    for c in mbm.CAGE_CENTERS:
        b.add_sphere(c, mbm.CAGE_RADIUS)
    envs = b.build(device=device).map(lambda t: t[None])
    q = seeded_configs(spec, 1, 1024, seed, device)
    valid = q[0][fkcc_cuda.fkcc_batched(spec, envs, q)[0]][: 2 * n].cpu().numpy()
    if len(valid) < 2 * n:
        raise ValueError(f"only {len(valid)} of 1024 seeded configurations are valid")
    return [(valid[2 * i], valid[2 * i + 1]) for i in range(n)]


# ---------------------------------------------------------------------------
# A MotionBenchMaker problem tarball (the parser's input), and cage problems
# whose obstacles a pointcloud samples
# ---------------------------------------------------------------------------

TARBALL_SCENARIOS = ("bookshelf_small", "box", "cage")


def _quat_xyzw(R) -> list[float]:
    """A rotation matrix as a unit quaternion [x, y, z, w] (w >= 0)."""
    w = np.sqrt(max(0.0, 1.0 + R[0, 0] + R[1, 1] + R[2, 2])) / 2
    x = np.copysign(np.sqrt(max(0.0, 1.0 + R[0, 0] - R[1, 1] - R[2, 2])) / 2, R[2, 1] - R[1, 2])
    y = np.copysign(np.sqrt(max(0.0, 1.0 - R[0, 0] + R[1, 1] - R[2, 2])) / 2, R[0, 2] - R[2, 0])
    z = np.copysign(np.sqrt(max(0.0, 1.0 - R[0, 0] - R[1, 1] + R[2, 2])) / 2, R[1, 0] - R[0, 1])
    return [float(v) for v in (x, y, z, w)]


def _random_rotation(rng) -> np.ndarray:
    q = rng.normal(size=4)
    return mbm._quat_matrix(q / np.linalg.norm(q))


def _posed_object(rng, name: str, kind: str, dims, center, R) -> dict:
    """A MoveIt collision object whose primitive lands at `center` with
    rotation R, through a seeded object pose and the primitive pose that
    undoes it."""
    Rb = _random_rotation(rng)
    pb = rng.uniform(-0.5, 0.5, 3)
    pp = Rb.T @ (np.asarray(center, float) - pb)
    return {"id": name,
            "pose": {"position": [float(v) for v in pb], "orientation": _quat_xyzw(Rb)},
            "primitives": [{"type": kind, "dimensions": [float(v) for v in dims]}],
            "primitive_poses": [{"position": [float(v) for v in pp],
                                 "orientation": _quat_xyzw(Rb.T @ R)}]}


def write_mbm_tarball(root, robot: str = "panda", scenarios=TARBALL_SCENARIOS,
                      per_scenario: int = 3, seed: int = 0):
    """Write `root/<robot>/problems.tar.bz2` in MotionBenchMaker's layout:
    `problems/<scenario>_<robot>/scene<i>.yaml` (MoveIt planning scenes) and
    `request<i>.yaml` (motion plan requests), i = 1..per_scenario.  Each
    scene is the Panda's sphere cage (every sphere moved by a seeded offset
    in +-0.01 a coordinate) with two cylinders and two boxes inside cage
    spheres, at seeded rotations; every object carries a seeded pose of its
    own that its primitive pose undoes.  The requests go from VAMP's start
    to its goal in the cage, with the joints (the fingers among them) in a
    seeded order.  Every obstacle lies inside a cage sphere, so VAMP's start
    and goal stay valid.  Needs PyYAML.  Returns the tarball's path."""
    import io
    import tarfile
    from pathlib import Path

    import yaml

    spec = registry.load(robot)
    joints = list(spec.joint_names)
    extra = [f"{robot}_finger_joint1", f"{robot}_finger_joint2"]
    rng = np.random.default_rng(seed)
    files = {}
    for scenario in scenarios:
        for i in range(1, per_scenario + 1):
            centers = np.asarray(mbm.CAGE_CENTERS) + rng.uniform(-0.01, 0.01, (14, 3))
            objects = [_posed_object(rng, f"sphere{k}", "sphere", [mbm.CAGE_RADIUS], c,
                                     _random_rotation(rng)) for k, c in enumerate(centers)]
            inside = rng.choice(len(centers), 4, replace=False)
            for k in inside[:2]:  # height 0.24, radius 0.08: corners 0.165 from the centre
                objects.append(_posed_object(rng, f"cylinder{k}", "cylinder", [0.24, 0.08],
                                             centers[k], _random_rotation(rng)))
            for k in inside[2:]:  # a cube of side 0.2: corners 0.173 from the centre
                objects.append(_posed_object(rng, f"box{k}", "box", [0.2, 0.2, 0.2],
                                             centers[k], _random_rotation(rng)))
            rng.shuffle(objects)
            scene = {"name": f"{scenario}_{i}", "robot_state": {},
                     "world": {"collision_objects": objects}}
            order = rng.permutation(len(joints) + len(extra))
            names = [(joints + extra)[j] for j in order]
            values = dict(zip(joints, mbm.PANDA_START)) | {n: 0.04 for n in extra}
            goal = dict(zip(joints, mbm.PANDA_GOAL))
            request = {
                "start_state": {"joint_state": {"name": names,
                                                "position": [float(values[n]) for n in names]}},
                "goal_constraints": [{"joint_constraints": [
                    {"joint_name": j, "position": float(goal[j]), "tolerance_above": 0.001,
                     "tolerance_below": 0.001, "weight": 1.0}
                    for j in (joints[k] for k in rng.permutation(len(joints)))]}],
                "group_name": f"{robot}_arm"}
            base = f"problems/{scenario}_{robot}"
            files[f"{base}/scene{i:04d}.yaml"] = yaml.safe_dump(scene)
            files[f"{base}/request{i:04d}.yaml"] = yaml.safe_dump(request)
    out = Path(root) / robot / "problems.tar.bz2"
    out.parent.mkdir(parents=True, exist_ok=True)
    with tarfile.open(out, "w:bz2") as tar:
        for name, text in files.items():
            data = text.encode()
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))
    return out


CAGE_BOX_HALF = 0.15  # the cube standing for a cage sphere in cage_box_problems


def cage_box_problems(requests, seed: int = 0) -> list[dict]:
    """Sphere-cage problems in the MBM layout (problem kind "cage"), one a
    (start, goal) request, whose obstacles a pointcloud samples: each cage
    sphere also as a cube of half side CAGE_BOX_HALF, turned about z by a
    seeded angle that every problem shares (pointcloud/sampling.py samples
    cylinders and boxes, never spheres)."""
    angles = np.random.default_rng(seed).uniform(-np.pi, np.pi, len(mbm.CAGE_CENTERS))
    boxes = [{"position": list(map(float, c)), "orientation_euler_xyz": [0.0, 0.0, float(a)],
              "half_extents": [CAGE_BOX_HALF] * 3} for c, a in zip(mbm.CAGE_CENTERS, angles)]
    spheres = [{"position": list(map(float, c)), "radius": mbm.CAGE_RADIUS}
               for c in mbm.CAGE_CENTERS]
    return [{"problem": "cage", "index": i + 1, "sphere": spheres, "cylinder": [], "box": boxes,
             "start": [float(v) for v in start], "goals": [[float(v) for v in goal]]}
            for i, (start, goal) in enumerate(requests)]


def cage_box_requests(spec, n: int, seed: int, device=None) -> list[tuple]:
    """`n` (start, goal) pairs for cage_box_problems: seeded configurations
    valid in the sphere cage, among the cubes and against the cubes' cloud
    (sampled, filtered and built as `prepare_mpnet_dataset` does: 2000
    points an object), whose straight segment the cubes block, so that a
    plan has a waypoint between them.  Of 4096 configurations drawn, the
    valid ones paired in order, the first n such pairs (numpy float32)."""
    from vamp_mvt_tpu_torch.collision import environment as envmod
    from vamp_mvt_tpu_torch.ops.kernels import fkcc_cuda
    from vamp_mvt_tpu_torch.pointcloud import pipeline

    q = seeded_configs(spec, 1, 4096, seed, device)
    box = cage_box_problems([(np.zeros(spec.dimension), np.zeros(spec.dimension))])[0]
    cloud = pipeline.problem_to_pointcloud_env(spec.name, box, pc_repr="mvt",
                                               samples_per_object=2000)[0]
    tables = [mbm.problem_to_builder(p) for p in (dict(box, box=[]), dict(box, sphere=[]))]
    ok = torch.ones(q.shape[:2], dtype=torch.bool, device=q.device)
    for b in tables + [envmod.EnvironmentBuilder(pck=cloud.pck)]:
        ok &= fkcc_cuda.fkcc_batched(spec, b.build(device=device).map(lambda t: t[None]), q)
    valid = q[0][ok[0]]
    pairs = valid[: len(valid) // 2 * 2].reshape(-1, 2, spec.dimension)
    num = validate.n_points_bound(spec, float(np.linalg.norm(spec.limits_high - spec.limits_low)))
    cubes = tables[1].build(device=device).map(lambda t: t[None].expand(len(pairs), *t.shape))
    free = validate.validate_motion(spec, cubes, pairs[:, 0], pairs[:, 1], num)
    blocked = pairs[~free][:n].cpu().numpy()
    if len(blocked) < n:
        raise ValueError(f"only {len(blocked)} blocked pairs among 4096 seeded configurations")
    return [(a, b) for a, b in blocked]
