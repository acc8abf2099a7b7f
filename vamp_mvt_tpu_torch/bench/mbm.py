"""MotionBenchMaker problem suite: loading, environment building, batch runner.

Port of `vamp_mvt_tpu/bench/mbm.py`: batch assembly, start/goal validity,
planning, the 32x-budget retry of unsolved problems, simplification and the
gather of results to the host.  planner="mega" plans and simplifies with the
megakernels (`planning/rrtc_mega.py`, `planning/simplify_mega.py`);
planner="xla" with the lockstep state machines and straggler compaction.
`run_suite_pointcloud` runs the suite against pointclouds sampled from the
problems' obstacles (pointcloud/pipeline.py).

Problem data comes from the MoveIt-YAML tarballs under
VAMP_MVT_TPU_RESOURCES (`<robot>/problems.tar.bz2`), or from a `data` dict in
the same layout.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import pickle
import re
import tarfile
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from vamp_mvt_tpu_torch.collision import environment as envmod
from vamp_mvt_tpu_torch.device import resolve_device
from vamp_mvt_tpu_torch.ops.kernels import fkcc_cuda
from vamp_mvt_tpu_torch.planning import rrtc, rrtc_mega, simplify, simplify_mega, validate
from vamp_mvt_tpu_torch.robots import registry
from vamp_mvt_tpu_torch.utils import profiling

RESOURCES = Path(os.environ.get("VAMP_MVT_TPU_RESOURCES", "/root/reference/resources"))

# The 7 standard MBM scenarios making up the published 700-problem Panda suite.
STANDARD_SCENARIOS = (
    "bookshelf_small",
    "bookshelf_tall",
    "bookshelf_thin",
    "box",
    "cage",
    "table_pick",
    "table_under_pick",
)
CACHE_DIR = Path(
    os.environ.get("VAMP_MVT_TPU_CACHE", Path.home() / ".cache" / "vamp_mvt_tpu_torch")
)


# ---------------------------------------------------------------------------
# Problem parsing (mirrors resources/problem_tar_to_pkl_json.py semantics)
# ---------------------------------------------------------------------------


def _quat_matrix(q):
    """MoveIt YAML stores [x, y, z, w]."""
    x, y, z, w = q
    n = np.sqrt(x * x + y * y + z * z + w * w)
    if n == 0:
        return np.eye(3)
    x, y, z, w = x / n, y / n, z / n, w / n
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )


def _euler_xyz_from_matrix(R):
    """Euler XYZ (rho, theta, phi) with R = Rz(phi) Ry(theta) Rx(rho)."""
    theta = -np.arcsin(np.clip(R[2, 0], -1.0, 1.0))
    c = np.cos(theta)
    if abs(c) > 1e-8:
        rho = np.arctan2(R[2, 1], R[2, 2])
        phi = np.arctan2(R[1, 0], R[0, 0])
    else:
        rho = np.arctan2(-R[1, 2], R[1, 1])
        phi = 0.0
    return [float(rho), float(theta), float(phi)]


def _tf(obj):
    pos = np.asarray(obj["position"], dtype=float)
    R = _quat_matrix(obj["orientation"])
    return pos, R


def _scene_objects(data):
    objects = {"sphere": [], "cylinder": [], "box": []}
    for co in data["world"]["collision_objects"]:
        base_p, base_r = (np.zeros(3), np.eye(3))
        if "pose" in co:
            base_p, base_r = _tf(co["pose"])
        prim = co["primitives"][0]
        pp, pr = _tf(co["primitive_poses"][0])
        pos = base_r @ pp + base_p
        R = base_r @ pr
        obj = {
            "name": co["id"],
            "position": pos.tolist(),
            "orientation_euler_xyz": _euler_xyz_from_matrix(R),
        }
        t = prim["type"]
        if t == "sphere":
            obj["radius"] = float(prim["dimensions"][0])
        elif t == "cylinder":
            obj["length"] = float(prim["dimensions"][0])
            obj["radius"] = float(prim["dimensions"][1])
        elif t == "box":
            obj["half_extents"] = [float(x) / 2 for x in prim["dimensions"]]
        else:
            raise RuntimeError(f"invalid primitive {t}")
        objects[t].append(obj)
    return objects


def _request(data, joints):
    js = data["start_state"]["joint_state"]
    start = [js["position"][js["name"].index(j)] for j in joints]
    cons = data["goal_constraints"][0]["joint_constraints"]
    names = [c["joint_name"] for c in cons]
    pos = [c["position"] for c in cons]
    goal = [pos[names.index(j)] for j in joints]
    return {"start": start, "goals": [goal]}


def load_problems(robot: str, use_cache: bool = True) -> dict:
    """Parse resources/<robot>/problems.tar.bz2 into the reference pkl layout.

    The parse is cached as CACHE_DIR/<robot>_problems.pkl, keyed by the
    robot's name alone; a cached parse loads without PyYAML."""
    CACHE_DIR.mkdir(parents=True, exist_ok=True)
    cache = CACHE_DIR / f"{robot}_problems.pkl"
    if use_cache and cache.exists():
        with open(cache, "rb") as f:
            return pickle.load(f)

    import yaml

    loader = getattr(yaml, "CLoader", yaml.SafeLoader)

    spec = registry.load(robot)
    joints = list(spec.joint_names)
    scenes, requests = defaultdict(list), defaultdict(list)
    with tarfile.open(RESOURCES / robot / "problems.tar.bz2", "r:bz2") as tar:
        for member in tar.getmembers():
            if not member.isfile():
                continue
            f = tar.extractfile(member)
            _, problem, filename = member.name.split("/")
            problem = problem.replace(f"_{robot}", "")
            data = yaml.load(f.read(), Loader=loader)
            index = int(re.findall(r"\d+", filename)[0])
            meta = {"index": index, "problem": problem}
            if "scene" in filename:
                scenes[problem].append(_scene_objects(data) | meta)
            elif "request" in filename:
                requests[problem].append(_request(data, joints) | meta)

    out = {"robot": robot, "joints": joints, "problems": {}}
    for k in scenes:
        out["problems"][k] = [
            {**s, **r}
            for s, r in zip(
                sorted(scenes[k], key=lambda e: e["index"]),
                sorted(requests[k], key=lambda e: e["index"]),
            )
        ]
    with open(cache, "wb") as f:
        pickle.dump(out, f)
    return out


def load_problems_pkl(path) -> dict:
    """Load a pre-converted problem pickle ({robot, joints, problems})."""
    with open(path, "rb") as f:
        data = pickle.load(f)
    for plist in data["problems"].values():
        for prob in plist:
            prob.setdefault("sphere", [])
            prob.setdefault("cylinder", [])
            prob.setdefault("box", [])
    return data


# VAMP's published sphere-cage problem (reference scripts/sphere_cage_example.py):
# 14 spheres of radius 0.2 around the Panda, with its canonical start and goal.
CAGE_CENTERS = (
    (0.55, 0, 0.25), (0.35, 0.35, 0.25), (0, 0.55, 0.25), (-0.55, 0, 0.25),
    (-0.35, -0.35, 0.25), (0, -0.55, 0.25), (0.35, -0.35, 0.25),
    (0.35, 0.35, 0.8), (0, 0.55, 0.8), (-0.35, 0.35, 0.8), (-0.55, 0, 0.8),
    (-0.35, -0.35, 0.8), (0, -0.55, 0.8), (0.35, -0.35, 0.8),
)
CAGE_RADIUS = 0.2
PANDA_START = (0.0, -0.785, 0.0, -2.356, 0.0, 1.571, 0.785)
PANDA_GOAL = (2.35, 1.0, 0.0, -0.8, 0.0, 2.5, 0.785)


def cage_suite(n: int, seed: int = 0) -> dict:
    """A suite of `n` Panda sphere-cage problems in the MBM data layout, each
    cage sphere moved by a seeded offset in +-0.01 per axis."""
    rng = np.random.default_rng(seed)
    problems = []
    for i in range(n):
        offsets = rng.uniform(-0.01, 0.01, (len(CAGE_CENTERS), 3))
        problems.append({
            "problem": "cage",
            "index": i,
            "sphere": [
                {"position": (np.asarray(c) + o).tolist(), "radius": CAGE_RADIUS}
                for c, o in zip(CAGE_CENTERS, offsets)
            ],
            "cylinder": [],
            "box": [],
            "start": list(PANDA_START),
            "goals": [list(PANDA_GOAL)],
        })
    joints = list(registry.load("panda").joint_names)
    return {"robot": "panda", "joints": joints, "problems": {"cage": problems}}


def problem_to_builder(problem: dict) -> envmod.EnvironmentBuilder:
    """Environment construction, mirroring problem_dict_to_vamp (reference
    src/vamp/__init__.py:142-188, incl. the 'box' problem's cylinder->cuboid
    overapproximation)."""
    b = envmod.EnvironmentBuilder()
    for obj in problem["sphere"]:
        b.add_sphere(obj["position"], obj["radius"])
    if problem["problem"] == "box":
        for obj in problem["cylinder"]:
            b.add_cuboid(
                envmod.make_cuboid(
                    obj["position"],
                    obj["orientation_euler_xyz"],
                    [obj["radius"], obj["radius"], obj["length"] / 2],
                )
            )
    else:
        for obj in problem["cylinder"]:
            b.add_capsule(
                envmod.make_capsule_center(
                    obj["position"],
                    obj["orientation_euler_xyz"],
                    obj["radius"],
                    obj["length"],
                )
            )
    for obj in problem["box"]:
        b.add_cuboid(
            envmod.make_cuboid(
                obj["position"], obj["orientation_euler_xyz"], obj["half_extents"]
            )
        )
    return b


# ---------------------------------------------------------------------------
# Batch assembly and runner
# ---------------------------------------------------------------------------


def _euler_xyz_matrices(e: np.ndarray) -> np.ndarray:
    """(N, 3) Euler XYZ -> (N, 3, 3), R = Rz(phi) Ry(theta) Rx(rho)."""
    cr, sr = np.cos(e[:, 0]), np.sin(e[:, 0])
    cp, sp = np.cos(e[:, 1]), np.sin(e[:, 1])
    cy, sy = np.cos(e[:, 2]), np.sin(e[:, 2])
    R = np.empty((len(e), 3, 3), np.float64)
    R[:, 0, 0] = cy * cp
    R[:, 0, 1] = cy * sp * sr - sy * cr
    R[:, 0, 2] = cy * sp * cr + sy * sr
    R[:, 1, 0] = sy * cp
    R[:, 1, 1] = sy * sp * sr + cy * cr
    R[:, 1, 2] = sy * sp * cr - cy * sr
    R[:, 2, 0] = -sp
    R[:, 2, 1] = cp * sr
    R[:, 2, 2] = cp * cr
    return R


def _assemble_batch_np(problems: list[dict]) -> dict[str, np.ndarray]:
    """Vectorized environment-batch assembly: equal to stacking
    problem_to_builder(p).build(caps) per problem, in one numpy pass per
    shape type."""
    B = len(problems)

    sph_i, sph = [], []
    cap_i, cap_c, cap_e, cap_rl = [], [], [], []
    boxcyl_i, boxcyl_c, boxcyl_e, boxcyl_h = [], [], [], []
    box_i, box_c, box_e, box_h = [], [], [], []
    for i, p in enumerate(problems):
        for o in p["sphere"]:
            sph_i.append(i)
            sph.append([*o["position"], o["radius"]])
        if p["problem"] == "box":
            for o in p["cylinder"]:
                boxcyl_i.append(i)
                boxcyl_c.append(o["position"])
                boxcyl_e.append(o["orientation_euler_xyz"])
                boxcyl_h.append([o["radius"], o["radius"], o["length"] / 2])
        else:
            for o in p["cylinder"]:
                cap_i.append(i)
                cap_c.append(o["position"])
                cap_e.append(o["orientation_euler_xyz"])
                cap_rl.append([o["radius"], o["length"]])
        for o in p["box"]:
            box_i.append(i)
            box_c.append(o["position"])
            box_e.append(o["orientation_euler_xyz"])
            box_h.append(o["half_extents"])

    def cuboid_rows(c, e, h):
        if not len(c):
            return np.zeros((0, 15), np.float32), np.zeros(0, bool)
        R = _euler_xyz_matrices(np.asarray(e, np.float64))
        rows = np.concatenate(
            [np.asarray(c, np.float64), R[:, :, 0], R[:, :, 1], R[:, :, 2],
             np.asarray(h, np.float64)], axis=1,
        ).astype(np.float32)
        return rows, rows[:, 11] == 1.0

    def capsule_rows(c, e, rl):
        if not len(c):
            return np.zeros((0, 8), np.float32), np.zeros(0, bool)
        c = np.asarray(c, np.float64)
        rl = np.asarray(rl, np.float64)
        R = _euler_xyz_matrices(np.asarray(e, np.float64))
        half = R[:, :, 2] * (rl[:, 1:2] / 2.0)
        p1 = c + half
        v = -2.0 * half
        rdv = 1.0 / np.einsum("ij,ij->i", v, v)
        rows = np.concatenate([p1, v, rl[:, 0:1], rdv[:, None]], axis=1).astype(np.float32)
        return rows, rows[:, 3] == 0.0

    cub_rows, cub_z = cuboid_rows(boxcyl_c + box_c, boxcyl_e + box_e, boxcyl_h + box_h)
    cub_idx = np.asarray(boxcyl_i + box_i, np.int64)
    capr, capz = capsule_rows(cap_c, cap_e, cap_rl)
    cap_idx = np.asarray(cap_i, np.int64)
    sph_rows = np.asarray(sph, np.float32).reshape(-1, 4)
    sph_idx = np.asarray(sph_i, np.int64)

    def scatter(rows, idx, keep, inert, B):
        rows, idx = rows[keep], idx[keep]
        counts = np.bincount(idx, minlength=B) if len(idx) else np.zeros(B, int)
        cap = int(counts.max()) if len(idx) else 0
        out = np.tile(inert, (B, max(cap, 1), 1)).astype(np.float32)
        if not cap:
            return out[:, :0]
        # slot within problem: order of appearance (stable)
        slot = np.zeros(len(idx), np.int64)
        seen: dict[int, int] = {}
        for k, i in enumerate(idx):
            slot[k] = seen.get(i, 0)
            seen[i] = slot[k] + 1
        out[idx, slot] = rows
        return out

    inert_s = envmod._INERT["spheres"]
    inert_c = envmod._INERT["capsules"]
    inert_b = envmod._INERT["cuboids"]
    return {
        "spheres": scatter(sph_rows, sph_idx, np.ones(len(sph_idx), bool), inert_s, B),
        "capsules": scatter(capr, cap_idx, ~capz, inert_c, B),
        "z_capsules": scatter(capr, cap_idx, capz, inert_c, B),
        "cuboids": scatter(cub_rows, cub_idx, ~cub_z, inert_b, B),
        "z_cuboids": scatter(cub_rows, cub_idx, cub_z, inert_b, B),
    }


def content_key(problems: list[dict]) -> str:
    """A hash of the problems themselves (not just their count), so two
    suites of the same size never share a cached batch."""
    return hashlib.md5(repr(problems).encode()).hexdigest()[:16]


def build_batch(problems: list[dict], cache_key: str | None = None, device=None):
    """Stack per-problem environments padded to common capacities.

    Returns (envs, starts (B, d), goals (B, G, d), masks (B, G)) on `device`.
    With a cache_key the assembled arrays are memoized as an npz in
    CACHE_DIR; key it by content (`content_key`)."""
    dev = resolve_device(device)
    with profiling.span("batch_assemble"):
        arrs = _batch_arrays(problems, cache_key)
    with profiling.span("batch_to_device"):
        nh = len(problems)
        t = lambda a: torch.as_tensor(a, device=dev)
        envs = envmod.Environment(
            spheres=t(arrs["spheres"]),
            capsules=t(arrs["capsules"]),
            z_capsules=t(arrs["z_capsules"]),
            cuboids=t(arrs["cuboids"]),
            z_cuboids=t(arrs["z_cuboids"]),
            hf_meta=torch.zeros((nh, 0, 10), dtype=torch.float32, device=dev),
            hf_data=torch.zeros((nh, 0, 0), dtype=torch.float32, device=dev),
        )
        return envs, t(arrs["starts"]), t(arrs["goals"]), t(arrs["masks"])


def _batch_arrays(problems: list[dict], cache_key: str | None) -> dict[str, np.ndarray]:
    """build_batch's host arrays: the tables and the endpoints, from the
    npz cache where a cache_key names one."""
    arrs = None
    cache = None
    if cache_key is not None:
        CACHE_DIR.mkdir(parents=True, exist_ok=True)
        cache = CACHE_DIR / f"batch_{cache_key}.npz"
        if cache.exists():
            with np.load(cache) as z:
                arrs = {k: z[k] for k in z.files}
    if arrs is None:
        arrs = _assemble_batch_np(problems)
        G = max(len(p["goals"]) for p in problems)
        d = len(problems[0]["start"])
        starts = np.zeros((len(problems), d), np.float32)
        goals = np.zeros((len(problems), G, d), np.float32)
        masks = np.zeros((len(problems), G), bool)
        for i, p in enumerate(problems):
            starts[i] = p["start"]
            for g, goal in enumerate(p["goals"]):
                goals[i, g] = goal
                masks[i, g] = True
        arrs |= {"starts": starts, "goals": goals, "masks": masks}
        if cache is not None:
            np.savez(cache, **arrs)
    for name in envmod.TABLES:
        envmod.check_live_prefix(name, arrs[name])
    return arrs


def _valid_fused(spec, envs, starts, goals, masks):
    """Start + goal validity in one fused FK+CC call (collision-only, like
    the reference's check_bounds=false)."""
    qall = torch.cat([starts[:, None], goals], dim=1)  # (B, 1+G, d)
    free = validate.fkcc_valid(spec, envs, qall)
    return free[:, 0] & (free[:, 1:] & masks).any(1)


def validate_configs(spec, envs, configs, check_bounds: bool = False):
    """Config validity (B, d) -> (B,): collision, optionally joint limits."""
    free = validate.fkcc_valid(spec, envs, configs[:, None])[:, 0]
    if not check_bounds:
        return free
    lo = torch.as_tensor(spec.limits_low, device=configs.device)
    hi = torch.as_tensor(spec.limits_high, device=configs.device)
    return ((configs >= lo) & (configs <= hi)).all(-1) & free


def _to_numpy(res):
    """A result tuple of tensors -> the same tuple of host numpy arrays."""
    return type(res)(*(t.cpu().numpy() for t in res))


class SuiteResult:
    def __init__(self, names, plan_res, simp_res, valid, plan_time, simp_time):
        self.names = names
        self.plan = plan_res
        self.simplified = simp_res
        self.valid = np.asarray(valid)
        self.plan_time = plan_time
        self.simp_time = simp_time

    def summary(self) -> dict:
        solved = np.asarray(self.plan.solved) & self.valid
        total = len(self.valid)
        n_valid = int(self.valid.sum())
        n_solved = int(solved.sum())
        init_cost = np.asarray(self.plan.cost)[solved]
        simp_cost = np.asarray(self.simplified.cost)[solved]
        iters = np.asarray(self.plan.iterations)[solved]
        return {
            "total_problems": total,
            "valid_problems": n_valid,
            "solved_problems": n_solved,
            "solve_rate": n_solved / max(n_valid, 1),
            "median_initial_cost": float(np.median(init_cost)) if n_solved else None,
            "median_simplified_cost": float(np.median(simp_cost)) if n_solved else None,
            "median_iterations": float(np.median(iters)) if n_solved else None,
            "plan_wall_s": self.plan_time,
            "simplify_wall_s": self.simp_time,
            "problems_per_sec": total / max(self.plan_time + self.simp_time, 1e-9),
        }

    def percentile_table(self) -> str:
        """Percentile table mirroring the reference's evaluate_mbm output."""
        solved = np.asarray(self.plan.solved) & self.valid
        rows = []
        pcts = [50, 75, 95, 99]
        metrics = {
            "initial_cost": np.asarray(self.plan.cost)[solved],
            "simplified_cost": np.asarray(self.simplified.cost)[solved],
            "samples": np.asarray(self.plan.iterations)[solved],
            "graph_size": (
                np.asarray(self.plan.size_start) + np.asarray(self.plan.size_goal)
            )[solved],
            "initial_path_vertices": np.asarray(self.plan.path_length)[solved],
            "simplified_path_vertices": np.asarray(self.simplified.path_length)[solved],
        }
        rows.append(f"{'metric':<26}" + "".join(f"{p:>10}%" for p in pcts) + f"{'mean':>11}")
        for name, vals in metrics.items():
            if not len(vals):
                continue
            qs = np.percentile(vals, pcts)
            rows.append(
                f"{name:<26}" + "".join(f"{q:>11.2f}" for q in qs) + f"{vals.mean():>11.2f}"
            )
        s = self.summary()
        rows.append(
            f"Solved {s['solved_problems']} / Valid {s['valid_problems']} / "
            f"Total {s['total_problems']}"
        )
        return "\n".join(rows)


def default_settings(robot: str, planner: str) -> rrtc.RRTCSettings:
    """run_suite's planner settings for `robot` (planner "mega" or "xla")."""
    if planner == "mega":
        return rrtc.RRTCSettings(
            range=registry.RRT_RANGES.get(robot, 1.0),
            max_iterations=4096,
            # node capacity sized for the 32x retry, which reuses the kernel
            # with a larger runtime budget; the kernel only ever reads the
            # live tree prefix
            max_samples=16384,
            max_path=96,
            # K * W <= 128 samples a step: the window is 8 at K = 16 and 4 at
            # K = 32 (Fetch, whose problems need many more samples)
            samples_per_step=32 if robot == "fetch" else 16,
            connect_segments=8,
            sample_window=4 if robot == "fetch" else 8,
        )
    return rrtc.RRTCSettings(
        range=registry.RRT_RANGES.get(robot, 1.0),
        max_iterations=4096,
        # node-buffer capacity: small on purpose — the masked brute-force NN
        # and the lockstep state copies scale with it; the rare problem that
        # fills it is rerun by the straggler retry at a large capacity
        max_samples=512,
        max_path=96,
        samples_per_step=16,
        connect_segments=8,
        sample_window=4,
    )


def run_suite(
    robot: str = "panda",
    problem_names=None,
    settings: rrtc.RRTCSettings | None = None,
    simp_settings: simplify.SimplifySettings | None = None,
    max_problems: int | None = None,
    batch_size: int = 700,
    warmup: bool = True,
    planner: str = "auto",
    data: dict | None = None,
    timings: dict | None = None,
    device=None,
) -> SuiteResult:
    """Plan + simplify a whole MBM suite as batched device work.

    planner="mega" runs the planner megakernel over the whole batch (each
    problem stops the moment it is done), replans the unsolved ones at a 32x
    budget with the same kernel, and simplifies with the simplify megakernel
    when `simplify_mega.supports(simp_settings)`.  planner="xla" runs the
    lockstep state machine with straggler compaction and the lockstep
    simplifier.  "auto" means "mega" on a GPU and "xla" on the CPU.

    Pass a dict as `timings` for a wall-clock phase breakdown in seconds,
    the spans of utils/profiling.py (build_batch, with batch_assemble and
    batch_to_device inside it, validity, warmup, plan, retry, simplify,
    gather; the log of them under "spans"), and the counts: retry_live (rows
    the retry plans with their own goals), and on the mega path
    planner_block_ns, planner_slot_ns, the planner's phase clocks
    planner_cyc, planner_fkcc_cyc and planner_nn_cyc (every launch;
    `rrtc_mega._count_blocks`) and, for the retry launch, retry_iter_us and
    retry_blocks, its blocks (`rrtc_mega.plan_batch_mega`: rows x cluster
    size).  Runs on `device` (default: the GPU).
    """
    dev = resolve_device(device)
    spec = registry.load(robot)
    if planner == "auto":
        planner = "mega" if dev.type == "cuda" else "xla"
    if planner not in ("mega", "xla"):
        raise ValueError(f"unknown planner {planner!r}")
    if settings is None:
        settings = default_settings(robot, planner)
    retry_budget = 32 * settings.max_iterations
    if simp_settings is None:
        simp_settings = simplify.SimplifySettings(pair_chunk=64)
    RETRY_B = 16  # fixed straggler batch size of the lockstep retry

    from_tarballs = data is None
    if from_tarballs:
        data = load_problems(robot)
    problems, names = [], []
    for pname, plist in data["problems"].items():
        if problem_names and pname not in problem_names:
            continue
        for p in plist:
            problems.append(p)
            names.append((pname, p["index"]))
    if max_problems:
        problems, names = problems[:max_problems], names[:max_problems]

    n_real = len(problems)
    pad = (-n_real) % batch_size
    problems = problems + [problems[-1]] * pad

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    if planner == "mega":

        def plan_fn(e, s_, g, m, budget, iter_count=None, block_count=None):
            return rrtc_mega.plan_batch_mega(spec, e, s_, g, m, settings, budget=budget,
                                             device=dev, iter_count=iter_count,
                                             block_count=block_count)

        solve_batch = _mega_solver(plan_fn, settings, 32, sync)

    else:
        # straggler phase: much larger sample budget and node buffer at high K
        retry_settings = dataclasses.replace(
            settings,
            max_iterations=32 * 4096,
            max_samples=16384,
            samples_per_step=128,
            connect_segments=16,
            sample_window=4,
        )

        def plan_fn(e, s_, g, m):
            return rrtc.plan_batch_compact(spec, e, s_, g, m, settings, segment_steps=64,
                                           device=dev)

        def retry_fn(e, s_, g, m):
            return rrtc.plan_batch_compact(spec, e, s_, g, m, retry_settings,
                                           segment_steps=64, min_batch=RETRY_B, device=dev)

        solve_batch = _lockstep_solver(plan_fn, retry_fn, RETRY_B, sync, dev)

    if planner == "mega" and simplify_mega.supports(simp_settings):

        def simp_fn(e, p, l):
            return simplify_mega.simplify_batch_mega(spec, e, p, l, simp_settings, device=dev)

    else:

        def simp_fn(e, p, l):
            return simplify.simplify_batch_compact(spec, e, p, l, simp_settings, device=dev)

    with profiling.recording(timings):
        with profiling.span("build_batch"):
            # cache the assembled batch only for the tarball suites, keyed by content
            key = content_key(problems) if from_tarballs else None
            envs, starts, goals, masks = build_batch(problems, cache_key=key, device=dev)
            sync()

        with profiling.span("validity"):
            valid = _valid_fused(spec, envs, starts, goals, masks).cpu().numpy()[:n_real]

        with profiling.span("warmup"):
            if warmup and dev.type == "cuda":
                # build and load every kernel outside the timed phases; the mega
                # path launches each of its kernels once on the first problem, at
                # both budgets (the retry's on its start-replaced goal, which ends
                # at once), the planner's as a cluster launch (one problem: k = 8)
                fkcc_cuda.library()
                if planner == "mega":
                    e0, s0, g0, m0 = envs.map(lambda t: t[:1]), starts[:1], goals[:1], masks[:1]
                    r0 = plan_fn(e0, s0, g0, m0, settings.max_iterations)
                    plan_fn(e0, s0, s0[:, None].expand_as(g0), m0, retry_budget)
                    simp_fn(e0, r0.path, r0.path_length)
            sync()

        plan_parts, simp_parts, t_plan, t_simp = _run_batches(
            envs, starts, goals, masks, batch_size, solve_batch, simp_fn, sync)
        with profiling.span("gather"):
            plan_res, simp_res = _gather(plan_parts, n_real), _gather(simp_parts, n_real)
            profiling.read_counts()
    return SuiteResult(names, plan_res, simp_res, valid, t_plan, t_simp)


def pointcloud_settings(robot: str) -> rrtc.RRTCSettings:
    """run_suite_pointcloud's planner settings for `robot`."""
    return rrtc.RRTCSettings(
        range=registry.RRT_RANGES.get(robot, 1.0),
        max_iterations=4096,
        max_samples=4096,
        max_path=96,
        samples_per_step=16,
        connect_segments=8,
        sample_window=8,
    )


def run_suite_pointcloud(
    robot: str = "panda",
    pc_repr: str = "capt",
    filter_type: str = "scdf",
    problem_names=None,
    settings: rrtc.RRTCSettings | None = None,
    simp_settings: simplify.SimplifySettings | None = None,
    max_problems: int | None = None,
    batch_size: int = 100,
    samples_per_object: int = 10000,
    warmup: bool = True,
    data: dict | None = None,
    device=None,
):
    """Pointcloud-mode MBM suite (reference scripts/evaluate_mbm.py:106-136).

    Per problem, on the host: sample the cylinder and box surfaces, filter
    (scdf / centervox) and build the pointcloud structures
    (pointcloud/pipeline.py, the C++ library), timed per problem like the
    reference's timing columns (resources/README.md:151-183).  Then plan and
    simplify.  On a GPU the planner and simplifier megakernels run on the
    kernel-resident structure (collision/pc_kernel.py), and the requested
    MVT / CAPT representation is built for its build-time metric only; the
    unsolved problems are replanned at 16x the budget.  With device="cpu"
    the lockstep planner and simplifier run on batched MVT / CAPT
    structures, with the stragglers rerun at 16x the budget in batches of 8,
    as the JAX package does on the CPU.  A retry that would replay a search
    which filled the node buffer raises (raise max_samples).

    Returns (SuiteResult, timings): filter_ns and build_ns per problem,
    their medians in ms, pc_repr, filter_type, and `phases`, the wall-clock
    breakdown in seconds by the spans of utils/profiling.py (pointcloud,
    with pc_sample, pc_filter, pc_build_capt or pc_build_mvt,
    pc_build_kernel and pc_stage inside it, validity, warmup, plan, retry,
    simplify, gather; their log under "spans"; no counts).  Runs on
    `device` (default: the GPU).
    """
    from vamp_mvt_tpu_torch.pointcloud import pipeline

    dev = resolve_device(device)
    spec = registry.load(robot)
    if settings is None:
        settings = pointcloud_settings(robot)
    retry_factor = 16
    RETRY_B = 8
    if simp_settings is None:
        simp_settings = simplify.SimplifySettings(pair_chunk=64)

    if data is None:
        data = load_problems(robot)
    problems, names = [], []
    for pname, plist in data["problems"].items():
        if problem_names and pname not in problem_names:
            continue
        for p in plist:
            problems.append(p)
            names.append((pname, p["index"]))
    if max_problems:
        problems, names = problems[:max_problems], names[:max_problems]
    n_real = len(problems)
    pad = (-n_real) % batch_size
    problems = problems + [problems[-1]] * pad
    use_mega = dev.type == "cuda"

    def sync():
        if use_mega:
            torch.cuda.synchronize(dev)

    if use_mega:

        def plan_fn(e, s_, g, m, budget, iter_count=None, block_count=None):
            return rrtc_mega.plan_batch_mega(spec, e, s_, g, m, settings, budget=budget,
                                             device=dev, iter_count=iter_count,
                                             block_count=block_count)

        solve_batch = _mega_solver(plan_fn, settings, retry_factor, sync)
        if simplify_mega.supports(simp_settings):

            def simp_fn(e, p, l):
                return simplify_mega.simplify_batch_mega(spec, e, p, l, simp_settings,
                                                         device=dev)

        else:

            def simp_fn(e, p, l):
                return simplify.simplify_batch_compact(spec, e, p, l, simp_settings,
                                                       device=dev)

    else:
        retry_settings = dataclasses.replace(
            settings, max_iterations=retry_factor * settings.max_iterations)

        def plan_fn(e, s_, g, m):
            return rrtc.plan_batch_compact(spec, e, s_, g, m, settings, segment_steps=64,
                                           device=dev)

        def retry_fn(e, s_, g, m):
            return rrtc.plan_batch_compact(spec, e, s_, g, m, retry_settings,
                                           segment_steps=64, min_batch=RETRY_B, device=dev)

        solve_batch = _lockstep_solver(plan_fn, retry_fn, RETRY_B, sync, dev,
                                       guard=(settings, retry_factor))

        def simp_fn(e, p, l):
            return simplify.simplify_batch_compact(spec, e, p, l, simp_settings, device=dev)

    phases: dict = {}
    # every call returns its phases, so it records spans alone: the planner's
    # counts are work on the card that only run_suite's callers ask for
    with profiling.recording(phases, counts=False):
        # sample + filter + build, timed per problem.  On the GPU the planner
        # reads the kernel form; the requested MVT / CAPT is built for its
        # build-time metric.  Environments are stacked on the host (pointcloud
        # structures padded to the batch's largest) and moved once.
        with profiling.span("pointcloud"):
            envs_list, filter_ns, build_ns = [], [], []
            for p in problems:
                b, _orig, _filt, f_ns, b_ns = pipeline.problem_to_pointcloud_env(
                    robot, p, pc_repr=pc_repr, samples_per_object=samples_per_object,
                    filter_type=filter_type, kernel_pc=use_mega)
                filter_ns.append(f_ns)
                build_ns.append(b_ns)
                with profiling.span("pc_stage"):
                    clouds = {"pck": b.pck} if use_mega else {pc_repr: getattr(b, pc_repr)}
                    envs_list.append(envmod.EnvironmentBuilder(**clouds).build(device="cpu"))
            with profiling.span("pc_stage"):
                envs = envmod.stack_environments(envs_list).to(dev)
                del envs_list
                G = max(len(p["goals"]) for p in problems)
                d = len(problems[0]["start"])
                starts = np.zeros((len(problems), d), np.float32)
                goals = np.zeros((len(problems), G, d), np.float32)
                masks = np.zeros((len(problems), G), bool)
                for i, p in enumerate(problems):
                    starts[i] = p["start"]
                    for g, goal in enumerate(p["goals"]):
                        goals[i, g] = goal
                        masks[i, g] = True
                starts, goals, masks = (torch.as_tensor(a, device=dev)
                                        for a in (starts, goals, masks))
                sync()

        with profiling.span("validity"):
            valid = _valid_fused(spec, envs, starts, goals, masks).cpu().numpy()[:n_real]

        with profiling.span("warmup"):
            if warmup and use_mega:
                # build and load every kernel outside the timed phases (see run_suite)
                e0, s0, g0, m0 = envs.map(lambda t: t[:1]), starts[:1], goals[:1], masks[:1]
                r0 = plan_fn(e0, s0, g0, m0, settings.max_iterations)
                plan_fn(e0, s0, s0[:, None].expand_as(g0), m0,
                        retry_factor * settings.max_iterations)
                simp_fn(e0, r0.path, r0.path_length)
            sync()

        plan_parts, simp_parts, t_plan, t_simp = _run_batches(
            envs, starts, goals, masks, batch_size, solve_batch, simp_fn, sync)
        with profiling.span("gather"):
            plan_res, simp_res = _gather(plan_parts, n_real), _gather(simp_parts, n_real)
    suite = SuiteResult(names, plan_res, simp_res, valid, t_plan, t_simp)
    f_ns = np.asarray(filter_ns[:n_real], np.float64)
    b_ns = np.asarray(build_ns[:n_real], np.float64)
    timings = {
        "filter_ns": f_ns,
        "build_ns": b_ns,
        "filter_median_ms": float(np.median(f_ns)) / 1e6,
        "build_median_ms": float(np.median(b_ns)) / 1e6,
        "pc_repr": pc_repr,
        "filter_type": filter_type,
        "phases": phases,
    }
    return suite, timings


def _mega_solver(plan_fn, settings, factor: int, sync):
    """solve_batch of the mega path: plan at the budget, then replan the
    unsolved problems alone with the same kernel at `factor` x the budget
    and write their results back in place (a row's search does not depend
    on its place in the batch, so the kernel gives the few live rows whole
    clusters of SMs, rrtc_mega_cuda.cluster_size).  Under a recorder it
    counts retry_live, the rows the retry plans, and has plan_fn count the
    retry launch's retry_iter_us, its slowest problem's us an iteration, and
    retry_blocks, its blocks (rrtc_mega.plan_batch_mega)."""

    def solve_batch(e, s_, g, m):
        with profiling.span("plan"):
            pr = plan_fn(e, s_, g, m, settings.max_iterations)
            sync()
        with profiling.span("retry"):
            um = ~pr.solved
            if profiling.counting():
                profiling.count("retry_live", um.sum())
            if bool(um.any()):
                _check_retry_room(pr, um, m, settings, factor)
                idx = torch.nonzero(um).squeeze(1)
                rr = plan_fn(e.map(lambda t: t[idx]), s_[idx], g[idx], m[idx],
                             factor * settings.max_iterations, iter_count="retry_iter_us",
                             block_count="retry_blocks")
                pr = type(pr)(*(o.index_copy(0, idx, n) for o, n in zip(pr, rr)))
                sync()
        return pr

    return solve_batch


def _check_retry_room(pr, unsolved, masks, settings, factor: int) -> None:
    """The retry replays the same search with a larger budget, so a problem
    that filled the node buffer would fill it again: refuse it."""
    n_nodes = pr.size_start + pr.size_goal + (~masks).sum(1)
    full = unsolved & (n_nodes >= settings.max_samples)
    if bool(full.any()):
        raise ValueError(
            f"max_samples={settings.max_samples} cannot hold the {factor}x "
            f"retry: {int(full.sum())} problems filled the node "
            "buffer within the first budget; raise max_samples")


def _lockstep_solver(plan_fn, retry_fn, retry_b: int, sync, dev, guard=None):
    """solve_batch of the lockstep path: plan, then rerun the stragglers with
    retry_fn in fixed-size batches of retry_b and write their results back in
    place.  guard = (settings, factor) refuses a retry that replays the same
    search in the same node buffer (_check_retry_room).  Counts retry_live,
    the stragglers rerun."""

    def solve_batch(e, s_, g, m):
        with profiling.span("plan"):
            pr = plan_fn(e, s_, g, m)
            sync()
        with profiling.span("retry"):
            unsolved = ~pr.solved.cpu().numpy()
            profiling.count("retry_live", int(unsolved.sum()))
            if unsolved.any():
                if guard is not None:
                    _check_retry_room(pr, torch.as_tensor(unsolved, device=dev), m, *guard)
                idx = np.flatnonzero(unsolved)
                pr = type(pr)(*(t.clone() for t in pr))
                for off in range(0, len(idx), retry_b):
                    part = idx[off : off + retry_b]
                    take = torch.as_tensor(np.resize(part, retry_b), device=dev)
                    rr = retry_fn(e.map(lambda t: t[take]), s_[take], g[take], m[take])
                    rows = torch.as_tensor(part, device=dev)
                    for dst, src in zip(pr, rr):
                        dst[rows] = src[: len(part)]
                sync()
        return pr

    return solve_batch


def _run_batches(envs, starts, goals, masks, batch_size, solve_batch, simp_fn, sync):
    """Plan and simplify every batch of `batch_size` problems, in the spans
    plan, retry (solve_batch's) and simplify.  Returns the per-batch plan and
    simplify results and the plan and simplify seconds."""
    plan_parts, simp_parts = [], []
    t_plan = t_simp = 0.0
    for i in range(0, starts.shape[0], batch_size):
        sl = slice(i, i + batch_size)
        e, s_, g, m = envs.map(lambda t: t[sl]), starts[sl], goals[sl], masks[sl]
        t0 = time.perf_counter()
        pr = solve_batch(e, s_, g, m)
        t1 = time.perf_counter()
        with profiling.span("simplify"):
            sr = simp_fn(e, pr.path, pr.path_length)
            sync()
        t2 = time.perf_counter()
        t_plan += t1 - t0
        t_simp += t2 - t1
        plan_parts.append(pr)
        simp_parts.append(sr)
    return plan_parts, simp_parts, t_plan, t_simp


def _gather(parts, n_real: int):
    """Per-batch result tuples -> one tuple of host arrays, first n_real rows."""
    host = [_to_numpy(p) for p in parts]
    return type(host[0])(*(np.concatenate(xs)[:n_real] for xs in zip(*host)))
