#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (vamp_mvt_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as one JSON line (no failure is caught: a failed check
or an exception exits non-zero):

  card           nvidia-smi's name and power limit, torch and CUDA versions
  build          the five kernels (csrc/fkcc.cu, csrc/rrtc_mega.cu,
                 csrc/simplify_mega.cu, csrc/probe_gather.cu,
                 csrc/probe_mosaic.cu) built with nvcc into build/, one nvcc
                 each, all at once (or loaded from there), and what ptxas
                 reported for each
  kernel         700 seeded MBM-shaped Panda scenes (every primitive table) x
                 1024 seeded configurations: the fkcc kernel against its plain
                 PyTorch version on the card (validity may differ only where
                 the plain minimum signed value is within 1e-5 of contact),
                 with the kernel's time, the plain version's time and the
                 bound of the card
  suite          run_suite("panda", planner="xla") on 700 seeded sphere-cage
                 problems (VAMP's sphere_cage_example with every sphere moved
                 by up to 0.01): all valid and solved, every simplified path
                 revalidated on the card, the fkcc kernel launched
  rrtc_mega      the planner megakernel against its plain version (the
                 lockstep planner): exactly on the sphere-robot wall problem
                 at (K, C, W) = (1, 1, 1) and (4, 2, 2), with a runtime
                 budget and the retry's start-replaced goals; then on the 700
                 cages at run_suite's mega settings (at least MIN_SHARE of
                 the results identical), times, work counters and the bound
  simplify_mega  the simplify megakernel against its plain version on the
                 plain planner's 700 cage paths: shares with equal path
                 length and with cost within rtol 1e-5 (each at least
                 MIN_SHARE), times and the bound
  suite_mega     the port's main path, run_suite("panda", planner="mega"), on
                 the 700 cages (valid = solved = 700, every simplified path
                 revalidated, both megakernels launched, median simplified
                 cost within 1% of the plain versions' at the same settings),
                 then on the 700 MBM-shaped scenes with starts and goals drawn
                 from configurations the fkcc kernel found valid (every solved
                 path revalidated)
  fkcc_bench_path
                 the fkcc launches of that path on the cages, the start and
                 goal validity and the direct-goal check, each against its
                 plain version, with its time and bound
  rrtc_mega_mbm_shaped
                 the planner megakernel against its plain version on the
                 first MBM_CHECK of those scenes (capsule and cuboid tables),
                 at the budget and as run_suite's 32x retry: at least
                 MIN_SHARE of the results identical at each, every solved
                 path revalidated by the plain version
  mega_interleave
                 the planner kernel's interleaved cadence (interleave=True:
                 the grow part every step, an active connect chain riding
                 along) against its plain version (the lockstep planner with
                 interleave=True): exactly on the wall problem, at least
                 MIN_SHARE identical on the 700 cages and on the MBM_CHECK
                 MBM-shaped scenes at the budget and the 32x retry (each
                 divergence replayed with index-order dots), every solved
                 path revalidated by the plain version; both cadences'
                 kernel ms, grow and connect steps, solved counts and solves
                 past the path buffer on the same problems; the interleaved
                 main path run_suite(planner="mega") on the cages; the A/B
                 suite walls of bench/interleave.py on the cages and on 700
                 MBM-shaped problems
  pc_kernel      the 700 scenes again, start and goal drawn from the
                 configurations the fkcc kernel finds valid among their
                 cylinders and boxes (the obstacles a cloud samples); their
                 pointclouds built as run_suite_pointcloud builds them
                 (PC_SAMPLES surface samples an object, SCDF, the kernel
                 form); the fkcc kernel against its plain version
                 (pc_vmin_plain) on the first PC_CHECK x 1024
                 configurations: no validity mismatch outside the contact
                 band, both outcomes, the counted work and the bound
  suite_pointcloud
                 this slice's main path, run_suite_pointcloud("panda") at its
                 defaults on those scenes (again at run_suite's 16384 node
                 rows if its guard refuses the 16x retry at 4096): every
                 kernel launched and evaluated pointcloud points, every solved
                 simplified path revalidated by the plain version
  rrtc_mega_pc / simplify_mega_pc
                 each megakernel against its plain version on the first
                 PC_CHECK pointcloud scenes at the budget: at least MIN_SHARE
                 identical, times, work counters and the bound
  probe_gather   the six gather probes (csrc/probe_gather.cu, off the main
                 path) against numpy, with ns per gather and the launches of
                 the probe entry point
  attach_kernel  700 seeded sphere cages, each with a seeded payload (1-4
                 spheres along the EE axis, one payload in ten above every
                 radius class) x the kernel phase's 1024 configurations: the
                 fkcc kernel against its plain version (no validity mismatch
                 outside the contact band, both outcomes, some configurations
                 that only the payload makes invalid), times and the bound
  hf_kernel      700 seeded Panda terrain scenes (250 x 250 cells of 1 cm, a
                 few MBM-shaped primitives each) and the sphere robot over
                 700 seeded 200 x 200 mazes of 4 cm, its limits past their
                 footprint: the same checks, outside the contact band and the
                 cell band (a centre within CELL_BAND of a cell edge)
  api            this slice's entry path, vamp_mvt_tpu_torch's user API, on the
                 card and with device="cpu": examples/attachments.py's payload
                 in the sphere cage (validate, rrtc, simplify, validate_motion
                 of every segment, debug, fk, eefk) and sphere.rrtc over a
                 maze; all solved, every path revalidated by the plain
                 version, card against CPU reported; the fkcc kernel against
                 its plain version on the API's own tables (one problem, a
                 shared payload and heightfield) at API_CHECK seeded
                 configurations and the paths' vertices
  mega_attach / mega_hf
                 both megakernels against their plain versions on the first
                 BRANCH_CHECK payload cages and terrain scenes (start and goal
                 the first two configurations the fkcc kernel found valid),
                 at least MIN_SHARE identical, each planner divergence rerun
                 with the kernel's index-order dot products; then
                 plan_batch_mega + simplify_batch_mega on all of them at
                 run_suite's mega settings, every solved path revalidated by
                 the plain version
  probe_mosaic   the fifteen Mosaic probes (csrc/probe_mosaic.cu, off the main
                 path) on PROBE_TILES tiles against their plain versions and
                 numpy, tile 0 against the probe files' constants; times,
                 bounds and a PyTorch call's time where one computes the
                 probe's function
  suite_robots   run_suite(robot, planner="mega") at its defaults on UR5,
                 Fetch and Baxter, each over ROBOT_SCENES problems: the
                 first ROBOT_SCENES of ROBOT_POOL MBM-shaped scenes in which
                 the fkcc kernel finds two seeded configurations valid for
                 the robot, those two as start and goal: every problem valid,
                 every solved path revalidated by the plain version, both
                 megakernels launched and against their plain versions on
                 the first ROBOTS_CHECK problems; the launches' threads,
                 shared memory and blocks per SM
  api_planners   panda.prm, panda.fcit and panda.roadmap at the API's
                 defaults on the card from VAMP's start A to goal B in the
                 sphere cage: solved, every path segment and roadmap edge
                 revalidated by the plain version, ms and fkcc launches a
                 call; the fkcc kernel against its plain version on PRM's
                 largest edge wave; the card against device="cpu" on
                 tests/test_planners.py's sphere-robot wall cases
  fkcc_paths     the fkcc kernel at the launch shapes of the one-problem
                 paths (bench/time_fkcc.py's cases): a panda.rrtc lockstep
                 step in the API's payload cage, a sphere.rrtc step over the
                 API's maze, PRM's sample wave and an edge wave of its
                 largest size, one FCIT edge; each against its plain
                 version (no validity mismatch outside the contact and cell
                 bands), with its time, bound and launch shape
  bench          the port's bench entry (python -m vamp_mvt_tpu_torch.bench)
                 in this process on the 700 cages: its JSON line

Every kernel's lines and rows carry each launch's shape and occupancy
(threads, lanes a configuration, blocks and warps an SM, registers; the
megakernels' and fkcc's LAST_LAUNCH), and the megakernels' rows each
phase's share of the blocks' clock cycles (`phase_share`).  The suite
phases report `past_max_path`: the planner kernel's solves whose
two chains together pass max_path, counted unsolved (rrtc_mega.PAST_MAX_PATH;
a problem the retry replays counts once in each call); suite_robots lists the
first UNSOLVED_LISTED unsolved problems of each robot.

then the kernels line (the pointcloud, attachment and heightfield branches of
each kernel, the megakernels on each other robot and fkcc on the PRM and
FCIT paths as rows of their own, with the launches of the path that runs
them; fkcc's attachment and heightfield rows at the API's step; the probes'
rows with the launches of their entry point) and, last, {"ok": true, "device": {...}}.  The script imports nothing of JAX or of the JAX package.  Without a
GPU it exits 1.
"""

import json
import os
import subprocess
import sys
import time

KERNEL_PROBLEMS = 700
KERNEL_CONFIGS = 1024
SUITE_PROBLEMS = 700
MEGA_PROBLEMS = 700
CONTACT_BAND = 1e-5
# the megakernels hold these against their plain versions
PLAN_RTOL = 1e-6
SIMPLIFY_RTOL = 1e-5
# The wall problem must match exactly.  At Panda width the plain nearest-
# neighbour dot is a cuBLAS matmul (its own summation order, with FMA) where
# the kernel sums in index order without FMA: a 1-ulp difference can flip a
# near-tie, and from there the two trees differ.  The simplifiers may part
# where a checked point lies within CONTACT_BAND of contact.  So on the cages
# and the MBM-shaped scenes the share of identical results must reach
# MIN_SHARE.
MIN_SHARE = 0.95
MBM_CHECK = 64  # MBM-shaped scenes the planner is compared on
PC_CHECK = 64   # pointcloud scenes the kernels are compared on
PC_SAMPLES = 10000  # surface samples per object (run_suite_pointcloud's default)
PC_RETRY_SAMPLES = 16384  # run_suite's node rows, if the 4096 of the pointcloud suite fill
PROBE_TILES = 4096  # (8, 128) index tiles a gather probe reads
BRANCH_PROBLEMS = 700  # payload cages, terrain scenes and mazes
BRANCH_CHECK = 64      # of them, the megakernels are compared on
CELL_BAND = 1e-4       # a centre this close to a heightfield cell edge
API_CHECK = 4096       # seeded configurations the API's tables are checked on
ATTACH_SRC = "vamp_mvt_tpu/ops/kernels/fkcc_pallas.py:215-246"  # the attachment branch
HF_SRC = "vamp_mvt_tpu/ops/kernels/fkcc_pallas.py:459-505"      # the heightfield branch
OTHER_ROBOTS = ("ur5", "fetch", "baxter")
ROBOT_SCENES = 256     # problems of suite_robots, per robot: scenes with two valid configurations
ROBOT_POOL = 2048      # MBM-shaped scenes drawn for them (placed for the Panda, most block Fetch)
ROBOTS_CHECK = 64      # of their problems, the megakernels are compared on
UNSOLVED_LISTED = 8    # of their unsolved problems, listed (scene row, start, goal)
# H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor cores, HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok, what: str) -> None:
    """A failed check ends the run (a check, not an assert: -O keeps it)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def wall_problem(dev, B: int = 3):
    """The sphere-robot wall problem of tests/test_mega.py: a wall of spheres
    with a gap, B problems whose goals differ by 0.05 each."""
    import numpy as np
    import torch

    from vamp_mvt_tpu_torch.collision import environment as envmod
    from vamp_mvt_tpu_torch.robots import registry

    b = envmod.EnvironmentBuilder()
    for y in np.linspace(-3, 3, 13):
        for z in np.linspace(0, 3, 7):
            if not (y > 2.0 and z > 2.0):
                b.add_sphere([0.0, y, z], 0.3)
    envs = envmod.broadcast_environment(b.build(device=dev), B)
    starts = torch.tensor([[-2.0, 0.0, 1.0]] * B, device=dev)
    goals = (torch.tensor([[[2.0, 0.0, 1.0]]] * B, device=dev)
             + torch.arange(B, device=dev)[:, None, None] * 0.05)
    masks = torch.ones((B, 1), dtype=torch.bool, device=dev)
    spec = registry.sphere_spec(lows=(-3, -3, 0), highs=(3, 3, 3), radius=0.1)
    return spec, envs, starts, goals, masks


def same_plan(a, b):
    """(B,) bool: planner results equal in solved flags, iterations, tree
    sizes and path lengths, costs within PLAN_RTOL, paths within 1e-6."""
    import torch

    eq = torch.ones_like(a.solved)
    for f in ("solved", "iterations", "size_start", "size_goal", "path_length"):
        eq &= getattr(a, f) == getattr(b, f)
    finite = torch.isfinite(b.cost)
    eq &= torch.where(finite, (a.cost - b.cost).abs() <= PLAN_RTOL * b.cost.abs(),
                      a.cost == b.cost)
    k = torch.arange(a.path.shape[1], device=a.path.device)
    close = ((a.path - b.path).abs().amax(-1) <= 1e-6) | (k[None] >= b.path_length[:, None])
    return eq & close.all(1)


def paths_revalidate(spec, envs, paths, lengths):
    """(B,) bool: every segment of each path is collision-free on the card."""
    import numpy as np
    import torch

    from vamp_mvt_tpu_torch.planning import validate

    paths = torch.as_tensor(paths, device=envs.spheres.device)
    lengths = torch.as_tensor(lengths, device=paths.device)
    num = validate.n_points_bound(spec, float(np.linalg.norm(spec.limits_high - spec.limits_low)))
    ok = validate.validate_motion_batch(spec, envs, paths[:, :-1], paths[:, 1:], num)
    k = torch.arange(1, paths.shape[1], device=paths.device)
    return (ok | (k[None] >= lengths[:, None])).all(1)


def paths_revalidate_plain(spec, envs, paths, lengths):
    """(B,) bool: every segment of each path is collision-free under the
    plain version (fkcc_vmin_plain, on the card), checked at its own points
    k / N, k = 1..N, N = 8 * ceil(length * resolution / 8): validate.py's
    points, which the kernels check."""
    import torch

    from vamp_mvt_tpu_torch.ops.kernels import fkcc_cuda
    from vamp_mvt_tpu_torch.planning import validate

    dev = envs.spheres.device
    paths = torch.as_tensor(paths, device=dev)
    res8 = spec.resolution / validate.RAKE
    qs = []
    for b, n in enumerate(torch.as_tensor(lengths).tolist()):
        if n < 2:
            qs.append(paths[b, :1])
            continue
        a = paths[b, : n - 1]
        v = paths[b, 1:n] - a
        N = validate.RAKE * torch.clamp_min(torch.ceil(validate.norm_last(v) * res8), 1.0)
        seg = torch.repeat_interleave(torch.arange(n - 1, device=dev), N.long())
        first = torch.cumsum(N, 0) - N
        k = torch.arange(seg.shape[0], device=dev, dtype=torch.float32) - first[seg] + 1.0
        qs.append(a[seg] + v[seg] * (k / N[seg])[:, None])
    T = max(x.shape[0] for x in qs)
    q = torch.stack([torch.cat([x, x[-1:].expand(T - x.shape[0], -1)]) for x in qs])
    return (fkcc_cuda.fkcc_vmin_plain(spec, envs, q) >= 0).all(1)


def pointcloud_envs(problems):
    """The kernel form of each Panda problem's cloud, built as
    run_suite_pointcloud builds it (pointcloud/pipeline.py: PC_SAMPLES
    surface samples an object, SCDF), stacked on the host."""
    from vamp_mvt_tpu_torch.collision import environment as envmod
    from vamp_mvt_tpu_torch.pointcloud import pipeline

    envs = []
    for p in problems:
        b = pipeline.problem_to_pointcloud_env("panda", p, pc_repr="capt",
                                               samples_per_object=PC_SAMPLES)[0]
        envs.append(envmod.EnvironmentBuilder(pck=b.pck).build(device="cpu"))
    return envmod.stack_environments(envs)


def bound(ops: int, n_bytes: int) -> dict:
    """The card's least time for `ops` FP32 operations moving `n_bytes`."""
    ops_ms = ops / PEAK_FP32_FLOPS * 1e3
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    return {"fp32_ops": int(ops), "bytes": int(n_bytes), "ops_bound_ms": ops_ms,
            "bytes_bound_ms": bytes_ms, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def median(t) -> float:
    """numpy's median (the mean of the middle two), as summary() takes it."""
    import numpy as np

    return float(np.median(t.cpu().numpy()))


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def time_cuda(fn, warmup: int, reps: int) -> float:
    """Median milliseconds of `fn` over `reps` CUDA-event-timed calls."""
    import numpy as np
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def live_payload(envs):
    """(B,) the payload spheres of each problem that have a radius (the
    radius-0 rows that pad a payload to ATTACH_ROWS check nothing), or 0."""
    if envs.attachment is None:
        return 0
    return (envs.attachment.spheres[..., 3] > 0).sum(-1).cpu().numpy()


def hf_reads(spec, envs, q):
    """For q (B, N, d) over heightfield tables: the distinct (problem, field,
    cell) heights the fkcc kernel reads (one a staged sphere, payload
    included, field and configuration), and (B, N) bool, a centre within
    CELL_BAND of a cell edge."""
    import torch

    from vamp_mvt_tpu_torch.collision import primitives
    from vamp_mvt_tpu_torch.ops import fkcc

    meta = envs.hf_meta[:, None]
    centers = fkcc.staged_centers(spec, envs.map(lambda t: t[:, None]), q)
    Nh, C = envs.hf_meta.shape[1], envs.hf_data.shape[2]
    cells = primitives.heightfield_cells(meta, C, centers).long()       # (B, N, S + A, Nh)
    row = torch.arange(envs.hf_meta.shape[0], device=q.device)[:, None, None, None]
    key = (row * Nh + torch.arange(Nh, device=q.device)) * C + cells
    return (int(torch.unique(key).numel()),
            primitives.heightfield_cell_band(meta, centers, CELL_BAND))


def heights_at_most(spec, envs, checks, n_att) -> int:
    """Bytes of heights a megakernel reads for `checks` (B,) configurations
    of each problem: one a staged sphere, field and configuration, and no
    more than the problem's table."""
    import numpy as np

    Nh, C = envs.hf_meta.shape[1], envs.hf_data.shape[2]
    per = np.minimum(np.asarray(checks, np.int64) * (spec.n_spheres + n_att) * Nh, Nh * C)
    return 4 * int(np.sum(per))


def branch_kernel(spec, envs, q, layout="lanes"):
    """The fkcc kernel against its plain version on `envs` (payload and/or
    heightfield tables): validity outside the contact band and the cell
    band, both outcomes, times (of the launch in `layout`, rows or lanes)
    with its launch shape and occupancy, and the bound (the live payload
    spheres' operations; the heights read, not the whole table); and the
    kernel's validity."""
    import numpy as np
    import torch

    from vamp_mvt_tpu_torch.collision.environment import LIVE_LIMIT, TABLES
    from vamp_mvt_tpu_torch.ops.kernels import fkcc_cuda

    B, N = q.shape[:2]
    n_hf = envs.hf_meta.shape[1]
    q_d = q.transpose(1, 2).contiguous()
    vk = fkcc_cuda.fkcc_vmin(spec, envs, q)
    ok = fkcc_cuda.fkcc_batched_lanes(spec, envs, q_d)
    vp = fkcc_cuda.fkcc_vmin_plain(spec, envs, q)
    torch.cuda.synchronize()
    check(torch.equal(ok, vk >= 0), "kernel validity agrees with its own vmin")
    contact = vp.abs() <= CONTACT_BAND
    heights, cells = hf_reads(spec, envs, q) if n_hf else (0, torch.zeros_like(contact))
    mism = (vk >= 0) != (vp >= 0)
    outside = mism & ~contact & ~cells
    live = {n: (getattr(envs, n)[..., 0].abs() < LIVE_LIMIT).sum(-1).cpu().numpy() for n in TABLES}
    launch = (lambda: fkcc_cuda.fkcc_batched_lanes(spec, envs, q_d)) if layout == "lanes" \
        else (lambda: fkcc_cuda.fkcc_batched(spec, envs, q))
    k_ms = time_cuda(launch, 3, 20)
    occupancy = dict(fkcc_cuda.LAST_LAUNCH)
    p_ms = time_cuda(lambda: fkcc_cuda.fkcc_batched_plain(spec, envs, q), 1, 3)
    tabs = fkcc_cuda.robot_tables(spec)
    extra = [] if envs.attachment is None else list(envs.attachment)
    b = bound(fkcc_cuda.op_count(spec, live, N, live_payload(envs), n_hf),
              nbytes(q, envs.hf_meta, *extra, *(getattr(envs, n) for n in TABLES)) + 4 * heights
              + sum(v.nbytes for v in tabs.values() if isinstance(v, np.ndarray)) + B * N)
    return {"problems": B, "configs_per_problem": N, "valid_share": float((vk >= 0).float().mean()),
            "mismatches": int(mism.sum()), "inside_contact_band": int(contact.sum()),
            "inside_cell_band": int(cells.sum()), "mismatches_outside_bands": int(outside.sum()),
            "heights_read": heights,
            "max_abs_err": float((vk - vp).abs()[~contact & ~cells].max()),
            "kernel_ms": k_ms, "layout": layout, "occupancy": occupancy, "plain_ms": p_ms, **b,
            "library_ms": None}, ok


def index_order_replay(spec, envs, st, gl, mk, settings, kp, rows) -> dict:
    """{problem: bool} for problems where the planner kernel and the plain
    planner differ: whether the plain planner, rerun on them with
    rrtc.IndexOrderTorch's dot products, equals the kernel.  True shows a near
    tie in a nearest-neighbour scan that cuBLAS's summation order resolved
    the other way."""
    import torch

    from vamp_mvt_tpu_torch.planning import rrtc

    if not rows:
        return {}
    idx = torch.as_tensor(rows, device=st.device)
    real = rrtc.torch
    rrtc.torch = rrtc.IndexOrderTorch()
    try:
        pp = rrtc.plan_batch_compact(spec, envs.map(lambda t: t[idx]), st[idx], gl[idx],
                                     mk[idx], settings, device=st.device,
                                     interleave=settings.interleave)
    finally:
        rrtc.torch = real
    same = same_plan(type(kp)(*(t[idx] for t in kp)), pp)
    return {r: bool(s) for r, s in zip(rows, same.tolist())}


def mega_compare(spec, envs, st, gl, mk, settings, ss) -> dict:
    """Both megakernels against their plain versions at the budget: shares
    of identical results (and, for the planner's divergent problems, the
    index-order replay), times, work counters and bounds."""
    import numpy as np
    import torch

    from vamp_mvt_tpu_torch.collision.environment import LIVE_LIMIT, TABLES
    from vamp_mvt_tpu_torch.ops.kernels import fkcc_cuda, rrtc_mega_cuda, simplify_mega_cuda
    from vamp_mvt_tpu_torch.planning import rrtc, rrtc_mega, simplify_mega

    dev = st.device
    B, d = st.shape
    live = {n: (getattr(envs, n)[..., 0].abs() < LIVE_LIMIT).sum(-1).cpu().numpy() for n in TABLES}
    n_att = live_payload(envs)
    per_cfg = fkcc_cuda.ops_per_config(spec, live, n_att, envs.hf_meta.shape[1])
    tables = [envs.hf_meta, *(getattr(envs, n) for n in TABLES)]
    tables += [] if envs.attachment is None else list(envs.attachment)
    kp = rrtc_mega.plan_batch_mega(spec, envs, st, gl, mk, settings, device=dev)
    t0 = time.perf_counter()
    pp = rrtc.plan_batch_compact(spec, envs, st, gl, mk, settings, device=dev)
    torch.cuda.synchronize()
    r_plain = (time.perf_counter() - t0) * 1e3
    same = same_plan(kp, pp)
    diverged = torch.nonzero(~same).flatten().tolist()
    replay = index_order_replay(spec, envs, st, gl, mk, settings, kp, diverged[:4])
    ctl, nodes0, _, _ = rrtc_mega.mega_inputs(spec, envs, st, gl, mk, settings)
    _, r_scal, r_work = rrtc_mega_cuda.plan(spec, envs, ctl, nodes0, settings)
    r_work = r_work.cpu().numpy().astype(np.int64)
    r_launch = launch_line(rrtc_mega_cuda, r_work)
    r_ms = time_cuda(lambda: rrtc_mega_cuda.plan(spec, envs, ctl, nodes0, settings), 1, 3)
    r_bound = bound(int(np.sum(r_work[:, 0] * per_cfg))
                    + int(r_work[:, 1].sum()) * rrtc_mega_cuda.ops_per_pair(d),
                    nbytes(ctl, nodes0, *tables) + int(r_scal[:, 6].sum()) * (d + 4) * 4
                    + heights_at_most(spec, envs, r_work[:, 0], n_att)
                    + B * (settings.max_path * d + rrtc_mega_cuda.SCALARS
                           + 2 * r_work.shape[1]) * 4)
    k_ = torch.arange(kp.path.shape[1], device=dev)
    r_err = float(torch.where((k_[None] < pp.path_length[:, None])[..., None],
                              (kp.path - pp.path).abs(), 0).max())
    sp_in, sl_in = pp.path.contiguous(), pp.path_length.to(torch.int32)
    ks = simplify_mega.simplify_batch_mega(spec, envs, pp.path, pp.path_length, ss, device=dev)
    t0 = time.perf_counter()
    ps = simplify_mega.simplify_batch_plain(spec, envs, pp.path, pp.path_length, ss)
    torch.cuda.synchronize()
    s_plain = (time.perf_counter() - t0) * 1e3
    s_len = ks.path_length == ps.path_length
    s_cost = (ks.cost - ps.cost).abs() <= SIMPLIFY_RTOL * ps.cost.abs()
    s_work = simplify_mega_cuda.simplify(spec, envs, sp_in, sl_in, ss)[2].cpu().numpy()
    s_launch = launch_line(simplify_mega_cuda, s_work)
    s_ms = time_cuda(lambda: simplify_mega_cuda.simplify(spec, envs, sp_in, sl_in, ss), 1, 3)
    s_bound = bound(int(np.sum(s_work[:, 0].astype(np.int64) * per_cfg)),
                    2 * nbytes(sp_in) + nbytes(sl_in, *tables) + B * (2 * 4 + 32)
                    + heights_at_most(spec, envs, s_work[:, 0], n_att))
    s_err = float(torch.where(s_len[:, None, None], (ks.path - ps.path).abs(), 0).max())
    return {
        "rrtc_mega": {"problems": B, "identical_share": float(same.float().mean()),
                      "solved": {"kernel": int(kp.solved.sum()), "plain": int(pp.solved.sum())},
                      "diverged": diverged, "index_order_plain_equals_kernel": replay,
                      "done_past_max_path": int(((r_scal[:, 0] > 0) & (
                          r_scal[:, 11] + r_scal[:, 12] > settings.max_path)).sum()),
                      "ms": r_ms, "plain_ms": r_plain, "max_abs_err": r_err,
                      "work": {"configs": int(r_work[:, 0].sum()), "pairs": int(r_work[:, 1].sum())},
                      **r_launch, **r_bound, "library_ms": None},
        "simplify_mega": {"problems": B, "equal_length_share": float(s_len.float().mean()),
                          "cost_rtol_share": float(s_cost.float().mean()),
                          "ms": s_ms, "plain_ms": s_plain, "max_abs_err": s_err,
                          "configs": int(s_work[:, 0].sum()), **s_launch, **s_bound,
                          "library_ms": None},
    }


def retry_compare(spec, envs, st, gl, mk, settings) -> dict:
    """The planner kernel against its plain version (in the cadence
    `settings.interleave` names) at the budget, then as run_suite's retry
    (32x the budget, the solved rows' goals replaced by their starts), where
    the shares are over the retried rows: at least MIN_SHARE identical at
    each, every solved path revalidated by the plain version."""
    import dataclasses

    import torch

    from vamp_mvt_tpu_torch.planning import rrtc, rrtc_mega

    dev = st.device
    out, g, retried = {}, gl, torch.ones(len(st), dtype=torch.bool, device=dev)
    for budget in (settings.max_iterations, 32 * settings.max_iterations):
        check(bool(retried.any()), f"problems to compare at budget {budget}")
        rrtc_mega.PAST_MAX_PATH = 0
        t0 = time.perf_counter()
        got = rrtc_mega.plan_batch_mega(spec, envs, st, g, mk, settings, budget=budget,
                                        device=dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ref = rrtc.plan_batch_compact(spec, envs, st, g, mk,
                                      dataclasses.replace(settings, max_iterations=budget),
                                      device=dev, interleave=settings.interleave)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        same = same_plan(got, ref)[retried]
        ok = paths_revalidate_plain(spec, envs, got.path, got.path_length)
        out[str(budget)] = {
            "problems": int(retried.sum()), "identical": int(same.sum()),
            "solved": {"kernel": int(got.solved[retried].sum()),
                       "plain": int(ref.solved[retried].sum())},
            "past_max_path": rrtc_mega.PAST_MAX_PATH,
            "solved_paths_revalidated_plain": int((ok & got.solved)[retried].sum()),
            "kernel_s": t1 - t0, "plain_s": t2 - t1}
        check(float(same.float().mean()) >= MIN_SHARE,
              f"rrtc_mega (interleave={settings.interleave}) equals plain at budget {budget}")
        check(bool(ok[got.solved].all()), f"every solved path revalidates at budget {budget}")
        retried = ~got.solved
        g = torch.where(retried[:, None, None], gl, st[:, None])
    return out


def mega_path(spec, envs, st, gl, mk, settings, ss) -> dict:
    """plan_batch_mega + simplify_batch_mega on the whole batch (the counts
    of both megakernels reset just before, read just after), every solved
    path revalidated by the plain version from its first vertex on."""
    import torch

    from vamp_mvt_tpu_torch.ops.kernels import fkcc_cuda, rrtc_mega_cuda, simplify_mega_cuda
    from vamp_mvt_tpu_torch.planning import rrtc_mega, simplify_mega

    dev = st.device
    valid = fkcc_cuda.fkcc_batched(spec, envs, torch.cat([st[:, None], gl], 1)).all(1)
    for lib in (rrtc_mega_cuda, simplify_mega_cuda):
        lib.LAUNCHES = 0
    t0 = time.perf_counter()
    res = rrtc_mega.plan_batch_mega(spec, envs, st, gl, mk, settings, device=dev)
    simp = simplify_mega.simplify_batch_mega(spec, envs, res.path, res.path_length, ss,
                                             device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"rrtc_mega": rrtc_mega_cuda.LAUNCHES, "simplify_mega": simplify_mega_cuda.LAUNCHES}
    solved = res.solved & valid
    ok = paths_revalidate_plain(spec, envs, simp.path, simp.path_length) & \
        fkcc_cuda.fkcc_batched_plain(spec, envs, simp.path[:, :1])[:, 0]
    check(all(v == 1 for v in launches.values()), "the mega path launched both megakernels")
    check(int(solved.sum()) > 0, "the mega path solves some problems")
    check(bool(ok[solved].all()), "every solved path revalidates (plain)")
    return {"problems": st.shape[0], "valid": int(valid.sum()), "solved": int(solved.sum()),
            "wall_s": wall, "median_simplified_cost": median(simp.cost[solved]),
            "launches": launches, "solved_paths_revalidated_plain": int((ok & solved).sum())}


def cadence_run(spec, envs, st, gl, mk, settings, budget=None) -> dict:
    """The planner kernel in the cadence `settings.interleave` names, through
    plan_batch_mega: its result, the solves past the path buffer
    (rrtc_mega.PAST_MAX_PATH, set to 0 just before), then the wrapper on the
    same inputs for the step counters (scalars 9-10), the work counters and
    its time (CUDA events)."""
    import numpy as np
    import torch

    from vamp_mvt_tpu_torch.ops.kernels import rrtc_mega_cuda
    from vamp_mvt_tpu_torch.planning import rrtc_mega

    rrtc_mega.PAST_MAX_PATH = 0
    res = rrtc_mega.plan_batch_mega(spec, envs, st, gl, mk, settings, budget=budget,
                                    device=st.device)
    torch.cuda.synchronize()
    past = rrtc_mega.PAST_MAX_PATH
    ctl, nodes0, _, _ = rrtc_mega.mega_inputs(spec, envs, st, gl, mk, settings, budget=budget)
    _, scal, work = rrtc_mega_cuda.plan(spec, envs, ctl, nodes0, settings)
    launch = launch_line(rrtc_mega_cuda, work)
    ms = time_cuda(lambda: rrtc_mega_cuda.plan(spec, envs, ctl, nodes0, settings), 1, 3)
    scal = scal.cpu().numpy().astype(np.int64)
    return {"res": res, "ctl": ctl, "nodes0": nodes0, "scal": scal,
            "work": work.cpu().numpy().astype(np.int64), "line": {
                "ms": ms, "solved": int(res.solved.sum()), "past_max_path": past,
                "gsteps": int(scal[:, 9].sum()), "csteps": int(scal[:, 10].sum()),
                "gsteps_plus_csteps": int(scal[:, 9].sum() + scal[:, 10].sum()),
                "iterations_p50": float(np.median(res.iterations.cpu().numpy())),
                "nodes": int(scal[:, 6].sum()), **launch}}


def mega_interleave_phase(dev, spec, cages, c_envs, c_st, c_gl, c_mk, c_ops, mega_s,
                          mbm_problems, ss) -> dict:
    """The interleaved cadence of the planner kernel (interleave=True: the
    grow part every step, an active connect chain riding along): against
    its plain version (the lockstep planner with interleave=True) exactly on
    the wall problem, on the 700 cages (at least MIN_SHARE identical, the
    divergent ones replayed with the kernel's index-order dots) and on the
    MBM-shaped scenes at the budget and the 32x retry; every solved path
    revalidated by the plain version; both cadences' kernel ms, steps,
    solved counts and solves past the path buffer on the same problems; the
    interleaved main path, run_suite(planner="mega") on the cages (launches
    counted); the A/B suite walls of bench/interleave.py on the cages and on
    700 MBM-shaped problems.  Returns the kernels line's row."""
    import dataclasses

    import numpy as np
    import torch

    from vamp_mvt_tpu_torch.bench import interleave, mbm
    from vamp_mvt_tpu_torch.collision.environment import TABLES
    from vamp_mvt_tpu_torch.ops.kernels import fkcc_cuda, rrtc_mega_cuda, simplify_mega_cuda
    from vamp_mvt_tpu_torch.planning import rrtc, rrtc_mega

    inter_s = dataclasses.replace(mega_s, interleave=True)
    d = spec.dimension

    # the wall problem, exactly, at (K, C, W) = (1, 1, 1) and (4, 2, 2)
    spec_w, envs_w, st_w, gl_w, mk_w = wall_problem(dev)
    offs = torch.arange(3, device=dev, dtype=torch.int32) * 100
    wall, err = {}, 0.0
    for kcw in ((1, 1, 1), (4, 2, 2)):
        s_w = rrtc.RRTCSettings(range=1.0, max_iterations=384, max_samples=512, max_path=64,
                                samples_per_step=kcw[0], connect_segments=kcw[1],
                                sample_window=kcw[2], interleave=True)
        got = rrtc_mega.plan_batch_mega(spec_w, envs_w, st_w, gl_w, mk_w, s_w, offs, device=dev)
        ref = rrtc.plan_batch_compact(spec_w, envs_w, st_w, gl_w, mk_w, s_w, offs, device=dev,
                                      interleave=True)
        torch.cuda.synchronize()
        same = same_plan(got, ref)
        k = torch.arange(64, device=dev)
        live = (k[None] < ref.path_length[:, None])[..., None]
        err = max(err, float(torch.where(live, (got.path - ref.path).abs(), 0).max()))
        wall[str(kcw)] = {"identical": int(same.sum()), "solved": int(got.solved.sum()),
                          "iterations": got.iterations.tolist()}
        check(bool(same.all()), f"interleaved rrtc_mega equals plain on the wall problem, {kcw}")

    # both cadences on the 700 cages; the interleaved kernel against its plain version
    cad = {n: cadence_run(spec, c_envs, c_st, c_gl, c_mk, s)
           for n, s in (("alternating", mega_s), ("interleaved", inter_s))}
    kres = cad["interleaved"]["res"]
    t0 = time.perf_counter()
    pres = rrtc.plan_batch_compact(spec, c_envs, c_st, c_gl, c_mk, inter_s, device=dev,
                                   interleave=True)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    same = same_plan(kres, pres)
    diverged = torch.nonzero(~same).flatten().tolist()
    replay = index_order_replay(spec, c_envs, c_st, c_gl, c_mk, inter_s, kres, diverged[:4])
    reval = paths_revalidate_plain(spec, c_envs, kres.path, kres.path_length)
    check(float(same.float().mean()) >= MIN_SHARE, "interleaved rrtc_mega equals plain on the cages")
    check(bool(reval[kres.solved].all()), "every solved interleaved cage path revalidates (plain)")
    work = cad["interleaved"]["work"]
    r_bound = bound(
        int(np.sum(work[:, 0] * c_ops)) + int(work[:, 1].sum()) * rrtc_mega_cuda.ops_per_pair(d),
        nbytes(cad["interleaved"]["ctl"], cad["interleaved"]["nodes0"],
               *(getattr(c_envs, n) for n in TABLES))
        + int(cad["interleaved"]["scal"][:, 6].sum()) * (d + 4) * 4
        + len(c_st) * (mega_s.max_path * d + rrtc_mega_cuda.SCALARS
                       + 2 * (rrtc_mega_cuda.WORK + len(rrtc_mega_cuda.PHASES))) * 4)
    cages_line = {"problems": len(c_st), **{n: c["line"] for n, c in cad.items()},
                  "identical_share": float(same.float().mean()),
                  "solved_plain": int(pres.solved.sum()), "diverged": diverged,
                  "index_order_plain_equals_kernel": replay, "plain_ms": plain_ms,
                  "solved_paths_revalidated_plain": int((reval & kres.solved).sum()),
                  "work": {"configs": int(work[:, 0].sum()), "pairs": int(work[:, 1].sum())},
                  **r_bound}

    # the MBM-shaped scenes at the budget, then as run_suite's retry (32x,
    # the solved rows' goals replaced by their starts; shares over the
    # retried rows), both cadences' kernels at the budget
    b_envs, b_st, b_gl, b_mk = mbm.build_batch(mbm_problems, device=dev)
    mbm_line = {n: cadence_run(spec, b_envs, b_st, b_gl, b_mk, s)["line"]
                for n, s in (("alternating", mega_s), ("interleaved", inter_s))}
    mbm_line["by_budget"] = retry_compare(spec, b_envs, b_st, b_gl, b_mk, inter_s)

    # the interleaved main path on the cages, launches counted
    kernels = {"fkcc": fkcc_cuda, "rrtc_mega": rrtc_mega_cuda, "simplify_mega": simplify_mega_cuda}
    for lib in kernels.values():
        lib.LAUNCHES = 0
    rrtc_mega.PAST_MAX_PATH = 0
    tm = {}
    t0 = time.perf_counter()
    sres = mbm.run_suite("panda", data=cages, planner="mega", settings=inter_s, timings=tm)
    torch.cuda.synchronize()
    swall = time.perf_counter() - t0
    launches = {n: lib.LAUNCHES for n, lib in kernels.items()}
    past = rrtc_mega.PAST_MAX_PATH
    ssum = sres.summary()
    s_ok = paths_revalidate_plain(spec, c_envs, sres.simplified.path,
                                  sres.simplified.path_length).cpu().numpy()
    solved = np.asarray(sres.plan.solved) & sres.valid
    check(launches["rrtc_mega"] > 0, "the interleaved main path launched the planner kernel")
    check(bool(s_ok[solved].all()), "every solved interleaved simplified path revalidates")
    suite_line = {"wall_s": swall, "summary": ssum, "timings": tm, "launches": launches,
                  "past_max_path": past,
                  "solved_paths_revalidated_plain": int((s_ok & solved).sum())}

    # the A/B of bench/interleave.py (run_suite with interleave off and on)
    ab = {src: interleave.main(["panda", "700", "--source", src])
          for src in ("cages", "mbm_shaped")}
    check(ab["cages"]["speedup"] is not None, "the A/B ran both cadences on the cages")
    check("refused" not in ab["mbm_shaped"]["alternating"],
          "the A/B ran the alternating cadence on the MBM-shaped problems")
    emit({"phase": "mega_interleave", "settings": "run_suite's mega settings, interleave=True",
          "wall_problem": wall, "cages": cages_line, "mbm_shaped": mbm_line,
          "suite_mega_interleaved": suite_line, "ab": ab})
    return row("rrtc_mega", cad["interleaved"]["line"]["ms"], plain_ms, r_bound, err,
               launches["rrtc_mega"]) | {
        "name": "rrtc_mega_interleave", "replaces": "vamp_mvt_tpu/planning/rrtc_mega.py:943",
        "phase_share": cad["interleaved"]["line"]["phase_share"],
        "warps_per_sm": cad["interleaved"]["line"]["occupancy"]["warps_per_sm"],
        "replaces_function": "vamp_mvt_tpu/planning/rrtc_mega.py::_run_mega, interleave=True "
                             "(INTER, _make_mega_kernel)",
        "max_abs_err_of": "the wall problem's paths"}


def bench_phase() -> dict:
    """The port's bench entry (python -m vamp_mvt_tpu_torch.bench) run in
    this process on its default source: its JSON line, with the launches of
    the two suite runs it makes."""
    from vamp_mvt_tpu_torch.bench import __main__ as bench_main
    from vamp_mvt_tpu_torch.ops.kernels import fkcc_cuda, rrtc_mega_cuda, simplify_mega_cuda

    kernels = {"fkcc": fkcc_cuda, "rrtc_mega": rrtc_mega_cuda, "simplify_mega": simplify_mega_cuda}
    for lib in kernels.values():
        lib.LAUNCHES = 0
    line = bench_main.main([])
    launches = {n: lib.LAUNCHES for n, lib in kernels.items()}
    emit({"phase": "bench", **line, "launches": launches})
    check(line["metric"] == "mbm_panda_problems_per_sec" and line["value"] > 0
          and line["source"], "the bench entry prints its line")
    check(all(v > 0 for v in launches.values()), "the bench entry launched every kernel")
    return line


def api_phase(dev) -> tuple[dict, dict]:
    """This slice's entry path, vamp_mvt_tpu_torch's user API, on the card
    and with device="cpu": examples/attachments.py's payload in the sphere
    cage (validate, rrtc, simplify, validate_motion on every simplified
    segment, debug, fk, eefk), and sphere.rrtc over a seeded maze; then
    the fkcc kernel against its plain version on the API's own tables.
    Returns the phase line and the fkcc launches of each part on the card."""
    import numpy as np
    import torch

    import vamp_mvt_tpu_torch as vmt
    from vamp_mvt_tpu_torch.bench import profile_suite, scenes
    from vamp_mvt_tpu_torch.collision import environment as envmod
    from vamp_mvt_tpu_torch.ops.kernels import fkcc_cuda

    cage, A, B = profile_suite.api_cage()
    terrain = vmt.Environment()
    terrain.add_heightfield(*envmod.make_heightfield(*scenes.MAZE_META,
                                                     scenes.maze(np.random.default_rng(41))))
    S, G = [-4.0, -4.0, 1.0], [4.0, 4.0, 1.0]
    out, launches, results = {}, {}, {}

    for where in ("cuda", "cpu"):
        d = dev if where == "cuda" else "cpu"
        rec = out[where] = {}

        def timed(name, fn):
            t0 = time.perf_counter()
            r = fn()
            torch.cuda.synchronize()
            rec[name + "_ms"] = (time.perf_counter() - t0) * 1e3
            return r

        fkcc_cuda.LAUNCHES = 0
        valid = timed("validate", lambda: vmt.panda.validate(A, cage, device=d))
        res = timed("rrtc", lambda: vmt.panda.rrtc(A, B, cage, device=d))
        simple = timed("simplify", lambda: vmt.panda.simplify(res.path, res.path_length, cage,
                                                              device=d))
        path = simple.path.cpu().numpy()
        motions = timed("validate_motion", lambda: [
            vmt.panda.validate_motion(path[i], path[i + 1], cage, device=d)
            for i in range(int(simple.path_length) - 1)])
        dbg = timed("debug", lambda: vmt.panda.debug(A, cage, device=d))
        fk = timed("fk", lambda: vmt.panda.fk(A, device=d))
        ee = timed("eefk", lambda: vmt.panda.eefk(A, device=d))
        launches[where] = {"panda": fkcc_cuda.LAUNCHES}
        fkcc_cuda.LAUNCHES = 0
        s_ok = timed("sphere_validate", lambda: [vmt.sphere.validate(x, terrain, device=d)
                                                 for x in (S, G)])
        sres = timed("sphere_rrtc", lambda: vmt.sphere.rrtc(S, G, terrain, device=d))
        launches[where]["sphere"] = fkcc_cuda.LAUNCHES
        results[where] = (valid, res, simple, motions, dbg, fk, ee, s_ok, sres)
        check(valid and all(s_ok), f"the API's starts and goals are valid ({where})")
        check(bool(res.solved) and bool(sres.solved), f"the API solves both problems ({where})")
        check(all(motions), f"every simplified segment validates ({where})")

    # every returned path revalidated by the plain version on the card
    envs = {"panda": cage.build(dev).map(lambda t: t[None]),
            "sphere": terrain.build(dev).map(lambda t: t[None])}
    reval = {}
    for where, (_, res, simple, _, _, _, _, _, sres) in results.items():
        for name, spec, r in (("panda_rrtc", vmt.panda.spec, res),
                              ("panda_simplify", vmt.panda.spec, simple),
                              ("sphere_rrtc", vmt.sphere.spec, sres)):
            ok = paths_revalidate_plain(spec, envs[name.split("_")[0]],
                                        r.path[None].to(dev), r.path_length[None].to(dev))
            reval[f"{where}_{name}"] = bool(ok[0])
    check(all(reval.values()), "every path of the API revalidates (plain)")
    cu, cp = results["cuda"], results["cpu"]

    # the fkcc kernel against its plain version on the API's own tables (one
    # problem; a shared payload, a shared heightfield of 40,000 cells), at
    # seeded configurations over each module's limits and the vertices of
    # the card's paths
    rng = np.random.default_rng(43)
    held = {}
    for name, spec, paths in (("panda", vmt.panda.spec, (cu[1], cu[2])),
                              ("sphere", vmt.sphere.spec, (cu[8],))):
        qs = torch.as_tensor(rng.uniform(spec.limits_low, spec.limits_high,
                                         (API_CHECK, spec.dimension)), dtype=torch.float32)
        q = torch.cat([qs.to(dev)] + [r.path[: int(r.path_length)].to(dev) for r in paths])
        held[name] = branch_kernel(spec, envs[name], q[None])[0]
        check(held[name]["mismatches_outside_bands"] == 0,
              f"the kernel agrees with plain on the API's {name} tables outside the bands")

    def same(a, b):
        return (int(a.path_length) == int(b.path_length)
                and abs(float(a.cost) - float(b.cost)) <= 1e-5 * abs(float(b.cost)))

    identical = {"panda_rrtc": same(cu[1], cp[1]) and int(cu[1].iterations) == int(cp[1].iterations),
                 "panda_simplify": same(cu[2], cp[2]),
                 "sphere_rrtc": same(cu[8], cp[8]) and int(cu[8].iterations) == int(cp[8].iterations),
                 "debug": cu[4] == cp[4],
                 "fk_max_abs_diff": float(np.abs(cu[5] - cp[5]).max()),
                 "eefk_max_abs_diff": float(max(np.abs(a - b).max() for a, b in zip(cu[6], cp[6])))}
    check(launches["cuda"]["panda"] > 0 and launches["cuda"]["sphere"] > 0,
          "the API launched the fkcc kernel on the card")
    line = {"phase": "api", "times_ms": out, "fkcc_launches": launches["cuda"],
            "solved": {w: {"panda": bool(r[1].solved), "sphere": bool(r[8].solved)}
                       for w, r in results.items()},
            "iterations": {w: {"panda": int(r[1].iterations), "sphere": int(r[8].iterations)}
                           for w, r in results.items()},
            "cost": {w: {"panda_rrtc": float(r[1].cost), "panda_simplified": float(r[2].cost),
                         "sphere_rrtc": float(r[8].cost)} for w, r in results.items()},
            "revalidated_plain": reval, "identical_card_cpu": identical,
            "kernel_vs_plain": held}
    return line, launches["cuda"]


def bench_path_fkcc(spec, envs, st, gl, live, launches) -> dict:
    """The fkcc launches of the bench path (run_suite's mega path on the
    cages): the start and goal validity (mbm._valid_fused, B x (1 + G)
    configurations) and the straight-line direct-goal check of mega_inputs
    (validate_motion_batch at the span's point bound): each against its
    plain version (no validity mismatch outside the contact band), its time
    and bound.  Returns the kernels line's row."""
    import numpy as np
    import torch

    from vamp_mvt_tpu_torch.collision.environment import TABLES
    from vamp_mvt_tpu_torch.ops.kernels import fkcc_cuda
    from vamp_mvt_tpu_torch.planning import validate

    span = float(np.linalg.norm(spec.limits_high - spec.limits_low))
    num = validate.n_points_bound(spec, span)
    # the layouts the path launches: rows for the validity, lanes for the check
    q_d = validate.motion_configs(spec, st[:, None].expand_as(gl).contiguous(), gl,
                                  num).contiguous()
    calls = {"validity": (torch.cat([st[:, None], gl], 1).contiguous(), fkcc_cuda.fkcc_batched,
                          None),
             "direct": (q_d.transpose(1, 2).contiguous(), fkcc_cuda.fkcc_batched_lanes, q_d)}
    tabs = sum(v.nbytes for v in fkcc_cuda.robot_tables(spec).values()
               if isinstance(v, np.ndarray))
    line, ms, plain, ops, n_bytes, outside = {}, 0.0, 0.0, 0, 0, 0
    for name, (q, launch, arg) in calls.items():
        vk = fkcc_cuda.fkcc_vmin(spec, envs, q)
        vp = fkcc_cuda.fkcc_vmin_plain(spec, envs, q)
        torch.cuda.synchronize()
        out = int((((vk >= 0) != (vp >= 0)) & (vp.abs() > CONTACT_BAND)).sum())
        arg = q if arg is None else arg
        k_ms = time_cuda(lambda: launch(spec, envs, arg), 3, 20)
        occupancy = dict(fkcc_cuda.LAST_LAUNCH)
        p_ms = time_cuda(lambda: fkcc_cuda.fkcc_batched_plain(spec, envs, q), 1, 3)
        b = bound(fkcc_cuda.op_count(spec, live, q.shape[1]),
                  nbytes(q, *(getattr(envs, n) for n in TABLES)) + tabs + q.shape[0] * q.shape[1])
        line[name] = {"configs": q.shape[0] * q.shape[1], "ms": k_ms, "plain_ms": p_ms,
                      "mismatches_outside_band": out, "occupancy": occupancy, **b}
        ms, plain, outside = ms + k_ms, plain + p_ms, outside + out
        ops, n_bytes = ops + b["fp32_ops"], n_bytes + b["bytes"]
    total = bound(ops, n_bytes)
    emit({"phase": "fkcc_bench_path", "problems": st.shape[0], "launches_suite_mega": launches,
          **line, "ms": ms, "plain_ms": plain, **total, "library_ms": None})
    check(outside == 0, "the bench path's fkcc launches agree with plain outside the band")
    return (row("fkcc", ms, plain, total, float(outside), launches)
            | {"name": "fkcc_bench_path", "replaces": "vamp_mvt_tpu/ops/kernels/fkcc_pallas.py:568",
               "occupancy": {k: v["occupancy"] for k, v in line.items()},
               "replaces_function": "vamp_mvt_tpu/ops/kernels/fkcc_pallas.py::_run (the start "
                                    "and goal validity and the direct-goal check of the bench "
                                    "path)",
               "ms_of": "the two launches summed (each in the phase line)",
               "max_abs_err_of": "validity mismatches outside the contact band"})


def launch_line(mod, work) -> dict:
    """A megakernel launch's shape and occupancy (the wrapper's LAST_LAUNCH:
    threads, lanes a configuration, shared memory, blocks and warps an SM,
    registers) and each phase's share of its blocks' clock cycles."""
    from vamp_mvt_tpu_torch.ops.kernels import fkcc_cuda

    return {"occupancy": dict(mod.LAST_LAUNCH),
            "phase_share": fkcc_cuda.phase_split(work, mod.WORK, mod.PHASES)["share"]}


def row(name, ms, plain, b, err, launches):
    """One entry of the kernels line."""
    return {"name": name, "route": "cuda", "source": f"vamp_mvt_tpu_torch/csrc/{name}.cu",
            "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"], "library_ms": None,
            "checked_against_plain": True}


def branch_phases(dev, spec, q, ss):
    """The attachment and heightfield phases (attach_kernel, hf_kernel, api,
    mega_attach, mega_hf); returns the megakernels' rows of the kernels
    line, the API's fkcc launches on the card and the two 700-problem fkcc
    lines."""
    import numpy as np
    import torch

    from vamp_mvt_tpu_torch.bench import mbm
    from vamp_mvt_tpu_torch.bench import scenes as scene_mod
    from vamp_mvt_tpu_torch.bench.scenes import first_two_valid, mbm_shaped_problems
    from vamp_mvt_tpu_torch.collision import environment as envmod
    from vamp_mvt_tpu_torch.ops.kernels import fkcc_cuda
    from vamp_mvt_tpu_torch.robots import registry

    B = BRANCH_PROBLEMS
    n = BRANCH_CHECK

    # attach_kernel: 700 sphere cages, each with a seeded payload
    cages = mbm.cage_suite(B, seed=5)["problems"]["cage"]
    c_envs = mbm.build_batch(cages, device=dev)[0]
    a_envs = c_envs._replace(attachment=scene_mod.payloads(B, 6, spec, dev))
    ak, a_ok = branch_kernel(spec, a_envs, q)
    only = fkcc_cuda.fkcc_batched(spec, c_envs, q) & ~a_ok
    ak["payload_only_invalid_share"] = float(only.float().mean())
    ak["live_payload_spheres_mean"] = float(live_payload(a_envs).mean())
    emit({"phase": "attach_kernel", **ak})
    check(ak["mismatches_outside_bands"] == 0, "payload kernel and plain agree outside the band")
    check(0.0 < ak["valid_share"] < 1.0, "both outcomes occur with payloads")
    check(ak["payload_only_invalid_share"] > 0.0, "some configurations only the payload invalidates")

    # hf_kernel: 700 Panda terrain scenes with a few MBM-shaped primitives
    # each; then the sphere robot over 700 seeded mazes, past their footprint
    scenes = mbm_shaped_problems(B, seed=7)
    for p in scenes:
        p.update(sphere=p["sphere"][:1], cylinder=p["cylinder"][:2], box=p["box"][:2])
    hm, hd = scene_mod.terrain_tables(B, 8, dev)
    t_envs = mbm.build_batch(scenes, device=dev)[0]._replace(hf_meta=hm, hf_data=hd)
    hk, t_ok = branch_kernel(spec, t_envs, q)
    mspec = registry.sphere_spec(lows=(-5, -5, 0), highs=(5, 5, 5), radius=0.2)
    rng = np.random.default_rng(9)
    grids = np.stack([scene_mod.maze(rng) for _ in range(B)])
    meta = envmod.make_heightfield(*scene_mod.MAZE_META, grids[0])[0]
    m_envs = envmod.broadcast_environment(envmod.empty_environment(dev), B)._replace(
        hf_meta=torch.as_tensor(meta, device=dev).expand(B, 1, 10).contiguous(),
        hf_data=torch.as_tensor(grids.reshape(B, 1, -1), device=dev))
    mq = torch.as_tensor(rng.uniform(mspec.limits_low, mspec.limits_high, (B, q.shape[1], 3))
                         .astype(np.float32), device=dev)
    mz = branch_kernel(mspec, m_envs, mq)[0]
    mz["past_footprint_share"] = float((mq[..., :2].abs() > 4.0).any(-1).float().mean())
    emit({"phase": "hf_kernel", "panda_terrain": hk, "sphere_maze": mz})
    for name, r in (("terrain", hk), ("maze", mz)):
        check(r["mismatches_outside_bands"] == 0,
              f"heightfield kernel and plain agree outside the bands ({name})")
        check(0.0 < r["valid_share"] < 1.0, f"both outcomes occur ({name})")

    # api: this slice's entry path
    line, api_launches = api_phase(dev)
    emit(line)

    # mega_attach / mega_hf: both megakernels against their plain versions
    # on the first payload cages and terrain scenes, then the mega path on
    # all of them; start and goal the first two configurations the fkcc
    # kernel found valid in each (with its payload)
    mega_s = mbm.default_settings("panda", "mega")
    mega = {}
    for phase, envs, ok in (("mega_attach", a_envs, a_ok), ("mega_hf", t_envs, t_ok)):
        rows, st, gl, mk = first_two_valid(q, ok)
        check(len(rows) >= n, f"two valid configurations in enough problems ({phase})")
        envs = envs.map(lambda t: t[rows])
        m = mega_compare(spec, envs.map(lambda t: t[:n]), st[:n], gl[:n], mk[:n], mega_s, ss)
        m["mega_path"] = mega_path(spec, envs, st, gl, mk, mega_s, ss)
        emit({"phase": phase, "problems_with_two_valid": len(rows), **m})
        mega[phase] = m
    ma, mh = mega["mega_attach"], mega["mega_hf"]
    for name, m in (("payload cages", ma), ("terrain scenes", mh)):
        check(m["rrtc_mega"]["identical_share"] >= MIN_SHARE,
              f"rrtc_mega equals plain on the {name}")
        check(m["simplify_mega"]["equal_length_share"] >= MIN_SHARE
              and m["simplify_mega"]["cost_rtol_share"] >= MIN_SHARE,
              f"simplify_mega equals plain on the {name}")

    branch = {"branch_source": "vamp_mvt_tpu_torch/csrc/fkcc_device.cuh"}
    out = []
    for tag, m, src in (("attach", ma, ATTACH_SRC), ("hf", mh, HF_SRC)):
        for k in ("rrtc_mega", "simplify_mega"):
            r = m[k]
            out.append(row(k, r["ms"], r["plain_ms"], r, r["max_abs_err"],
                           m["mega_path"]["launches"][k])
                       | branch | {"name": f"{k}_{tag}", "replaces": src})
    return out, api_launches, {"attach700": ak, "terrain700": hk}


def fkcc_paths_phase(dev, api_launches, planner_calls, batches):
    """fkcc at the launch shapes of the one-problem paths (the cases of
    bench/time_fkcc.py): one lockstep step of panda.rrtc in the API's
    payload cage and of sphere.rrtc over the API's maze (12 segments of 40
    points), PRM's sample wave (64) and an edge wave of its largest size
    (210 edges of 440 points), one FCIT edge (440 points); each against its
    plain version (no validity mismatch outside the contact and cell
    bands), with its time, bound and launch shape.  Returns the kernels
    line's rows of the attachment and heightfield branches (at the API's
    step, with the API's launches; the 700-problem batches of attach_kernel
    and hf_kernel beside them) and of FCIT's edges."""
    from vamp_mvt_tpu_torch.bench import time_fkcc

    cases = time_fkcc.path_cases(dev, ("api_rrtc_step", "sphere_api_step", "prm_samples",
                                       "prm_edges", "fcit_edge"))
    held = {}
    for name, (spec, envs, q, layout) in cases.items():
        qr = q if layout == "rows" else q.transpose(1, 2).contiguous()
        held[name] = branch_kernel(spec, envs, qr, layout)[0]
    emit({"phase": "fkcc_paths", "cases": held})
    for name, r in held.items():
        check(r["mismatches_outside_bands"] == 0,
              f"fkcc agrees with plain outside the bands at the {name} shape")
    branch = {"branch_source": "vamp_mvt_tpu_torch/csrc/fkcc_device.cuh"}
    rows = []
    for name, case, batch, launches, src in (
            ("fkcc_attach", "api_rrtc_step", "attach700", api_launches["panda"], ATTACH_SRC),
            ("fkcc_hf", "sphere_api_step", "terrain700", api_launches["sphere"], HF_SRC)):
        r, b = held[case], batches[batch]
        rows.append(row("fkcc", r["kernel_ms"], r["plain_ms"], r, r["max_abs_err"], launches)
                    | branch | {"name": name, "replaces": src, "occupancy": r["occupancy"],
                                "ms_of": f"one launch at the API's step ({case}: 1 x "
                                         f"{r['configs_per_problem']})",
                                "batch_700_ms": b["kernel_ms"], "batch_700_bound_ms": b["bound_ms"],
                                "batch_700_occupancy": b["occupancy"]})
    r = held["fcit_edge"]
    rows.append(row("fkcc", r["kernel_ms"], r["plain_ms"], r, r["max_abs_err"],
                    planner_calls["fcit"]["fkcc_launches"])
                | {"name": "fkcc_fcit", "replaces": "vamp_mvt_tpu/ops/kernels/fkcc_pallas.py:568",
                   "occupancy": r["occupancy"], "launches_of": "one panda.fcit call",
                   "ms_of": "one popped edge (1 x 440), one launch"})
    return rows, held


def probe_mosaic_phase(dev) -> dict:
    """Every P2/P3 probe (csrc/probe_mosaic.cu) on PROBE_TILES tiles through
    the probe entry point (`mosaic.run`, once each, launches counted),
    against its plain version and numpy, tile 0 against the probe file's
    constants; times, bounds and, where one PyTorch call computes the
    probe's function, that call's time.  Each time is taken two ways: one
    call between two events (`ms`, `library_ms`: the host's work included)
    and ten calls replayed from one CUDA graph, over ten (`device_ms`,
    `library_device_ms`: the card's time alone).  Returns the kernels line's
    row."""
    import numpy as np
    import torch

    from vamp_mvt_tpu_torch.bench.time_fkcc import graph_ms
    from vamp_mvt_tpu_torch.probes import mosaic

    ins = {p: mosaic.inputs(p, PROBE_TILES, seed=4, device=dev) for p in mosaic.PROBES}
    mosaic.LAUNCHES = 0
    got = {p: mosaic.run(p, *ins[p]) for p in mosaic.PROBES}
    torch.cuda.synchronize()
    launches = mosaic.LAUNCHES
    # one PyTorch call that computes the probe's function (its reduction,
    # scan or copy; a constant row made before timing), timed here only:
    # the port never calls these
    three_i = torch.arange(512, dtype=torch.int32, device=dev) * 3
    library = {
        "dot_argmin": lambda a, b: torch.argmin(torch.bmm(a, b), dim=1),
        "group32_sum": lambda x: x.view(-1, 8, 4, 32).sum(-1),
        "reduce_while": lambda x: torch.sum(x, dim=(1, 2)),
        "grid_carry": lambda x: torch.cumsum(x[:, :, 0], dim=1),
        "cumsum_first": lambda x: torch.cumsum(x[:, 0], dim=1),
        "transpose": lambda x: x[:, 0, :64, None].contiguous(),
        "smem_int_out": lambda off: torch.add(off[:, None, None], three_i),
    }
    library_ms_null = {  # why no single call computes the rest
        "while_carry": "a loop whose trip count depends on the data",
        "dyn_sublane": "a row written at a data-dependent index, then read back",
        "smem_writes": "512 scalar writes, two read back and added",
        "nested_loops": "a masked row fill and a product",
        "scratch_diag": "a diagonal scaled, truncated to int and summed",
        "halton_digits": "eight digit steps of integer division",
        "static_reads": "two reads scaled and truncated to int",
        "dyn_rows_while": "a loop over rows up to a data-dependent count",
    }
    check(set(library) | set(library_ms_null) == set(mosaic.PROBES)
          and not set(library) & set(library_ms_null), "every probe has a library call or a reason")
    probes = {}
    for p in mosaic.PROBES:
        plain = mosaic.plain(p, *ins[p])
        want = mosaic.reference(p, *(t.cpu().numpy() for t in ins[p]))
        lib = library.get(p)
        probes[p] = {
            "equal_plain": all(torch.equal(g, w) for g, w in zip(got[p], plain)),
            "equal_numpy": all(np.array_equal(g.cpu().numpy(), w) for g, w in zip(got[p], want)),
            "tile0_probe_constants": mosaic.tile0_ok(p, got[p]),
            "max_abs_err": max(float((g.double() - w.double()).abs().max())
                               for g, w in zip(got[p], plain)),
            "ms": time_cuda(lambda: mosaic.launch(p, *ins[p]), 3, 20),
            "device_ms": graph_ms(lambda: mosaic.launch(p, *ins[p])),
            "plain_ms": time_cuda(lambda: mosaic.plain(p, *ins[p]), 1, 3),
            **bound(*mosaic.work(p, ins[p])),
            "library_ms": None if lib is None else time_cuda(lambda: lib(*ins[p]), 3, 20),
            "library_device_ms": None if lib is None else graph_ms(lambda: lib(*ins[p]))}
    emit({"phase": "probe_mosaic", "tiles": PROBE_TILES, "launches": launches,
          "library_ms_null": library_ms_null, "probes": probes})
    check(launches == len(mosaic.PROBES), "the probe entry point launched every probe once")
    for p, r in probes.items():
        check(r["equal_plain"] and r["equal_numpy"], f"probe {p} equals plain and numpy")
        check(r["tile0_probe_constants"], f"probe {p}'s tile 0 gives the probe file's constants")
    by = {k: sum(r["bound_ms"] for r in probes.values() if r["bound_by"] == k)
          for k in ("bytes", "operations")}
    return {"name": "probe_mosaic", "route": "cuda",
            "source": "vamp_mvt_tpu_torch/csrc/probe_mosaic.cu",
            "replaces": "tools/probe_mosaic.py:40",
            "replaces_all": "tools/probe_mosaic.py:40,64,90,110,141,169,190,212; "
                            "tools/probe_mosaic2.py:37,58,91,117,134,160,184",
            "launches": launches, "on_main_path": False,
            "max_abs_err": max(r["max_abs_err"] for r in probes.values()),
            "ms": sum(r["ms"] for r in probes.values()),
            "plain_ms": sum(r["plain_ms"] for r in probes.values()),
            "bound_ms": sum(r["bound_ms"] for r in probes.values()),
            "bound_by": max(by, key=by.get), "library_ms": None,
            "library_ms_by_probe": {p: r["library_ms"] for p, r in probes.items()
                                    if r["library_ms"] is not None},
            "device_ms_by_probe": {p: r["device_ms"] for p, r in probes.items()},
            "library_device_ms_by_probe": {p: r["library_device_ms"] for p, r in probes.items()
                                           if r["library_device_ms"] is not None},
            "library_ms_null": f"the row sums all {len(probes)} probes; {len(library_ms_null)} "
                               "of them have no single PyTorch call (reasons in the phase line)",
            "ms_of": "the 15 probes, one launch each, summed (each probe in the phase line)",
            "checked_against_plain": True}


def suite_robots_phase(dev, ss) -> list[dict]:
    """run_suite(robot, planner="mega") at its defaults on UR5, Fetch and
    Baxter, each over ROBOT_SCENES problems: the first ROBOT_SCENES of
    ROBOT_POOL MBM-shaped scenes in which the fkcc kernel finds two of
    KERNEL_CONFIGS seeded configurations valid for the robot, those two as
    start and goal (batch_size = the problem count: no padding); every
    solved simplified path revalidated by the plain version; both
    megakernels against their plain versions on the first ROBOTS_CHECK of
    those problems.  Returns the kernels line's rows."""
    import numpy as np
    import torch

    from vamp_mvt_tpu_torch.bench import mbm, scenes as scene_mod
    from vamp_mvt_tpu_torch.ops.kernels import fkcc_cuda, rrtc_mega_cuda, simplify_mega_cuda
    from vamp_mvt_tpu_torch.planning import rrtc_mega
    from vamp_mvt_tpu_torch.robots import registry

    kernels = {"fkcc": fkcc_cuda, "rrtc_mega": rrtc_mega_cuda, "simplify_mega": simplify_mega_cuda}
    scenes = scene_mod.mbm_shaped_problems(ROBOT_POOL, seed=10)
    scene_envs = mbm.build_batch(scenes, device=dev)[0]
    out = []
    for i, robot in enumerate(OTHER_ROBOTS):
        spec = registry.load(robot)
        q = scene_mod.seeded_configs(spec, ROBOT_POOL, KERNEL_CONFIGS, 20 + i, dev)
        ok = fkcc_cuda.fkcc_batched(spec, scene_envs, q)
        scenes_two_valid = int((ok.sum(1) >= 2).sum())
        rows, st, gl, mk = scene_mod.first_two_valid(q, ok, keep=ROBOT_SCENES)
        del q, ok
        check(len(rows) == ROBOT_SCENES, f"{ROBOT_SCENES} scenes with two valid {robot} "
                                         f"configurations among {ROBOT_POOL}")
        problems = [dict(scenes[r], start=s_, goals=[g_])
                    for r, s_, g_ in zip(rows, st.tolist(), gl[:, 0].tolist())]
        envs = scene_envs.map(lambda t: t[rows])
        for lib in kernels.values():
            lib.LAUNCHES = 0
        rrtc_mega.PAST_MAX_PATH = 0
        tm = {}
        t0 = time.perf_counter()
        res = mbm.run_suite(robot, data={"problems": {"mbm_shaped": problems}}, planner="mega",
                            batch_size=len(problems), timings=tm)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {n: lib.LAUNCHES for n, lib in kernels.items()}
        past = rrtc_mega.PAST_MAX_PATH
        occupancy = {"rrtc_mega": dict(rrtc_mega_cuda.LAST_LAUNCH),
                     "simplify_mega": dict(simplify_mega_cuda.LAST_LAUNCH)}
        summ = res.summary()
        solved = np.asarray(res.plan.solved) & res.valid
        reval = paths_revalidate_plain(spec, envs, res.simplified.path,
                                       res.simplified.path_length).cpu().numpy()
        unsolved = np.flatnonzero(~solved & res.valid)[:UNSOLVED_LISTED].tolist()
        n = min(ROBOTS_CHECK, len(rows))
        settings = mbm.default_settings(robot, "mega")
        m = mega_compare(spec, envs.map(lambda t: t[:n]), st[:n], gl[:n], mk[:n], settings, ss)
        emit({"phase": "suite_robots", "robot": robot, "problems": len(rows),
              "scenes_drawn": ROBOT_POOL, "scenes_with_two_valid": scenes_two_valid,
              "scenes_used": rows[-1] + 1, "settings": {
                  k: getattr(settings, k) for k in ("range", "max_iterations", "max_samples",
                                                    "samples_per_step", "sample_window",
                                                    "connect_segments")},
              "dimension": spec.dimension, "spheres": spec.n_spheres, "wall_s": wall,
              "summary": summ, "timings": tm, "launches": launches, "occupancy": occupancy,
              "past_max_path": past, "unsolved": {
                  "scene_rows": [rows[i] for i in unsolved], "starts": st[unsolved].tolist(),
                  "goals": gl[unsolved, 0].tolist()},
              "solved_paths_revalidated_plain": int((reval & solved).sum()), **m})
        print(res.percentile_table(), flush=True)
        check(summ["valid_problems"] == len(rows), f"every {robot} problem valid")
        check(all(v > 0 for v in launches.values()), f"the {robot} suite launched every kernel")
        check(summ["solved_problems"] > 0, f"the {robot} suite solves some problems")
        check(bool(reval[solved].all()), f"every solved {robot} path revalidates (plain)")
        check(m["rrtc_mega"]["identical_share"] >= MIN_SHARE, f"rrtc_mega equals plain on {robot}")
        check(m["simplify_mega"]["equal_length_share"] >= MIN_SHARE
              and m["simplify_mega"]["cost_rtol_share"] >= MIN_SHARE,
              f"simplify_mega equals plain on {robot}")
        for k, src in (("rrtc_mega", "vamp_mvt_tpu/planning/rrtc_mega.py:943"),
                       ("simplify_mega", "vamp_mvt_tpu/planning/simplify_mega.py:377")):
            r = m[k]
            out.append(row(k, r["ms"], r["plain_ms"], r, r["max_abs_err"], launches[k])
                       | {"name": f"{k}_{robot}", "replaces": src,
                          **{f: occupancy[k].get(f) for f in (
                              "threads", "group", "smem_bytes", "blocks_per_sm",
                              "warps_per_sm")},
                          "phase_share": r["phase_share"]})
    return out


class WaveRecorder:
    """`validate` for planning/prm.py (and fcit.py, through it): every call
    passes through, and the validate_motion_batch call with the most
    configurations (its segments, point count and tables) is kept."""

    def __init__(self):
        from vamp_mvt_tpu_torch.planning import validate

        self._validate = validate
        self.reset()

    def reset(self):
        self.largest, self.max_configs, self.edge_waves = None, 0, 0

    def __getattr__(self, name):
        return getattr(self._validate, name)

    def validate_motion_batch(self, spec, envs, starts, goals, num):
        self.edge_waves += 1
        n = starts.shape[0] * starts.shape[1] * num
        if n > self.max_configs:
            self.largest, self.max_configs = (envs, starts, goals, num), n
        return self._validate.validate_motion_batch(spec, envs, starts, goals, num)


def api_planners_phase(dev):
    """This slice's entry path: panda.prm, panda.fcit and panda.roadmap at
    the API's default settings on the card, from VAMP's start A to goal B
    in the sphere cage; every path segment and roadmap edge revalidated by
    the plain version; the fkcc kernel against its plain version on the
    configurations of PRM's largest edge wave; card against device="cpu" on
    tests/test_planners.py's sphere-robot wall cases.  Returns the kernels
    line's fkcc row of the PRM path and each call's line."""
    import numpy as np
    import torch

    import vamp_mvt_tpu_torch as vmt
    from vamp_mvt_tpu_torch.bench import mbm
    from vamp_mvt_tpu_torch.collision import environment as envmod
    from vamp_mvt_tpu_torch.ops.kernels import fkcc_cuda
    from vamp_mvt_tpu_torch.planning import fcit, prm, validate
    from vamp_mvt_tpu_torch.robots import registry

    env = vmt.Environment()
    for c in mbm.CAGE_CENTERS:
        env.add_sphere(vmt.Sphere(c, mbm.CAGE_RADIUS))
    A, B = mbm.PANDA_START, mbm.PANDA_GOAL
    spec = vmt.panda.spec
    envs1 = env.build(dev).map(lambda t: t[None])
    rec, real = WaveRecorder(), prm.validate_mod
    sample_size = {"prm": prm.PRMSettings().wave, "roadmap": prm.PRMSettings().wave,
                   "fcit": 2 * fcit.FCITSettings().batch_size}
    calls, results, prm_wave = {}, {}, None
    prm.validate_mod = rec
    try:
        for name in ("prm", "fcit", "roadmap"):
            rec.reset()
            fkcc_cuda.LAUNCHES = 0
            t0 = time.perf_counter()
            results[name] = getattr(vmt.panda, name)(A, B, env)
            torch.cuda.synchronize()
            calls[name] = {"ms": (time.perf_counter() - t0) * 1e3,
                           "fkcc_launches": fkcc_cuda.LAUNCHES,
                           "edge_launches": rec.edge_waves,
                           "max_configs_per_launch": max(rec.max_configs, sample_size[name])}
            if name == "prm":
                prm_wave = rec.largest
    finally:
        prm.validate_mod = real
    for name in ("prm", "fcit"):
        r = results[name]
        ok = paths_revalidate_plain(spec, envs1, torch.as_tensor(r.path[None], device=dev),
                                    [len(r.path)])
        calls[name] |= {"solved": bool(r.solved), "iterations": int(r.iterations),
                        "size": int(r.size), "cost": float(r.cost), "path_vertices": len(r.path),
                        "revalidated_plain": bool(ok[0])}
        check(r.solved, f"panda.{name} solves the cage")
        check(bool(ok[0]), f"every segment of panda.{name}'s path revalidates (plain)")
    rm = results["roadmap"]
    edges = torch.as_tensor(rm.vertices[np.asarray(rm.edges).reshape(-1, 2)], device=dev)
    e_ok = paths_revalidate_plain(spec, envs1, edges, [2] * len(edges))
    calls["roadmap"] |= {"vertices": len(rm.vertices), "edges": len(rm.edges),
                         "edges_revalidated_plain": int(e_ok.sum())}
    check(len(rm.edges) > 0 and bool(e_ok.all()), "every roadmap edge revalidates (plain)")

    # the fkcc kernel against its plain version on PRM's largest edge wave
    w_envs, w_starts, w_goals, num = prm_wave
    q = validate.motion_configs(spec, w_starts, w_goals, num).transpose(1, 2).contiguous()
    held = branch_kernel(spec, w_envs, q)[0]
    held |= {"edges": int(w_starts.shape[1]), "points_per_edge": num}
    check(held["mismatches_outside_bands"] == 0,
          "the kernel agrees with plain on PRM's largest edge wave outside the contact band")

    # card against the CPU on tests/test_planners.py's sphere-robot wall
    wspec = registry.sphere_spec(lows=(-3, -3, 0), highs=(3, 3, 3), radius=0.1)
    b = envmod.EnvironmentBuilder()
    for y in np.linspace(-3, 3, 13):
        for z in np.linspace(0, 3, 7):
            if not (y > 2.0 and z > 2.0):
                b.add_sphere([0.0, y, z], 0.3)
    star = prm.PRMStarNeighborParams(3, wspec.space_measure())
    S, G = [-2.0, 0.0, 1.0], [[2.0, 0.0, 1.0]]
    cases = {
        "prm": lambda d, e: prm.solve(wspec, e, S, G, prm.PRMSettings(
            max_samples=1024, wave=64, neighbor_params=star), device=d),
        "fcit": lambda d, e: fcit.solve(wspec, e, S, G, fcit.FCITSettings(
            max_samples=256, batch_size=64), device=d),
        "roadmap": lambda d, e: prm.build_roadmap(wspec, e, S, G[0], prm.PRMSettings(
            max_samples=256, wave=64, neighbor_params=star), device=d),
    }
    wall = {}
    for name, fn in cases.items():
        card, cpu = fn(dev, b.build(device=dev)), fn("cpu", b.build(device="cpu"))
        if name == "roadmap":
            same = card.edges == cpu.edges and np.array_equal(card.vertices, cpu.vertices)
            wall[name] = {"vertices": len(card.vertices), "edges": len(card.edges),
                          "identical": same}
        else:
            same = ((card.solved, card.iterations, card.size) == (cpu.solved, cpu.iterations,
                                                                  cpu.size)
                    and card.path.shape == cpu.path.shape
                    and float(np.abs(card.path - cpu.path).max()) <= 1e-6)
            wall[name] = {"solved": bool(card.solved), "iterations": int(card.iterations),
                          "size": int(card.size), "identical": same}
        check(same, f"{name} on the card equals the CPU on the wall problem")
    emit({"phase": "api_planners", "calls": calls, "kernel_vs_plain_prm_wave": held,
          "wall_card_vs_cpu": wall})
    return (row("fkcc", held["kernel_ms"], held["plain_ms"], held, held["max_abs_err"],
                calls["prm"]["fkcc_launches"])
            | {"name": "fkcc_prm", "replaces": "vamp_mvt_tpu/ops/kernels/fkcc_pallas.py:568",
               "occupancy": held["occupancy"], "launches_of": "one panda.prm call",
               "launches_edge_waves": calls["prm"]["edge_launches"],
               "launches_roadmap": calls["roadmap"]["fkcc_launches"],
               "ms_of": "PRM's largest edge wave, one launch"}), calls


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from vamp_mvt_tpu_torch.bench import mbm
    from vamp_mvt_tpu_torch.bench.scenes import mbm_shaped_problems
    from vamp_mvt_tpu_torch.collision.environment import LIVE_LIMIT, TABLES
    from vamp_mvt_tpu_torch.ops.kernels import fkcc_cuda
    from vamp_mvt_tpu_torch.planning import validate
    from vamp_mvt_tpu_torch.robots import registry

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)

    # --- card --------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    emit({"phase": "card", "nvidia_smi": smi, "device": name,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # --- build -------------------------------------------------------------
    from vamp_mvt_tpu_torch.ops.kernels import build, rrtc_mega_cuda, simplify_mega_cuda

    t0 = time.perf_counter()
    from vamp_mvt_tpu_torch.probes import gather

    from vamp_mvt_tpu_torch.probes import mosaic

    for lib in (fkcc_cuda, rrtc_mega_cuda, simplify_mega_cuda, gather, mosaic):
        lib.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "libraries": {
        name: {"cached": info["cached"], "seconds": info["seconds"],
               "library": os.path.relpath(info["path"]), "ptxas": build.ptxas_lines(name)}
        for name, info in sorted(build.BUILD_INFO.items())}})
    check({"fkcc", "rrtc_mega", "simplify_mega", "probe_gather", "probe_mosaic"}
          <= set(build.BUILD_INFO), "every kernel built")

    # --- kernel vs plain ---------------------------------------------------
    spec = registry.load("panda")
    problems = mbm_shaped_problems(KERNEL_PROBLEMS, seed=1)
    envs, _, _, _ = mbm.build_batch(problems, device=dev)
    rng = np.random.default_rng(2)
    q = torch.as_tensor(rng.uniform(
        spec.limits_low, spec.limits_high,
        (KERNEL_PROBLEMS, KERNEL_CONFIGS, spec.dimension)).astype(np.float32), device=dev)
    q_d = q.transpose(1, 2).contiguous()  # the lanes layout the main path uses
    live = {n: (getattr(envs, n)[..., 0].abs() < LIVE_LIMIT).sum(-1).cpu().numpy()
            for n in TABLES}
    check(all(int(live[n].sum()) > 0 for n in TABLES), "every primitive table has live rows")

    vk = fkcc_cuda.fkcc_vmin(spec, envs, q)
    ok_k = fkcc_cuda.fkcc_batched_lanes(spec, envs, q_d)
    vp = fkcc_cuda.fkcc_vmin_plain(spec, envs, q)
    torch.cuda.synchronize()
    check(vk.shape == vp.shape == ok_k.shape == (KERNEL_PROBLEMS, KERNEL_CONFIGS), "shapes")
    check(bool(torch.isfinite(vk).all()) and bool(torch.isfinite(vp).all()), "finite vmin")
    check(torch.equal(ok_k, vk >= 0), "kernel validity agrees with its own vmin")
    mism = (vk >= 0) != (vp >= 0)
    outside = mism & (vp.abs() > CONTACT_BAND)
    max_abs_err = float((vk - vp).abs().max())

    kernel_ms = time_cuda(lambda: fkcc_cuda.fkcc_batched_lanes(spec, envs, q_d), 3, 30)
    kernel_occupancy = dict(fkcc_cuda.LAST_LAUNCH)
    plain_ms = time_cuda(lambda: fkcc_cuda.fkcc_batched_plain(spec, envs, q), 1, 5)
    n_cfg = KERNEL_PROBLEMS * KERNEL_CONFIGS
    ops = fkcc_cuda.op_count(spec, live, KERNEL_CONFIGS)
    tabs = fkcc_cuda.robot_tables(spec)
    n_bytes = (q.numel() * 4 + sum(getattr(envs, n).numel() * 4 for n in TABLES)
               + sum(v.nbytes for v in tabs.values() if isinstance(v, np.ndarray))
               + n_cfg)  # one validity byte out per configuration
    ops_ms = ops / PEAK_FP32_FLOPS * 1e3
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    kernel = {
        "phase": "kernel", "problems": KERNEL_PROBLEMS, "configs_per_problem": KERNEL_CONFIGS,
        "live_rows_mean": {n: float(live[n].mean()) for n in TABLES},
        "valid_share": float((vk >= 0).float().mean()),
        "mismatches": int(mism.sum()), "mismatches_outside_band": int(outside.sum()),
        "band": CONTACT_BAND, "max_abs_err": max_abs_err,
        "kernel_ms": kernel_ms, "occupancy": kernel_occupancy, "plain_ms": plain_ms,
        "fp32_ops": ops, "bytes": n_bytes, "ops_bound_ms": ops_ms, "bytes_bound_ms": bytes_ms,
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None,
    }
    emit(kernel)
    check(int(outside.sum()) == 0, "kernel and plain agree outside the contact band")

    # --- suite: the main path ---------------------------------------------
    data = mbm.cage_suite(SUITE_PROBLEMS, seed=0)
    timings = {}
    fkcc_cuda.LAUNCHES = 0
    t0 = time.perf_counter()
    res = mbm.run_suite("panda", data=data, planner="xla", timings=timings)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fkcc_cuda.LAUNCHES

    summary = res.summary()
    cage_envs = mbm.build_batch(data["problems"]["cage"], device=dev)[0]
    paths_ok = int(paths_revalidate(spec, cage_envs, res.simplified.path,
                                    res.simplified.path_length).sum())
    emit({"phase": "suite", "problems": SUITE_PROBLEMS, "wall_s": wall, "summary": summary,
          "timings": timings, "fkcc_launches": launches,
          "simplified_paths_revalidated": paths_ok})
    print(res.percentile_table(), flush=True)
    check(launches > 0, "the main path launched the fkcc kernel")
    check(summary["valid_problems"] == summary["solved_problems"] == SUITE_PROBLEMS,
          "every problem valid and solved")
    check(paths_ok == SUITE_PROBLEMS, "every simplified path revalidates")
    check(np.isfinite(res.simplified.cost).all(), "finite simplified costs")

    # --- rrtc_mega: the planner megakernel against its plain version ------
    import dataclasses

    from vamp_mvt_tpu_torch.planning import rrtc, rrtc_mega, simplify, simplify_mega

    spec_w, envs_w, st_w, gl_w, mk_w = wall_problem(dev)
    offs = torch.arange(3, device=dev, dtype=torch.int32) * 100
    wall, rrtc_err = {}, 0.0
    for kcw in ((1, 1, 1), (4, 2, 2)):
        s_w = rrtc.RRTCSettings(range=1.0, max_iterations=384, max_samples=512, max_path=64,
                                samples_per_step=kcw[0], connect_segments=kcw[1],
                                sample_window=kcw[2])
        g = gl_w
        for budget in (384, 260, 32 * 260):  # the last two: run_suite's retry
            got = rrtc_mega.plan_batch_mega(spec_w, envs_w, st_w, g, mk_w, s_w, offs,
                                            budget=budget, device=dev)
            ref = rrtc.plan_batch(spec_w, envs_w, st_w, g, mk_w,
                                  dataclasses.replace(s_w, max_iterations=budget), offs)
            torch.cuda.synchronize()
            same = same_plan(got, ref)
            wall[f"{kcw}@{budget}"] = {"identical": int(same.sum()),
                                       "solved": int(got.solved.sum())}
            k = torch.arange(64, device=dev)
            live = (k[None] < ref.path_length[:, None])[..., None]
            rrtc_err = max(rrtc_err, float(torch.where(live, (got.path - ref.path).abs(), 0).max()))
            check(bool(same.all()), f"rrtc_mega equals plain on the wall problem, {kcw}@{budget}")
            if budget == 260:
                g = torch.where(got.solved[:, None, None], st_w[:, None], gl_w)

    cages = mbm.cage_suite(MEGA_PROBLEMS, seed=0)
    c_envs, c_st, c_gl, c_mk = mbm.build_batch(cages["problems"]["cage"], device=dev)
    c_live = {n: (getattr(c_envs, n)[..., 0].abs() < LIVE_LIMIT).sum(-1).cpu().numpy()
              for n in TABLES}
    c_ops = fkcc_cuda.ops_per_config(spec, c_live)
    mega_s = mbm.default_settings("panda", "mega")
    kres = rrtc_mega.plan_batch_mega(spec, c_envs, c_st, c_gl, c_mk, mega_s, device=dev)
    pres = rrtc.plan_batch_compact(spec, c_envs, c_st, c_gl, c_mk, mega_s, device=dev)
    torch.cuda.synchronize()
    same = same_plan(kres, pres)
    # the wrapper on the entry point's inputs, for the work counters
    ctl, nodes0, _, _ = rrtc_mega.mega_inputs(spec, c_envs, c_st, c_gl, c_mk, mega_s)
    _, r_scal, r_work = rrtc_mega_cuda.plan(spec, c_envs, ctl, nodes0, mega_s)
    work = {k: v.cpu().numpy().astype(np.int64) for k, v in (
        ("configs", r_work[:, 0]), ("pairs", r_work[:, 1]), ("nodes", r_scal[:, 6]),
        ("grow_steps", r_scal[:, 9]), ("connect_steps", r_scal[:, 10]))}
    r_launch = launch_line(rrtc_mega_cuda, r_work)
    rrtc_ms = time_cuda(lambda: rrtc_mega_cuda.plan(spec, c_envs, ctl, nodes0, mega_s), 1, 3)
    entry_ms = time_cuda(lambda: rrtc_mega.plan_batch_mega(spec, c_envs, c_st, c_gl, c_mk,
                                                           mega_s, device=dev), 0, 1)
    rrtc_plain_ms = time_cuda(lambda: rrtc.plan_batch_compact(spec, c_envs, c_st, c_gl, c_mk,
                                                              mega_s, device=dev), 0, 1)
    d = spec.dimension
    r_bound = bound(
        int(np.sum(work["configs"] * c_ops)) + int(np.sum(work["pairs"])) * rrtc_mega_cuda.ops_per_pair(d),
        nbytes(ctl, nodes0, *(getattr(c_envs, n) for n in TABLES))
        + int(np.sum(work["nodes"])) * (d + 4) * 4            # each node row written once
        + MEGA_PROBLEMS * (mega_s.max_path * d + rrtc_mega_cuda.SCALARS
                           + 2 * (rrtc_mega_cuda.WORK + len(rrtc_mega_cuda.PHASES))) * 4)
    iters = kres.iterations.cpu().numpy()
    emit({"phase": "rrtc_mega", "wall_problem": wall, "problems": MEGA_PROBLEMS,
          "settings": dataclasses.asdict(mega_s),
          "identical_share": float(same.float().mean()),
          "solved": {"kernel": int(kres.solved.sum()), "plain": int(pres.solved.sum())},
          "median_cost": {"kernel": median(kres.cost[kres.solved]),
                          "plain": median(pres.cost[pres.solved])},
          "ms": rrtc_ms, "entry_ms": entry_ms, "plain_ms": rrtc_plain_ms,
          "work": {k: int(v.sum()) for k, v in work.items()},
          "iterations": {q: float(np.percentile(iters, p)) for q, p in
                         (("min", 0), ("p50", 50), ("p90", 90), ("p99", 99), ("max", 100))},
          "grow_steps_max": int(work["grow_steps"].max()),
          **r_launch, "max_abs_err": rrtc_err, **r_bound, "library_ms": None})
    check(int(kres.solved.sum()) == MEGA_PROBLEMS, "the planner megakernel solves every cage")
    check(float(same.float().mean()) >= MIN_SHARE, "rrtc_mega equals plain on the cages")

    # --- simplify_mega: the simplify megakernel against its plain version --
    ss = simplify.SimplifySettings(pair_chunk=64)
    wp = rrtc.plan_batch(spec_w, envs_w, st_w, gl_w, mk_w, rrtc.RRTCSettings(
        range=1.0, max_iterations=1024, max_samples=512, max_path=64, samples_per_step=4,
        connect_segments=2, sample_window=2))
    kw_ = simplify_mega.simplify_batch_mega(spec_w, envs_w, wp.path, wp.path_length, ss,
                                            device=dev)
    pw_ = simplify_mega.simplify_batch_plain(spec_w, envs_w, wp.path, wp.path_length, ss)
    torch.cuda.synchronize()
    simp_err = float((kw_.path - pw_.path).abs().max())
    check(torch.equal(kw_.path_length, pw_.path_length)
          and torch.equal(kw_.iterations, pw_.iterations)
          and bool(((kw_.cost - pw_.cost).abs() <= SIMPLIFY_RTOL * pw_.cost.abs()).all())
          and simp_err <= 1e-5, "simplify_mega equals plain on the wall problem")

    ksimp = simplify_mega.simplify_batch_mega(spec, c_envs, pres.path, pres.path_length, ss,
                                              device=dev)
    psimp = simplify_mega.simplify_batch_plain(spec, c_envs, pres.path, pres.path_length, ss)
    torch.cuda.synchronize()
    eq_len = ksimp.path_length == psimp.path_length
    eq_cost = (ksimp.cost - psimp.cost).abs() <= SIMPLIFY_RTOL * psimp.cost.abs()
    # the wrapper on the entry point's inputs, for the work counter
    sp_in, sl_in = pres.path.contiguous(), pres.path_length.to(torch.int32)
    s_work = simplify_mega_cuda.simplify(spec, c_envs, sp_in, sl_in, ss)[2]
    s_launch = launch_line(simplify_mega_cuda, s_work)
    s_configs = s_work[:, 0].cpu().numpy().astype(np.int64)
    simp_ms = time_cuda(lambda: simplify_mega_cuda.simplify(spec, c_envs, sp_in, sl_in, ss), 1, 3)
    simp_plain_ms = time_cuda(lambda: simplify_mega.simplify_batch_plain(
        spec, c_envs, pres.path, pres.path_length, ss), 0, 1)
    s_bound = bound(int(np.sum(s_configs * c_ops)),
                    2 * nbytes(sp_in) + nbytes(sl_in, *(getattr(c_envs, n) for n in TABLES))
                    + MEGA_PROBLEMS * (2 * 4 + 8))
    plain_pipeline_cost = median(psimp.cost[pres.solved])
    emit({"phase": "simplify_mega", "wall_problem": {"path_length": kw_.path_length.tolist(),
                                                     "max_abs_err": simp_err},
          "problems": MEGA_PROBLEMS, "equal_length_share": float(eq_len.float().mean()),
          "cost_rtol_share": float(eq_cost.float().mean()), "rtol": SIMPLIFY_RTOL,
          "median_cost": {"kernel": median(ksimp.cost[pres.solved]),
                          "plain": plain_pipeline_cost},
          "ms": simp_ms, "plain_ms": simp_plain_ms,
          "configs": int(s_configs.sum()), **s_launch, **s_bound, "library_ms": None})
    check(float(eq_len.float().mean()) >= MIN_SHARE
          and float(eq_cost.float().mean()) >= MIN_SHARE, "simplify_mega equals plain on the cages")

    # --- suite_mega: the port's main path ---------------------------------
    kernels = {"fkcc": fkcc_cuda, "rrtc_mega": rrtc_mega_cuda, "simplify_mega": simplify_mega_cuda}
    for lib in kernels.values():
        lib.LAUNCHES = 0
    rrtc_mega.PAST_MAX_PATH = 0
    mt = {}
    t0 = time.perf_counter()
    mres = mbm.run_suite("panda", data=cages, planner="mega", timings=mt)
    torch.cuda.synchronize()
    mwall = time.perf_counter() - t0
    mega_launches = {n: lib.LAUNCHES for n, lib in kernels.items()}
    m_past = rrtc_mega.PAST_MAX_PATH
    msum = mres.summary()
    m_ok = int(paths_revalidate(spec, c_envs, mres.simplified.path,
                                mres.simplified.path_length).sum())
    cost_ratio = msum["median_simplified_cost"] / plain_pipeline_cost
    emit({"phase": "suite_mega", "problems": MEGA_PROBLEMS, "wall_s": mwall, "summary": msum,
          "timings": mt, "launches": mega_launches, "simplified_paths_revalidated": m_ok,
          "past_max_path": m_past,
          "median_simplified_cost_vs_plain": cost_ratio})
    print(mres.percentile_table(), flush=True)
    check(all(v > 0 for v in mega_launches.values()), "the main path launched every kernel")
    check(msum["valid_problems"] == msum["solved_problems"] == MEGA_PROBLEMS,
          "every cage valid and solved on the mega path")
    check(m_ok == MEGA_PROBLEMS, "every simplified path of the mega path revalidates")
    check(abs(cost_ratio - 1.0) <= 0.01, "median simplified cost within 1% of the plain versions'")
    bench_fkcc_row = bench_path_fkcc(spec, c_envs, c_st, c_gl, c_live, mega_launches["fkcc"])

    # the kernel phase's MBM-shaped scenes, starts and goals drawn from the
    # configurations the fkcc kernel found valid
    ok_cfg = (vk >= 0).cpu().numpy()
    q_np = q.cpu().numpy()
    # (about a tenth of the scenes put an obstacle over the robot's base, so
    # that no configuration is valid there: those scenes hold no problem)
    rows = [i for i in range(len(problems)) if ok_cfg[i].sum() >= 2]
    check(len(rows) >= 0.8 * len(problems), "two valid configurations in most scenes")
    problems = [problems[i] for i in rows]
    for i, p in zip(rows, problems):
        idx = np.flatnonzero(ok_cfg[i])
        p["start"], p["goals"] = q_np[i, idx[0]].tolist(), [q_np[i, idx[1]].tolist()]
    for lib in kernels.values():
        lib.LAUNCHES = 0
    rrtc_mega.PAST_MAX_PATH = 0
    st_ = {}
    t0 = time.perf_counter()
    sres = mbm.run_suite("panda", data={"problems": {"mbm_shaped": problems}}, planner="mega",
                         timings=st_)
    torch.cuda.synchronize()
    swall = time.perf_counter() - t0
    s_launches = {n: lib.LAUNCHES for n, lib in kernels.items()}
    ssum = sres.summary()
    solved = np.asarray(sres.plan.solved) & sres.valid
    s_ok = paths_revalidate(spec, envs.map(lambda t: t[rows]), sres.simplified.path,
                            sres.simplified.path_length).cpu().numpy()
    emit({"phase": "suite_mega_mbm_shaped", "problems": len(problems), "wall_s": swall,
          "summary": ssum, "timings": st_, "launches": s_launches,
          "past_max_path": rrtc_mega.PAST_MAX_PATH,
          "solved_paths_revalidated": int((s_ok & solved).sum())})
    check(bool(s_ok[solved].all()), "every solved MBM-shaped path revalidates")

    # the planner megakernel against its plain version on the first
    # MBM_CHECK of these scenes (capsule and cuboid tables): at the budget,
    # then as run_suite's retry (32x the budget, the solved rows' goals
    # replaced by their starts), where the share is over the retried rows
    b_envs, b_st, b_gl, b_mk = mbm.build_batch(problems[:MBM_CHECK], device=dev)
    mbm_check = retry_compare(spec, b_envs, b_st, b_gl, b_mk, mega_s)
    emit({"phase": "rrtc_mega_mbm_shaped", "settings": "run_suite's mega settings",
          "min_share": MIN_SHARE, "by_budget": mbm_check})

    # --- mega_interleave: the interleaved cadence of the planner kernel ---
    inter_row = mega_interleave_phase(dev, spec, cages, c_envs, c_st, c_gl, c_mk, c_ops, mega_s,
                                      problems[:MBM_CHECK], ss)

    # --- the pointcloud path ----------------------------------------------
    # the 700 scenes again; start and goal are the first two configurations
    # the fkcc kernel finds valid among the scene's cylinders and boxes, the
    # obstacles the cloud samples (its spheres are not sampled)
    pc_scenes = mbm_shaped_problems(KERNEL_PROBLEMS, seed=1)
    cb_envs = mbm.build_batch([dict(p, sphere=[]) for p in pc_scenes], device=dev)[0]
    ok_cb = fkcc_cuda.fkcc_batched(spec, cb_envs, q).cpu().numpy()
    pc_rows = [i for i in range(len(pc_scenes)) if ok_cb[i].sum() >= 2]
    for i in pc_rows:
        idx = np.flatnonzero(ok_cb[i])
        pc_scenes[i]["start"] = q_np[i, idx[0]].tolist()
        pc_scenes[i]["goals"] = [q_np[i, idx[1]].tolist()]
    pc_problems = [pc_scenes[i] for i in pc_rows]
    t0 = time.perf_counter()
    pc_all = pointcloud_envs(pc_problems)
    host_build_s = time.perf_counter() - t0
    pc_live = {n: np.zeros(len(pc_problems), np.int64) for n in TABLES}  # no primitive rows
    pc_ops = fkcc_cuda.ops_per_config(spec, pc_live)

    # pc_kernel: the fkcc kernel against its plain version on pointclouds
    pk_envs = pc_all.map(lambda t: t[:PC_CHECK]).to(dev)
    pk_rows = pc_rows[:PC_CHECK]
    pq = q[pk_rows]
    pvk = fkcc_cuda.fkcc_vmin(spec, pk_envs, pq)
    fkcc_cuda.PC_WORK = None
    pok = fkcc_cuda.fkcc_batched(spec, pk_envs, pq)
    pwork = fkcc_cuda.PC_WORK.cpu()
    pvp = fkcc_cuda.fkcc_vmin_plain(spec, pk_envs, pq)
    torch.cuda.synchronize()
    check(torch.equal(pok, pvk >= 0), "pointcloud kernel validity agrees with its own vmin")
    p_mism = (pvk >= 0) != (pvp >= 0)
    p_out = p_mism & (pvp.abs() > CONTACT_BAND)
    p_err = float(p_out.float().max())  # validity, the kernel's output
    pk_ms = time_cuda(lambda: fkcc_cuda.fkcc_batched(spec, pk_envs, pq), 3, 20)
    pk_occupancy = dict(fkcc_cuda.LAST_LAUNCH)
    pp_ms = time_cuda(lambda: fkcc_cuda.fkcc_vmin_plain(spec, pk_envs, pq), 1, 3)
    pk_bound = bound(
        int(pc_ops[:PC_CHECK].sum()) * KERNEL_CONFIGS + fkcc_cuda.pc_ops(pwork),
        nbytes(pq, *pk_envs.pck) + sum(v.nbytes for v in tabs.values()
                                       if isinstance(v, np.ndarray)) + pq.shape[0] * pq.shape[1])
    pk_valid = float((pvk >= 0).float().mean())
    emit({"phase": "pc_kernel", "problems": PC_CHECK, "configs_per_problem": KERNEL_CONFIGS,
          "samples_per_object": PC_SAMPLES, "host_build_s_all_scenes": host_build_s,
          "scenes": len(pc_problems), "live_chunks_mean": float(pk_envs.pck.meta[:, 0, 6].mean()),
          "valid_share": pk_valid, "mismatches": int(p_mism.sum()),
          "mismatches_inside_band": int((p_mism & ~p_out).sum()),
          "mismatches_outside_band": int(p_out.sum()), "band": CONTACT_BAND,
          "work": dict(zip(("gates", "chunks", "points"), pwork.tolist())),
          "kernel_ms": pk_ms, "occupancy": pk_occupancy, "plain_ms": pp_ms, **pk_bound,
          "library_ms": None})
    check(int(p_out.sum()) == 0, "pointcloud kernel and plain agree outside the contact band")
    check(0.0 < pk_valid < 1.0, "both outcomes occur on the pointcloud scenes")

    # suite_pointcloud: this slice's main path, run_suite_pointcloud at its
    # defaults; if the node-buffer guard refuses the 16x retry at 4096 node
    # rows, again at run_suite's 16384
    pc_data = {"problems": {"mbm_shaped": pc_problems}}
    pc_settings = mbm.pointcloud_settings("panda")
    attempts = []
    while True:
        for lib in kernels.values():
            lib.LAUNCHES = 0
            lib.PC_WORK = None
        rrtc_mega.PAST_MAX_PATH = 0
        t0 = time.perf_counter()
        try:
            pc_res, ptm = mbm.run_suite_pointcloud("panda", data=pc_data, settings=pc_settings)
        except ValueError as e:
            if "cannot hold" not in str(e) or pc_settings.max_samples >= PC_RETRY_SAMPLES:
                raise
            attempts.append({"max_samples": pc_settings.max_samples, "refused": str(e),
                             "wall_s": time.perf_counter() - t0})
            pc_settings = dataclasses.replace(pc_settings, max_samples=PC_RETRY_SAMPLES)
            continue
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
        break
    pc_launches = {n: lib.LAUNCHES for n, lib in kernels.items()}
    pc_points = {n: (lib.PC_WORK.tolist() if lib.PC_WORK is not None else [0, 0, 0])
                 for n, lib in kernels.items()}
    psum = pc_res.summary()
    p_solved = np.asarray(pc_res.plan.solved) & pc_res.valid
    p_reval = paths_revalidate_plain(spec, pc_all.to(dev), pc_res.simplified.path,
                                     pc_res.simplified.path_length).cpu().numpy()
    emit({"phase": "suite_pointcloud", "problems": len(pc_problems), "wall_s": pwall,
          "max_samples": pc_settings.max_samples, "refused_attempts": attempts,
          "summary": psum, "filter_median_ms": ptm["filter_median_ms"],
          "build_median_ms": ptm["build_median_ms"], "phases": ptm["phases"],
          "launches": pc_launches, "pc_work": pc_points,
          "past_max_path": rrtc_mega.PAST_MAX_PATH,
          "solved_paths_revalidated_plain": int((p_reval & p_solved).sum())})
    print(pc_res.percentile_table(), flush=True)
    check(all(v > 0 for v in pc_launches.values()), "the pointcloud path launched every kernel")
    check(all(w[2] > 0 for w in pc_points.values()),
          "every kernel evaluated pointcloud points on the pointcloud path")
    check(bool(p_reval[p_solved].all()), "every solved pointcloud path revalidates (plain)")
    check(psum["solved_problems"] > 0 and np.isfinite(
        np.asarray(pc_res.simplified.cost)[p_solved]).all(), "finite solved pointcloud costs")

    # rrtc_mega_pc / simplify_mega_pc: the megakernels against their plain
    # versions on the first PC_CHECK pointcloud scenes, at the budget
    c_st = torch.as_tensor(np.asarray([p["start"] for p in pc_problems[:PC_CHECK]],
                                      np.float32), device=dev)
    c_gl = torch.as_tensor(np.asarray([p["goals"] for p in pc_problems[:PC_CHECK]],
                                      np.float32), device=dev)
    c_mk = torch.ones(c_gl.shape[:2], dtype=torch.bool, device=dev)
    kp = rrtc_mega.plan_batch_mega(spec, pk_envs, c_st, c_gl, c_mk, pc_settings, device=dev)
    t0 = time.perf_counter()
    pp = rrtc.plan_batch_compact(spec, pk_envs, c_st, c_gl, c_mk, pc_settings, device=dev)
    torch.cuda.synchronize()
    rpc_plain_ms = (time.perf_counter() - t0) * 1e3
    same_pc = same_plan(kp, pp)
    ctl, nodes0, _, _ = rrtc_mega.mega_inputs(spec, pk_envs, c_st, c_gl, c_mk, pc_settings)
    _, rp_scal, rp_work = rrtc_mega_cuda.plan(spec, pk_envs, ctl, nodes0, pc_settings)
    rp_work = rp_work.cpu().numpy().astype(np.int64)
    rp_launch = launch_line(rrtc_mega_cuda, rp_work)
    rpc_ms = time_cuda(lambda: rrtc_mega_cuda.plan(spec, pk_envs, ctl, nodes0, pc_settings), 1, 3)
    rpc_bound = bound(
        int(np.sum(rp_work[:, 0] * pc_ops[:PC_CHECK])) + fkcc_cuda.pc_ops(rp_work[:, 2:5])
        + int(rp_work[:, 1].sum()) * rrtc_mega_cuda.ops_per_pair(spec.dimension),
        nbytes(ctl, nodes0, *pk_envs.pck)
        + int(rp_scal[:, 6].sum()) * (spec.dimension + 4) * 4
        + PC_CHECK * (pc_settings.max_path * spec.dimension + rrtc_mega_cuda.SCALARS
                      + 2 * (rrtc_mega_cuda.WORK + len(rrtc_mega_cuda.PHASES))) * 4)
    k_ = torch.arange(kp.path.shape[1], device=dev)
    rpc_err = float(torch.where((k_[None] < pp.path_length[:, None])[..., None],
                                (kp.path - pp.path).abs(), 0).max())
    emit({"phase": "rrtc_mega_pc", "problems": PC_CHECK, "max_samples": pc_settings.max_samples,
          "identical_share": float(same_pc.float().mean()),
          "solved": {"kernel": int(kp.solved.sum()), "plain": int(pp.solved.sum())},
          "ms": rpc_ms, "plain_ms": rpc_plain_ms, "max_abs_err": rpc_err,
          "work": dict(zip(("configs", "pairs", "gates", "chunks", "points"),
                           rp_work.sum(0).tolist())),
          **rp_launch, **rpc_bound, "library_ms": None})
    check(float(same_pc.float().mean()) >= MIN_SHARE, "rrtc_mega equals plain on pointclouds")

    sp_in, sl_in = pp.path.contiguous(), pp.path_length.to(torch.int32)
    ks = simplify_mega.simplify_batch_mega(spec, pk_envs, pp.path, pp.path_length, ss,
                                           device=dev)
    t0 = time.perf_counter()
    ps = simplify_mega.simplify_batch_plain(spec, pk_envs, pp.path, pp.path_length, ss)
    torch.cuda.synchronize()
    spc_plain_ms = (time.perf_counter() - t0) * 1e3
    spc_len = ks.path_length == ps.path_length
    spc_cost = (ks.cost - ps.cost).abs() <= SIMPLIFY_RTOL * ps.cost.abs()
    sp_work = simplify_mega_cuda.simplify(spec, pk_envs, sp_in, sl_in, ss)[2]
    sp_work = sp_work.cpu().numpy().astype(np.int64)
    sp_launch = launch_line(simplify_mega_cuda, sp_work)
    spc_ms = time_cuda(lambda: simplify_mega_cuda.simplify(spec, pk_envs, sp_in, sl_in, ss), 1, 3)
    spc_bound = bound(int(np.sum(sp_work[:, 0] * pc_ops[:PC_CHECK]))
                      + fkcc_cuda.pc_ops(sp_work[:, 1:4]),
                      2 * nbytes(sp_in) + nbytes(sl_in, *pk_envs.pck) + PC_CHECK * (2 * 4 + 32))
    spc_err = float(torch.where(spc_len[:, None, None], (ks.path - ps.path).abs(), 0).max())
    emit({"phase": "simplify_mega_pc", "problems": PC_CHECK,
          "equal_length_share": float(spc_len.float().mean()),
          "cost_rtol_share": float(spc_cost.float().mean()), "rtol": SIMPLIFY_RTOL,
          "ms": spc_ms, "plain_ms": spc_plain_ms, "max_abs_err": spc_err,
          "work": dict(zip(("configs", "gates", "chunks", "points"), sp_work.sum(0).tolist())),
          **sp_launch, **spc_bound, "library_ms": None})
    check(float(spc_len.float().mean()) >= MIN_SHARE
          and float(spc_cost.float().mean()) >= MIN_SHARE,
          "simplify_mega equals plain on pointclouds")

    # probe_gather: the six gather probes against numpy (off the main path;
    # their launches counted through the probe entry point, `gather.gather`)
    probes, g_launches = {}, 0
    for pname in gather.PROBES:
        tab, gi, gi2 = gather.inputs(pname, PROBE_TILES, seed=3, device=dev)
        before = gather.LAUNCHES
        got = gather.gather(pname, tab, gi, gi2).cpu().numpy()
        g_launches += gather.LAUNCHES - before
        want = gather.reference(pname, tab.cpu().numpy(), gi.cpu().numpy(),
                                None if gi2 is None else gi2.cpu().numpy())
        g_ms = time_cuda(lambda: gather.launch(pname, tab, gi, gi2), 3, 20)
        g_plain = time_cuda(lambda: gather.plain(pname, tab, gi, gi2), 1, 5)
        per = PROBE_TILES * 1024 * (gather.TIMING_GATHERS if pname == "timing" else 1)
        ops, g_bytes = gather.work(pname, PROBE_TILES)
        probes[pname] = {"equal": bool(np.array_equal(got, want)), "ms": g_ms,
                         "plain_ms": g_plain, "ns_per_gather": g_ms * 1e6 / per,
                         **bound(ops, g_bytes)}
    gather_row = {"name": "probe_gather", "route": "cuda",
                  "source": "vamp_mvt_tpu_torch/csrc/probe_gather.cu",
                  "replaces": "tools/probe_gather.py:32",
                  "replaces_all": "tools/probe_gather.py:32,47,62,85,99,121",
                  "launches": g_launches, "on_main_path": False,
                  "max_abs_err": 0.0 if all(v["equal"] for v in probes.values()) else None,
                  "ms": probes["timing"]["ms"], "plain_ms": probes["timing"]["plain_ms"],
                  "bound_ms": probes["timing"]["bound_ms"],
                  "bound_by": probes["timing"]["bound_by"], "library_ms": None,
                  "ms_of": "the timing probe (each probe in the phase line)",
                  "checked_against_plain": True}
    emit({"phase": "probe_gather", "tiles": PROBE_TILES, "probes": probes, "kernel": gather_row})
    check(all(v["equal"] for v in probes.values()), "every gather probe equals numpy")
    check(g_launches == len(gather.PROBES), "the probe entry point launched every gather probe")

    # --- attachments and heightfields (this slice) ------------------------
    branch_rows, api_launches, batches = branch_phases(dev, spec, q, ss)

    # --- the Mosaic probes, the other robots, the roadmap planners (this slice)
    mosaic_row = probe_mosaic_phase(dev)
    robot_rows = suite_robots_phase(dev, ss)
    prm_row, planner_calls = api_planners_phase(dev)

    # --- fkcc at the one-problem paths' launch shapes (this slice) ---------
    path_rows, path_lines = fkcc_paths_phase(dev, api_launches, planner_calls, batches)
    prm_row["sample_wave_ms"] = path_lines["prm_samples"]["kernel_ms"]

    # --- bench: the port's bench entry on its default source (this slice) --
    bench_phase()

    emit({"kernels": [
        row("fkcc", kernel_ms, plain_ms, kernel, max_abs_err, mega_launches["fkcc"])
        | {"replaces": "vamp_mvt_tpu/ops/kernels/fkcc_pallas.py:568",
           "occupancy": kernel_occupancy, "ms_of": "700 x 1024 MBM-shaped configurations",
           "launches_of": "suite_mega (its shapes: fkcc_bench_path)",
           "replaces_function": "vamp_mvt_tpu/ops/kernels/fkcc_pallas.py::_run",
           "launches_xla_suite": launches},
        bench_fkcc_row,
        row("rrtc_mega", rrtc_ms, rrtc_plain_ms, r_bound, rrtc_err, mega_launches["rrtc_mega"])
        | {"replaces": "vamp_mvt_tpu/planning/rrtc_mega.py:943",
           "replaces_function": "vamp_mvt_tpu/planning/rrtc_mega.py::_run_mega",
           "warps_per_sm": r_launch["occupancy"]["warps_per_sm"],
           "phase_share": r_launch["phase_share"]},
        inter_row,
        row("simplify_mega", simp_ms, simp_plain_ms, s_bound, simp_err,
            mega_launches["simplify_mega"])
        | {"replaces": "vamp_mvt_tpu/planning/simplify_mega.py:377",
           "replaces_function": "vamp_mvt_tpu/planning/simplify_mega.py::_run",
           "warps_per_sm": s_launch["occupancy"]["warps_per_sm"],
           "phase_share": s_launch["phase_share"]},
        # the pointcloud branch in each kernel, on this slice's path
        row("fkcc", pk_ms, pp_ms, pk_bound, p_err, pc_launches["fkcc"])
        | {"name": "fkcc_pc", "replaces": "vamp_mvt_tpu/ops/kernels/fkcc_pallas.py:568",
           "occupancy": pk_occupancy,
           "replaces_function": "vamp_mvt_tpu/ops/kernels/fkcc_pallas.py::tile_vmin "
                                "pointcloud branch (248-457)",
           "max_abs_err_of": "validity outside the contact band"},
        row("rrtc_mega", rpc_ms, rpc_plain_ms, rpc_bound, rpc_err, pc_launches["rrtc_mega"])
        | {"name": "rrtc_mega_pc", "replaces": "vamp_mvt_tpu/planning/rrtc_mega.py:943",
           "replaces_function": "vamp_mvt_tpu/planning/rrtc_mega.py::_run_mega on pck",
           "warps_per_sm": rp_launch["occupancy"]["warps_per_sm"],
           "phase_share": rp_launch["phase_share"]},
        row("simplify_mega", spc_ms, spc_plain_ms, spc_bound, spc_err,
            pc_launches["simplify_mega"])
        | {"name": "simplify_mega_pc", "replaces": "vamp_mvt_tpu/planning/simplify_mega.py:377",
           "replaces_function": "vamp_mvt_tpu/planning/simplify_mega.py::_run on pck",
           "warps_per_sm": sp_launch["occupancy"]["warps_per_sm"],
           "phase_share": sp_launch["phase_share"]},
        *path_rows,
        *branch_rows,
        gather_row,
        mosaic_row,
        *robot_rows,
        prm_row,
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
