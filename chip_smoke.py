#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (vamp_mvt_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as one JSON line with `t_s`, the seconds since the
script started, when it ended (no failure is caught: a failed check or an
exception exits non-zero):

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
                 budget and the solved rows' goals replaced by their starts
                 (problems that end at once); then on the 700
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
                 first MBM_CHECK of those scenes (capsule and cuboid tables)
                 at the budget (at least MIN_SHARE of the results
                 identical), then run_suite's 32x retry of the unsolved
                 rows alone by the kernel alone (mega_interleave compares
                 the plain retry); every solved path revalidated by the
                 plain version, each launch's cluster size
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
  rrtc_mega_single
                 the planner kernel one problem a launch (a cloud request,
                 a lone problem's retry), each on a cluster of
                 SINGLE_CLUSTER blocks: the first SINGLE_CHECK cages, the
                 MBM_CHECK MBM-shaped scenes and the first SINGLE_CHECK
                 pointcloud scenes at the budget, then those left unsolved
                 (every one, where none is) at the runner's retry budget
                 (32x, 16x on clouds); at each, one launch a problem, at
                 least MIN_SHARE identical to the plain planner on the same
                 problems, every solved path revalidated by the plain
                 version
  evaluate_mbm   the main path's command line (examples/evaluate_mbm.py's
                 port) on its default device: the 700 cages through
                 --problems_pkl at --planner auto --batch_size 700 --table
                 (valid = solved = 700, every path revalidated by the plain
                 version, every kernel launched, the median simplified cost
                 equal to suite_mega's), then the first PC_CHECK pointcloud
                 scenes through --pointcloud at its defaults (every solved
                 path revalidated, every kernel launched); walls, problems/s
  probe_gather   the six gather probes (csrc/probe_gather.cu, off the main
                 path) against numpy and their plain versions, with the
                 launches of the probe entry point, ns per gather and per
                 element, and bench/time_probes.py's times: one call with
                 the host's work, the card's time alone with the L2 cold,
                 the same of the PyTorch call that computes the probe where
                 one does (time_probes.GATHER_LIBRARY); fails if a probe's
                 share of its bound reads over MAX_SHARE
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
                 numpy, tile 0 against the probe files' constants; times
                 and bounds as probe_gather's (the L2 cold where ten copies
                 of a launch's bytes overflow it), a PyTorch call's times
                 where one computes the probe's function, an empty kernel's
                 graph-replayed time; fails as probe_gather does
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
                 largest size, one FCIT edge, suite_robots' 2048 x 1024 draws
                 for UR5, Fetch and Baxter; each against its plain
                 version (no validity mismatch outside the contact and cell
                 bands), with its time, bound and launch shape
  aorrtc         panda.aorrtc at the API's defaults on the card from VAMP's
                 start A to goal B in the sphere cage: every returned segment
                 revalidated by the plain version, the cost against the
                 initial plan's and the straight line, ms, fkcc launches (in
                 all and in its AOX searches) and host syncs; bench/aorrtc.py's
                 solve_batch on AORRTC_PROBLEMS cages (per-round median cost,
                 wall); a REDUCE + SHORTCUT + PERTURB + BSPLINE pass on
                 REDUCE_PATHS cage paths on the card, the first
                 REDUCE_CPU_CHECK repeated on the CPU; fkcc at the
                 AOX step's (1 x 40), a solve_batch round's (32 x 40) and a
                 REDUCE pass's (64 x 440) launch shapes against its plain
                 version, with its time, device time and bound
  mpnet          plan_with_mpnet for the Panda at MPNet's published widths
                 (random weights from the seed) in the sphere cage, its
                 pointcloud sampled from the cage spheres: MPNET_REQUESTS
                 seeded requests on the card (method, ms, fkcc launches,
                 planner forwards; every path revalidated by the plain
                 version), the encoder's and a planner forward's ms against
                 their bounds, the rollouts of MPNET_CPU_CHECK requests on
                 the card against device="cpu" at a cut budget (same method,
                 vertex count and vertices), one request's rollouts untraced
                 and again under utils/profiling.py's trace (top
                 op_breakdown rows, the card's busy share), fkcc at MPNet's
                 motion check (1 x 440 lanes) against its plain version
  mesh           parallel/mesh.py under a world-size-1 NCCL group:
                 plan_batch_mega_sharded on the 700 cages against
                 plan_batch_mega, plan_batch_sharded on MESH_LOCKSTEP cages
                 against rrtc.plan_batch (both identical),
                 aorrtc_restarts_sharded at rounds=2 (history; its
                 all_reduce(MIN) held to the host minimum)
  examples       each vamp_mvt_tpu_torch/examples module's main on the card
                 at the JAX scripts' defaults: solved counts, walls, launches;
                 sphere_cage_example's paths revalidated by the plain version
                 and its first EXAMPLE_PLAIN_CHECK trials held against both
                 megakernels' plain versions
  mpnet_train    MPNet demonstrations and training through a cached parse
                 of TRAIN_PROBLEMS sphere-cage problems (each sphere also a
                 cube, so that a cloud samples it): prepare_mpnet_dataset's
                 port (every demonstration revalidated by the plain version
                 in its cloud), train_mpnet's port at its defaults but
                 --batch for TRAIN_STEPS steps an epoch (pairs, steps, the loss at its first
                 and last printed epoch, a step's ms against its bound), the
                 trained checkpoints on the mpnet phase's requests (methods
                 and ms beside the untrained ones, every solution
                 revalidated)
  mbm_examples   through the same cached parse: evaluate_mbm_mpnet's port
                 with the trained checkpoints (every solution revalidated),
                 prepare_query_dataset's port (`collides` equal to the plain
                 mvt_collides on the CPU)
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
rows with the launches of their entry point; fkcc at the AORRTC shapes with
the launches of panda.aorrtc's AOX searches, of solve_batch's and of the
REDUCE/PERTURB pass; fkcc at MPNet's motion check with the launches of the
mpnet phase's rollouts; each gather and Mosaic probe a row) and, last, {"ok": true,
"device": {...}}.  The script imports nothing of JAX or of the JAX package.  Without a
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
SINGLE_CHECK = 16   # cages and pointcloud scenes planned one a launch
SINGLE_CLUSTER = 8  # blocks a problem of a one-problem launch (rrtc_mega_cuda.cluster_size)
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
AORRTC_PROBLEMS = 32   # cages of bench/aorrtc.py's solve_batch
AORRTC_BATCH_ITERATIONS = 32768  # its anytime budget (bench/aorrtc.py's default)
REDUCE_PATHS = 64      # cage paths of the REDUCE + SHORTCUT + PERTURB + BSPLINE pass
REDUCE_CPU_CHECK = 8   # of them, the CPU repeats (its plain SHORTCUT takes ~10 s a path)
GATHER_LINES = {"lane": 32, "row": 47, "bits": 62, "two_level": 85, "sublane": 99,
                "timing": 121}  # tools/probe_gather.py's pl.pallas_call of each probe
MOSAIC_LINES = {  # the pl.pallas_call of each Mosaic probe
    "while_carry": "tools/probe_mosaic.py:40", "dyn_sublane": "tools/probe_mosaic.py:64",
    "smem_writes": "tools/probe_mosaic.py:90", "dot_argmin": "tools/probe_mosaic.py:110",
    "nested_loops": "tools/probe_mosaic.py:141", "grid_carry": "tools/probe_mosaic.py:169",
    "group32_sum": "tools/probe_mosaic.py:190", "scratch_diag": "tools/probe_mosaic.py:212",
    "reduce_while": "tools/probe_mosaic2.py:37", "halton_digits": "tools/probe_mosaic2.py:58",
    "cumsum_first": "tools/probe_mosaic2.py:91", "transpose": "tools/probe_mosaic2.py:117",
    "static_reads": "tools/probe_mosaic2.py:134", "dyn_rows_while": "tools/probe_mosaic2.py:160",
    "smem_int_out": "tools/probe_mosaic2.py:184",
}
MAX_SHARE = 1.05  # a probe whose time reads under its bound by more than this: a wrong bound
# Mosaic probes whose library call (time_probes.mosaic_library) computes the
# whole output, checked equal to the plain version; the others' computes a part
MOSAIC_LIBRARY_WHOLE = ("dot_argmin", "grid_carry", "group32_sum", "transpose",
                        "smem_writes", "smem_int_out")
MPNET_REQUESTS = 8     # plan_with_mpnet requests in the sphere cage
MPNET_CPU_CHECK = 2    # of them, rerun on the card and on the CPU at a cut budget
MPNET_CPU_ITERATIONS = 2  # MPNetPlanner.plan's max_iterations of those reruns (the default is 50)
MPNET_VERTEX_ATOL = 1e-4  # card against CPU rollout vertices (the port against JAX on the CPU)
EXAMPLE_PLAIN_CHECK = 32  # sphere_cage_example trials held against the plain versions
MPNET_CLOUD = 1000     # surface points a cage sphere (14,000 in all, subsampled to 11,978)
MESH_LOCKSTEP = 64     # cages of the sharded lockstep planner
TRAIN_PROBLEMS = 16    # MPNet demonstrations (sphere-cage problems) the trainer learns from
TRAIN_SEED = 41        # their seeded requests (the mpnet phase's are seed 40)
TRAIN_STEPS = 6        # train_mpnet's steps an epoch: its --batch is the largest multiple of 16
                       # (at most its default, 256) that gives as many steps
TRAIN_EPOCHS = 400     # train_mpnet's --epochs (its default)
EXAMPLE_MPNET_PROBLEMS = 4  # of them, evaluate_mbm_mpnet plans
EXAMPLE_QUERY_PROBLEMS = 5  # and prepare_query_dataset queries (its default --count)


START = time.perf_counter()


def emit(obj) -> None:
    """Print one JSON line; a phase line also carries `t_s`, the seconds
    since the script started (the time budget, phase by phase)."""
    if "phase" in obj:
        obj = {**obj, "t_s": round(time.perf_counter() - START, 1)}
    print(json.dumps(obj), flush=True)


def phase_times(timings: dict) -> dict:
    """A runner's timings without the span log (utils/profiling.py): the
    seconds of each span and the counts."""
    return {k: v for k, v in timings.items() if k != "spans"}


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
    for p in problems:  # (MVT builds faster than CAPT; the kernel form is the same)
        b = pipeline.problem_to_pointcloud_env("panda", p, pc_repr="mvt",
                                               samples_per_object=PC_SAMPLES)[0]
        envs.append(envmod.EnvironmentBuilder(pck=b.pck).build(device="cpu"))
    return envmod.stack_environments(envs)


def bound(ops: int, n_bytes: int) -> dict:
    """The card's least time for `ops` FP32 operations moving `n_bytes`, at
    the H100 SXM peaks of `bench/time_probes.py` (imported here, once the
    checkout is on sys.path)."""
    from vamp_mvt_tpu_torch.bench.time_probes import bound as card_bound

    return card_bound(ops, n_bytes)


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


def branch_kernel(spec, envs, q, layout="lanes", plain_reps=3):
    """The fkcc kernel against its plain version on `envs` (payload and/or
    heightfield tables): validity outside the contact band and the cell
    band, both outcomes, times (of the launch in `layout`, rows or lanes)
    with its launch shape and occupancy, and the bound (the live payload
    spheres' operations; the heights read, not the whole table); and the
    kernel's validity.  The plain version is timed over `plain_reps` calls
    after one to warm up."""
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
    p_ms = time_cuda(lambda: fkcc_cuda.fkcc_batched_plain(spec, envs, q), 1, plain_reps)
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


def retry_compare(spec, envs, st, gl, mk, settings, plain_retry: bool = True) -> dict:
    """The planner kernel against its plain version (in the cadence
    `settings.interleave` names) at the budget, then as run_suite's retry
    (bench/mbm.py::_mega_solver: the rows left unsolved, gathered alone, at
    32x the budget): at least MIN_SHARE of each launch's rows identical,
    every solved path revalidated by the plain version, each launch's
    cluster size read.  Without `plain_retry` the retry runs the kernel
    alone (its solved paths still revalidated): the plain planner's retry
    is the longest comparison."""
    import dataclasses

    import torch

    from vamp_mvt_tpu_torch.ops.kernels import rrtc_mega_cuda
    from vamp_mvt_tpu_torch.planning import rrtc, rrtc_mega

    dev = st.device
    out, rows = {}, torch.arange(len(st), device=dev)
    for budget in (settings.max_iterations, 32 * settings.max_iterations):
        check(len(rows) > 0, f"problems to compare at budget {budget}")
        e, s, g, m = envs.map(lambda t: t[rows]), st[rows], gl[rows], mk[rows]
        rrtc_mega.PAST_MAX_PATH = 0
        t0 = time.perf_counter()
        got = rrtc_mega.plan_batch_mega(spec, e, s, g, m, settings, budget=budget, device=dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ok = paths_revalidate_plain(spec, e, got.path, got.path_length)
        out[str(budget)] = {
            "problems": len(rows), "cluster": rrtc_mega_cuda.LAST_LAUNCH["cluster"],
            "solved": {"kernel": int(got.solved.sum())}, "past_max_path": rrtc_mega.PAST_MAX_PATH,
            "solved_paths_revalidated_plain": int((ok & got.solved).sum()), "kernel_s": t1 - t0}
        check(bool(ok[got.solved].all()), f"every solved path revalidates at budget {budget}")
        if plain_retry or budget == settings.max_iterations:
            ref = rrtc.plan_batch_compact(spec, e, s, g, m,
                                          dataclasses.replace(settings, max_iterations=budget),
                                          device=dev, interleave=settings.interleave)
            torch.cuda.synchronize()
            same = same_plan(got, ref)
            out[str(budget)] |= {"identical": int(same.sum()),
                                 "plain_s": time.perf_counter() - t1}
            out[str(budget)]["solved"]["plain"] = int(ref.solved.sum())
            check(float(same.float().mean()) >= MIN_SHARE,
                  f"rrtc_mega (interleave={settings.interleave}) equals plain at budget {budget}")
        rows = rows[~got.solved]
    return out


def single_request_phase(dev, spec, cases) -> None:
    """The planner kernel as a single request launches it (B = 1: a cloud
    request of run_suite_pointcloud(batch_size=1), one problem alone), at
    SINGLE_CLUSTER blocks a problem.  For each case (name, envs, starts,
    goals, masks, settings, its runner's retry factor, rows): each of its
    first `rows` problems planned alone at the budget, then each it left
    unsolved (every one, where none is left) alone at factor x the budget,
    as the retry plans it; the rrtc_mega launches counted (reset just
    before) and each launch's cluster size read; the kernel's results
    against the plain planner's on the same problems, at least MIN_SHARE
    identical at each budget, every solved path revalidated by the plain
    version."""
    import dataclasses

    import torch

    from vamp_mvt_tpu_torch.ops.kernels import rrtc_mega_cuda
    from vamp_mvt_tpu_torch.planning import rrtc, rrtc_mega

    out = {}
    for name, envs, st, gl, mk, settings, factor, n in cases:
        line, rows = {}, list(range(n))
        for budget in (settings.max_iterations, factor * settings.max_iterations):
            rrtc_mega_cuda.LAUNCHES = 0
            got, clusters = [], []
            t0 = time.perf_counter()
            for r in rows:
                got.append(rrtc_mega.plan_batch_mega(
                    spec, envs.map(lambda t: t[r:r + 1]), st[r:r + 1], gl[r:r + 1], mk[r:r + 1],
                    settings, budget=budget, device=dev))
                clusters.append(rrtc_mega_cuda.LAST_LAUNCH["cluster"])
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            launches = rrtc_mega_cuda.LAUNCHES
            got = type(got[0])(*(torch.cat(f) for f in zip(*got)))
            idx = torch.as_tensor(rows, device=dev)
            e = envs.map(lambda t: t[idx])
            ref = rrtc.plan_batch_compact(spec, e, st[idx], gl[idx], mk[idx],
                                          dataclasses.replace(settings, max_iterations=budget),
                                          device=dev, interleave=settings.interleave)
            torch.cuda.synchronize()
            same = same_plan(got, ref)
            ok = paths_revalidate_plain(spec, e, got.path, got.path_length)
            line[str(budget)] = {
                "problems": len(rows), "launches": launches, "clusters": sorted(set(clusters)),
                "identical": int(same.sum()),
                "solved": {"kernel": int(got.solved.sum()), "plain": int(ref.solved.sum())},
                "solved_paths_revalidated_plain": int((ok & got.solved).sum()),
                "kernel_s": t1 - t0, "plain_s": time.perf_counter() - t1}
            what = f"{name} alone at budget {budget}"
            check(launches == len(rows), f"one rrtc_mega launch a problem, {what}")
            check(set(clusters) == {SINGLE_CLUSTER}, f"a cluster of {SINGLE_CLUSTER}, {what}")
            check(float(same.float().mean()) >= MIN_SHARE, f"rrtc_mega equals plain, {what}")
            check(bool(ok[got.solved].all()), f"every solved path revalidates, {what}")
            rows = [r for r, ok_ in zip(rows, got.solved.tolist()) if not ok_] or rows
        out[name] = line
    emit({"phase": "rrtc_mega_single", "min_share": MIN_SHARE, "cases": out})


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
                       + 2 * rrtc_mega_cuda.WORK_COLS) * 4)
    cages_line = {"problems": len(c_st), **{n: c["line"] for n, c in cad.items()},
                  "identical_share": float(same.float().mean()),
                  "solved_plain": int(pres.solved.sum()), "diverged": diverged,
                  "index_order_plain_equals_kernel": replay, "plain_ms": plain_ms,
                  "solved_paths_revalidated_plain": int((reval & kres.solved).sum()),
                  "work": {"configs": int(work[:, 0].sum()), "pairs": int(work[:, 1].sum())},
                  **r_bound}

    # the MBM-shaped scenes at the budget, then as run_suite's retry (32x on
    # the unsolved rows alone), both cadences' kernels at the budget
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
    suite_line = {"wall_s": swall, "summary": ssum, "timings": phase_times(tm),
                  "launches": launches, "past_max_path": past,
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
    from vamp_mvt_tpu_torch.bench import scenes
    from vamp_mvt_tpu_torch.collision import environment as envmod
    from vamp_mvt_tpu_torch.ops.kernels import fkcc_cuda

    cage, A, B = scenes.api_cage()
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
    (210 edges of 440 points), one FCIT edge (440 points), and suite_robots'
    draw of 2048 x 1024 configurations for UR5, Fetch and Baxter; each
    against its plain version (no validity mismatch outside the contact and
    cell bands), with its time, bound and launch shape.  Returns the kernels
    line's rows of the attachment and heightfield branches (at the API's
    step, with the API's launches; the 700-problem batches of attach_kernel
    and hf_kernel beside them), of FCIT's edges and of the draws."""
    from vamp_mvt_tpu_torch.bench import time_fkcc

    cases = time_fkcc.path_cases(dev, ("api_rrtc_step", "sphere_api_step", "prm_samples",
                                       "prm_edges", "fcit_edge") + time_fkcc.ROBOT_DRAWS)
    held = {}
    for name, (spec, envs, q, layout) in cases.items():
        qr = q if layout == "rows" else q.transpose(1, 2).contiguous()
        # the plain version takes 1-7 s a draw: timed once
        held[name] = branch_kernel(spec, envs, qr, layout,
                                   1 if name in time_fkcc.ROBOT_DRAWS else 3)[0]
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
    for case in time_fkcc.ROBOT_DRAWS:
        r = held[case]
        rows.append(row("fkcc", r["kernel_ms"], r["plain_ms"], r, r["max_abs_err"], 1)
                    | {"name": f"fkcc_{case}",
                       "replaces": "vamp_mvt_tpu/ops/kernels/fkcc_pallas.py:568",
                       "occupancy": r["occupancy"],
                       "launches_of": "suite_robots' draw of the robot's endpoints",
                       "ms_of": f"one launch, {r['problems']} x {r['configs_per_problem']} rows"})
    return rows, held


def probe_row(name, src, replaces, r, launches) -> dict:
    """The kernels line's row of one probe from its phase record."""
    return {"name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches, "on_main_path": False, "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"], "library": r["library"],
            "device_ms": r["device_ms"], "library_device_ms": r["library_device_ms"],
            "l2": r["l2"], "share": r["share"], "checked_against_plain": True}


def probe_gather_phase(dev) -> tuple[dict, list[dict]]:
    """The six gather probes (csrc/probe_gather.cu, off the main path) on
    PROBE_TILES tiles through the probe entry point (`gather.gather`, once
    each, each probe's launches counted), against numpy and the plain
    version, and the library calls against the plain version; then
    `bench/time_probes.py`'s times: `ms` (one call, the host's work
    included), `device_ms` (the card alone: a 10-launch CUDA graph rotating
    over copies of the inputs and outputs that overflow the L2), the same
    two of the one PyTorch call that computes the probe where there is one
    (`library_ms`, `library_device_ms`), the bound and its share.  The
    timing kernel builds its 128-entry window table once a block and then
    makes one lookup an element, so `ns_per_gather` (ns over the 64 gathers
    an element the probe's function sums) sits beside `ns_per_element`.
    Fails if a probe's share of its bound reads over MAX_SHARE.  Returns the
    kernels line's summary row (the timing probe) and the others' rows."""
    import numpy as np
    import torch

    from vamp_mvt_tpu_torch.bench import time_probes
    from vamp_mvt_tpu_torch.probes import gather

    probes, launches = {}, {}
    for p in gather.PROBES:
        tab, gi, gi2 = gather.inputs(p, PROBE_TILES, seed=time_probes.GATHER_SEED, device=dev)
        before = gather.LAUNCHES
        got = gather.gather(p, tab, gi, gi2)
        launches[p] = gather.LAUNCHES - before
        want = gather.reference(p, tab.cpu().numpy(), gi.cpu().numpy(),
                                None if gi2 is None else gi2.cpu().numpy())
        plain = gather.plain(p, tab, gi, gi2)
        lib = time_probes.GATHER_LIBRARY[p][0]
        if lib is not None:
            check(torch.equal(lib(tab, gi.long(), None if gi2 is None else gi2.long()), plain),
                  f"the library call computes the {p} probe")
        probes[p] = {"equal": bool(np.array_equal(got.cpu().numpy(), want)),
                     "equal_plain": torch.equal(got, plain),
                     "max_abs_err": float((got.double() - plain.double()).abs().max()),
                     "plain_ms": time_cuda(lambda: gather.plain(p, tab, gi, gi2), 1, 5)}
    for p, r in time_probes.time_gather(gather, gather, dev, PROBE_TILES).items():
        per = PROBE_TILES * 1024 * (gather.TIMING_GATHERS if p == "timing" else 1)
        probes[p] |= r | {"ns_per_gather": r["ms"] * 1e6 / per}
    rows = {p: probe_row(f"probe_gather_{p}", "vamp_mvt_tpu_torch/csrc/probe_gather.cu",
                         f"tools/probe_gather.py:{GATHER_LINES[p]}", r, launches[p])
            for p, r in probes.items()}
    total = sum(launches.values())
    summary = rows["timing"] | {
        "name": "probe_gather", "replaces_all": "tools/probe_gather.py:32,47,62,85,99,121",
        "launches": total, "max_abs_err": max(r["max_abs_err"] for r in probes.values()),
        "ms_of": "the timing probe (the others: probe_gather_<name>)"}
    emit({"phase": "probe_gather", "tiles": PROBE_TILES, "launches": launches,
          "probes": probes, "kernel": summary})
    for p, r in probes.items():
        check(r["equal"] and r["equal_plain"], f"gather probe {p} equals numpy and plain")
        check(r["share"] <= MAX_SHARE, f"gather probe {p}'s share of its bound is at most "
              f"{MAX_SHARE}: {r['share']:.3f}")
        check(launches[p] == 1, f"the probe entry point launched the gather probe {p} once: "
              f"{launches[p]}")
    return summary, [rows[p] for p in gather.PROBES if p != "timing"]


def probe_mosaic_phase(dev) -> tuple[dict, list[dict]]:
    """Every P2/P3 probe (csrc/probe_mosaic.cu) on PROBE_TILES tiles through
    the probe entry point (`mosaic.run`, once each, each probe's launches
    counted), against its plain version and numpy, tile 0 against the probe
    file's constants, and the library calls that compute a whole probe
    (MOSAIC_LIBRARY_WHOLE) against the plain version; then `bench/time_probes.py`'s times, as probe_gather_phase
    takes them (`device_ms` rotates over copies that overflow the L2 where
    10 copies of a launch's bytes can: `l2` says "cold", else "warm"), and
    an empty kernel's graph-replayed time (`empty_device_ms`, the floor of
    a launch, with each probe's `floor_ratio`).  Fails if a probe's share
    of its bound reads over MAX_SHARE.  Returns the kernels line's summary
    row and a row for each probe."""
    import numpy as np
    import torch

    from vamp_mvt_tpu_torch.bench import time_probes
    from vamp_mvt_tpu_torch.probes import mosaic

    ins = {p: mosaic.inputs(p, PROBE_TILES, seed=time_probes.MOSAIC_SEED, device=dev)
           for p in mosaic.PROBES}
    got, launches = {}, {}
    for p in mosaic.PROBES:
        before = mosaic.LAUNCHES
        got[p] = mosaic.run(p, *ins[p])
        launches[p] = mosaic.LAUNCHES - before
    torch.cuda.synchronize()
    library = time_probes.mosaic_library(dev)
    probes = {}
    for p in mosaic.PROBES:
        plain = mosaic.plain(p, *ins[p])
        want = mosaic.reference(p, *(t.cpu().numpy() for t in ins[p]))
        if p in MOSAIC_LIBRARY_WHOLE:
            check(torch.equal(library[p][0](*ins[p]).to(plain[0].dtype), plain[0]),
                  f"the library call computes the {p} probe")
        probes[p] = {
            "equal_plain": all(torch.equal(g, w) for g, w in zip(got[p], plain)),
            "equal_numpy": all(np.array_equal(g.cpu().numpy(), w) for g, w in zip(got[p], want)),
            "tile0_probe_constants": mosaic.tile0_ok(p, got[p]),
            "max_abs_err": max(float((g.double() - w.double()).abs().max())
                               for g, w in zip(got[p], plain)),
            "plain_ms": time_cuda(lambda: mosaic.plain(p, *ins[p]), 1, 3)}
    del got, ins
    floor = time_probes.empty_device_ms(mosaic, dev)
    for p, r in time_probes.time_mosaic(mosaic, mosaic, dev, PROBE_TILES).items():
        probes[p] |= r | {"floor_ratio": r["device_ms"] / floor}
    emit({"phase": "probe_mosaic", "tiles": PROBE_TILES, "launches": launches,
          "empty_device_ms": floor, "probes": probes})
    for p, r in probes.items():
        check(launches[p] == 1, f"the probe entry point launched probe {p} once: {launches[p]}")
        check(r["equal_plain"] and r["equal_numpy"], f"probe {p} equals plain and numpy")
        check(r["tile0_probe_constants"], f"probe {p}'s tile 0 gives the probe file's constants")
        check(r["share"] <= MAX_SHARE, f"probe {p}'s share of its bound is at most "
              f"{MAX_SHARE}: {r['share']:.3f}")
    rows = [probe_row(f"probe_mosaic_{p}", "vamp_mvt_tpu_torch/csrc/probe_mosaic.cu",
                      MOSAIC_LINES[p], r, launches[p]) for p, r in probes.items()]
    by = {k: sum(r["bound_ms"] for r in probes.values() if r["bound_by"] == k)
          for k in ("bytes", "operations")}
    summary = {"name": "probe_mosaic", "route": "cuda",
               "source": "vamp_mvt_tpu_torch/csrc/probe_mosaic.cu",
               "replaces": "tools/probe_mosaic.py:40",
               "replaces_all": "tools/probe_mosaic.py:40,64,90,110,141,169,190,212; "
                               "tools/probe_mosaic2.py:37,58,91,117,134,160,184",
               "launches": sum(launches.values()), "on_main_path": False,
               "max_abs_err": max(r["max_abs_err"] for r in probes.values()),
               "ms": sum(r["ms"] for r in probes.values()),
               "plain_ms": sum(r["plain_ms"] for r in probes.values()),
               "bound_ms": sum(r["bound_ms"] for r in probes.values()),
               "bound_by": max(by, key=by.get), "library_ms": None,
               "device_ms": sum(r["device_ms"] for r in probes.values()),
               "empty_device_ms": floor,
               "library_ms_null": "the row sums all 15 probes; each has a row of its own "
                                  "(probe_mosaic_<name>), with its library call or why none",
               "ms_of": "the 15 probes, one launch each, summed",
               "checked_against_plain": True}
    return summary, rows


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
              "summary": summ, "timings": phase_times(tm), "launches": launches,
              "occupancy": occupancy,
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
                              "threads", "group", "cluster", "smem_bytes", "blocks_per_sm",
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


class LaunchTally:
    """Counts the fkcc launches made inside calls of `mod.name` (and the
    calls), passing every call through."""

    def __init__(self, mod, name):
        self.mod, self.name, self.real = mod, name, getattr(mod, name)
        self.launches = self.calls = 0

    def __enter__(self):
        from vamp_mvt_tpu_torch.ops.kernels import fkcc_cuda

        def counted(*args, **kw):
            before = fkcc_cuda.LAUNCHES
            try:
                return self.real(*args, **kw)
            finally:
                self.calls += 1
                self.launches += fkcc_cuda.LAUNCHES - before

        setattr(self.mod, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.real)


def aorrtc_phase(dev):
    """This slice's path: panda.aorrtc at the API's defaults on the card from
    VAMP's start A to goal B in the sphere cage (ms, fkcc launches in all and
    in its AOX searches, host syncs; the cost against the initial plan's and
    the straight line; every segment revalidated by the plain version);
    `bench/aorrtc.py`'s solve_batch on AORRTC_PROBLEMS cages (the per-round
    median cost and the wall); a REDUCE + SHORTCUT + PERTURB + BSPLINE pass
    on REDUCE_PATHS cage paths, the first REDUCE_CPU_CHECK against the CPU;
    fkcc at the AOX step's
    and the REDUCE pass's launch shapes against its plain version.  Returns
    the kernels line's fkcc rows."""
    import numpy as np
    import torch

    import vamp_mvt_tpu_torch as vmt
    from vamp_mvt_tpu_torch.bench import aorrtc as bench_aorrtc
    from vamp_mvt_tpu_torch.bench import mbm, time_fkcc
    from vamp_mvt_tpu_torch.ops.kernels import fkcc_cuda
    from vamp_mvt_tpu_torch.planning import aox, rrtc_mega, simplify

    env = vmt.Environment()
    for c in mbm.CAGE_CENTERS:
        env.add_sphere(vmt.Sphere(c, mbm.CAGE_RADIUS))
    A, B = mbm.PANDA_START, mbm.PANDA_GOAL
    spec = vmt.panda.spec
    envs1 = env.build(dev).map(lambda t: t[None])

    # --- the main path of this slice: panda.aorrtc at the API's defaults
    first = vmt.panda.rrtc(A, B, env)   # the initial plan panda.aorrtc starts from
    fkcc_cuda.LAUNCHES = 0
    aox.HOST_SYNCS = 0
    with LaunchTally(aox, "solve_batch") as tally:
        t0 = time.perf_counter()
        res = vmt.panda.aorrtc(A, B, env)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    L = int(res.path_length)
    ok = paths_revalidate_plain(spec, envs1, res.path[None], [L])
    straight = float(np.linalg.norm(np.subtract(B, A)))
    api = {"ms": ms, "fkcc_launches": fkcc_cuda.LAUNCHES, "aox_searches": tally.calls,
           "aox_fkcc_launches": tally.launches, "host_syncs": aox.HOST_SYNCS,
           "cost": float(res.cost), "initial_cost": float(first.cost), "straight_line": straight,
           "path_vertices": L, "revalidated_plain": bool(ok[0]),
           "settings": "the API's defaults (AORRTCSettings(rrtc=default_rrtc_settings()))"}
    check(L >= 2 and bool(ok[0]), "every segment of panda.aorrtc's path revalidates (plain)")
    check(fkcc_cuda.LAUNCHES > 0 and tally.launches > 0,
          "panda.aorrtc launched the fkcc kernel, its AOX searches too")
    check(float(res.cost) <= float(first.cost) + 1e-5,
          "panda.aorrtc's cost is no worse than the initial plan's")
    check(float(res.cost) >= straight - 1e-4, "panda.aorrtc's cost is at least the straight line")

    # --- bench/aorrtc.py's solve_batch on the cages
    with LaunchTally(aox, "solve_batch") as tally:
        batch = bench_aorrtc.run(AORRTC_PROBLEMS, dev, AORRTC_BATCH_ITERATIONS)
    batch |= {"aox_searches": tally.calls, "aox_fkcc_launches": tally.launches}
    check(batch["solved"] == batch["valid"] == AORRTC_PROBLEMS, "solve_batch solves every cage")
    costs = [r["median_cost"] for r in batch["rounds"]]
    check(all(b <= a + 1e-5 for a, b in zip(costs, costs[1:])),
          "solve_batch's median cost never rises")

    # --- REDUCE + SHORTCUT + PERTURB + BSPLINE on cage paths, card against CPU
    c_envs, c_st, c_gl, c_mk = mbm.build_batch(mbm.cage_suite(REDUCE_PATHS)["problems"]["cage"],
                                               device=dev)
    plan = rrtc_mega.plan_batch_mega(spec, c_envs, c_st, c_gl, c_mk,
                                     mbm.default_settings("panda", "mega"), device=dev)
    check(bool(plan.solved.all()), "the cage paths for the simplifier pass are solved")
    ss = simplify.SimplifySettings(operations=("reduce", "shortcut", "perturb", "bspline"))
    keys = simplify.default_keys(REDUCE_PATHS, dev)
    fkcc_cuda.LAUNCHES = 0
    with LaunchTally(simplify, "_reduce") as red, LaunchTally(simplify, "_perturb") as per:
        t0 = time.perf_counter()
        card = simplify.simplify_batch(spec, c_envs, plan.path, plan.path_length, ss, keys)
        torch.cuda.synchronize()
        card_ms = (time.perf_counter() - t0) * 1e3
    pass_launches = fkcc_cuda.LAUNCHES
    # the CPU repeats the first paths with their keys: a problem's pass does
    # not depend on the others in its batch
    n = REDUCE_CPU_CHECK
    t0 = time.perf_counter()
    cpu = simplify.simplify_batch(spec, c_envs.map(lambda t: t[:n]).to("cpu"),
                                  plan.path[:n].cpu(), plan.path_length[:n].cpu(), ss,
                                  keys[:n].cpu())
    cpu_ms = (time.perf_counter() - t0) * 1e3
    same_len = card.path_length[:n].cpu() == cpu.path_length
    path_err = float((card.path[:n].cpu() - cpu.path).abs().max())
    ok = paths_revalidate_plain(spec, c_envs, card.path, card.path_length.cpu())
    passes = {"paths": REDUCE_PATHS, "cpu_paths": n, "ops": list(ss.operations),
              "card_ms": card_ms, "cpu_ms": cpu_ms, "fkcc_launches": pass_launches,
              "reduce_fkcc_launches": red.launches, "perturb_fkcc_launches": per.launches,
              "equal_length_share": float(same_len.float().mean()),
              "max_abs_path_diff": path_err,
              "median_cost_card": median(card.cost), "median_cost_cpu_paths": median(cpu.cost),
              "median_cost_planned": median(plan.cost), "revalidated_plain": int(ok.sum())}
    check(bool(same_len.all()) and path_err <= 1e-4,
          "REDUCE/PERTURB on the card equal the CPU's")
    check(bool(ok.all()), "every simplified cage path revalidates (plain)")

    # --- fkcc at the AORRTC path's launch shapes against its plain version
    cases = time_fkcc.path_cases(dev, ("aox_step", "aox_batch", "simplify_reduce"))
    held = {}
    for name, (cspec, cenvs, q, layout) in cases.items():
        qr = q if layout == "rows" else q.transpose(1, 2).contiguous()
        held[name] = branch_kernel(cspec, cenvs, qr, layout)[0]
        held[name]["device_ms"] = time_fkcc.graph_ms(time_fkcc.launcher(cspec, cenvs, q, layout))
        check(held[name]["mismatches_outside_bands"] == 0,
              f"fkcc agrees with plain outside the contact band at the {name} shape")
    emit({"phase": "aorrtc", "api": api, "solve_batch": batch, "simplify_pass": passes,
          "fkcc_cases": held})
    rows = []
    for name, case, launches, of in (
            ("fkcc_aox", "aox_step", api["aox_fkcc_launches"],
             "the AOX searches of one panda.aorrtc call"),
            ("fkcc_aox_batch", "aox_batch", batch["aox_fkcc_launches"],
             f"the AOX searches of solve_batch on {AORRTC_PROBLEMS} cages"),
            ("fkcc_reduce", "simplify_reduce", red.launches + per.launches,
             f"REDUCE and PERTURB of one pass over {REDUCE_PATHS} cage paths")):
        r = held[case]
        rows.append(row("fkcc", r["kernel_ms"], r["plain_ms"], r, r["max_abs_err"], launches)
                    | {"name": name, "replaces": "vamp_mvt_tpu/ops/kernels/fkcc_pallas.py:568",
                       "occupancy": r["occupancy"], "device_ms": r["device_ms"],
                       "launches_of": of,
                       "ms_of": f"one launch at {case}'s shape ({r['problems']} x "
                                f"{r['configs_per_problem']}, {r['layout']})"})
    return rows


def trace_kernel_us(log_dir) -> float:
    """Microseconds of CUDA kernels in a profiling.trace directory."""
    from vamp_mvt_tpu_torch.utils import profiling

    with open(os.path.join(log_dir, profiling.TRACE_FILE)) as fh:
        events = json.load(fh)["traceEvents"]
    return float(sum(e.get("dur", 0) for e in events
                     if e.get("ph") == "X" and e.get("cat") == "kernel"))


def mpnet_phase(dev):
    """This slice's path: plan_with_mpnet for the Panda at the published
    widths (encoder 35,934 -> 512-256-128-28, planner 42 -> 1280-...-32 -> 7,
    random weights from the seed as MPNetPlanner draws them) in the sphere
    cage, its pointcloud from pointcloud/sampling.py; MPNET_REQUESTS seeded
    start/goal pairs valid in the cage: method, ms, fkcc launches (in all
    and in the MPNet rollouts), planner forwards; every returned path
    revalidated by the plain version; the encoder's and a planner forward's
    ms against their bounds; the rollouts (MPNetPlanner.plan) of
    MPNET_CPU_CHECK requests on the card against device="cpu" at a cut
    budget (the same method and vertex count, vertices within
    MPNET_VERTEX_ATOL); one request's rollouts untraced (the step's ms),
    then the same draws under profiling.trace (the top op_breakdown rows,
    the card's busy share, both marked profiled); the fkcc kernel at
    MPNet's launch shape (1 x 440 lanes) against its plain version.
    Returns the requests' records and the kernels line's row."""
    import tempfile

    import numpy as np
    import torch

    import vamp_mvt_tpu_torch as vmt
    from vamp_mvt_tpu_torch.bench import mbm, scenes, time_fkcc
    from vamp_mvt_tpu_torch.collision import environment as envmod
    from vamp_mvt_tpu_torch.ops.kernels import fkcc_cuda
    from vamp_mvt_tpu_torch.planning import mpnet, validate
    from vamp_mvt_tpu_torch.utils import profiling

    spec = vmt.panda.spec
    env = vmt.Environment()
    for c in mbm.CAGE_CENTERS:
        env.add_sphere(vmt.Sphere(c, mbm.CAGE_RADIUS))
    envs1 = env.build(dev).map(lambda t: t[None])
    cloud = scenes.cage_cloud(MPNET_CLOUD)
    requests = scenes.cage_requests(spec, MPNET_REQUESTS, device=dev)

    def request(start, goal, device):
        fkcc_cuda.LAUNCHES = 0
        mpnet.FORWARDS = mpnet.VALIDATIONS = 0
        with LaunchTally(mpnet.MPNetPlanner, "plan") as tally:
            t0 = time.perf_counter()
            path, method = mpnet.plan_with_mpnet("panda", start, goal, env, cloud,
                                                 device=device)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        rec = {"method": method, "ms": ms, "fkcc_launches": fkcc_cuda.LAUNCHES,
               "mpnet_fkcc_launches": tally.launches, "planner_forwards": mpnet.FORWARDS,
               "motion_checks": mpnet.VALIDATIONS, "path_vertices": 0 if path is None else len(path)}
        return path, rec

    # --- the main path: MPNET_REQUESTS plan_with_mpnet calls on the card
    recs, mpnet_launches = [], 0
    for i, (start, goal) in enumerate(requests):
        path, rec = request(start, goal, dev)
        check(path is not None and len(path) >= 2, "plan_with_mpnet returned a path")
        P = torch.as_tensor(np.stack(path).astype(np.float32), device=dev)
        rec["revalidated_plain"] = bool(paths_revalidate_plain(spec, envs1, P[None], [len(path)])[0])
        rec["reaches_goal"] = bool(np.linalg.norm(path[-1] - goal) < 1e-5)
        if not rec["revalidated_plain"]:
            segs = paths_revalidate_plain(spec, envs1.map(lambda t: t.expand(len(path) - 1,
                                                                              *t.shape[1:])),
                                          torch.stack([P[:-1], P[1:]], 1), [2] * (len(path) - 1))
            rec["invalid_segments"] = torch.nonzero(~segs).flatten().tolist()
        # a "partial" answer is the best rollout, not a solution: as the JAX
        # function's, it may hold the rollouts' unchecked segments
        check(rec["revalidated_plain"] or rec["method"] == "partial",
              f"every plan_with_mpnet solution revalidates (plain): request {i}: "
              f"{json.dumps(rec)}")
        check(rec["mpnet_fkcc_launches"] == rec["motion_checks"] > 0,
              "each MPNet motion check is one fkcc launch")
        mpnet_launches += rec["mpnet_fkcc_launches"]
        recs.append(rec)

    # --- the networks alone: the encoder and one planner forward
    mp = mpnet.MPNetPlanner(spec, env.build(dev), device=dev)
    x_enc = torch.as_tensor(cloud[: mpnet.MAX_POINTCLOUD_SIZE].reshape(-1),
                            dtype=torch.float32, device=dev)
    x_plan = torch.zeros(mpnet.LATENT + 2 * spec.dimension, device=dev)
    nets = {}
    for tag, net, x in (("encoder", mp.encoder_params, x_enc),
                        ("planner", mp.planner_params, x_plan)):
        with torch.no_grad():
            n_ms = time_cuda(lambda: net(x), 3, 50)
            graph = time_fkcc.graph_ms(lambda: net(x))
        sizes = net.sizes
        params = sum(p.numel() for p in net.parameters())
        nets[tag] = {"sizes": list(sizes), "parameters": params, "ms": n_ms, "device_ms": graph,
                     **bound(2 * sum(a * b for a, b in zip(sizes[:-1], sizes[1:])),
                             4 * (params + sizes[0] + sizes[-1]))}

    # --- the rollouts on the card against device="cpu" at a cut budget:
    # MPNetPlanner.plan itself, so that the answers compared are MPNet's
    # (plan_with_mpnet would hand most of them to its RRTC fallback)
    rollers = {}
    for side in (dev, "cpu"):
        rollers[side] = mpnet.MPNetPlanner(spec, env.build(side), device=side)
        rollers[side].encode_environment(cloud)
    cmp = []
    for start, goal in requests[:MPNET_CPU_CHECK]:
        got = {}
        for side, planner in rollers.items():
            mpnet.FORWARDS = 0
            t0 = time.perf_counter()
            path = planner.plan(start, goal, max_iterations=MPNET_CPU_ITERATIONS)
            ms = (time.perf_counter() - t0) * 1e3
            reached = path is not None and float(np.linalg.norm(path[-1] - goal)) < 1e-6
            method = ("mpnet" if reached and planner.path_valid(path)
                      else "partial" if path is not None else "none")
            got[side] = (path, {"method": method, "ms": ms, "planner_forwards": mpnet.FORWARDS,
                                "path_vertices": 0 if path is None else len(path)})
        (pc, rc), (pp, rp) = got[dev], got["cpu"]
        same_len = rc["path_vertices"] == rp["path_vertices"]
        cmp.append({"card": rc, "cpu": rp, "answers_from": "MPNetPlanner.plan rollouts",
                    "same_method": rc["method"] == rp["method"], "same_length": same_len,
                    "max_vertex_diff": float(np.abs(np.stack(pc) - np.stack(pp)).max())
                    if same_len and pc is not None else None})

    # --- one request's rollouts (the networks built and the cloud encoded
    # before): untimed by the profiler, then the same draws again under it
    mp.encode_environment(cloud)
    rng_state = mp._rng.bit_generator.state
    mpnet.FORWARDS = mpnet.VALIDATIONS = 0
    t0 = time.perf_counter()
    mp.plan(*requests[0])
    torch.cuda.synchronize()
    untraced_us = (time.perf_counter() - t0) * 1e6
    untraced = {"planner_forwards": mpnet.FORWARDS, "motion_checks": mpnet.VALIDATIONS,
                "us": untraced_us, "step_ms": untraced_us / 1e3 / max(mpnet.FORWARDS, 1)}
    mp._rng.bit_generator.state = rng_state
    fkcc_cuda.LAUNCHES = 0
    mpnet.FORWARDS = mpnet.VALIDATIONS = 0
    with tempfile.TemporaryDirectory() as log_dir:
        with profiling.trace(log_dir):
            t0 = time.perf_counter()
            mp.plan(*requests[0])
            torch.cuda.synchronize()
            traced_us = (time.perf_counter() - t0) * 1e6
        top = profiling.op_breakdown(log_dir, top=10)
        kernel_us = trace_kernel_us(log_dir)
    traced = {"planner_forwards": mpnet.FORWARDS, "motion_checks": mpnet.VALIDATIONS,
              "fkcc_launches": fkcc_cuda.LAUNCHES}
    check(traced["planner_forwards"] == untraced["planner_forwards"]
          and traced["motion_checks"] == untraced["motion_checks"],
          "the traced rollouts repeat the untraced ones")
    untraced["device_busy_share"] = kernel_us / untraced_us  # the traced run's kernels

    # --- fkcc at MPNet's launch shape: one motion check, 1 x 440 lanes
    num = validate.n_points_bound(spec, float(np.linalg.norm(spec.limits_high
                                                             - spec.limits_low)))
    st = torch.as_tensor(np.stack([r[0] for r in requests]), device=dev)[:, None]
    gl = torch.as_tensor(np.stack([r[1] for r in requests]), device=dev)[:, None]
    q_d = validate.motion_configs(spec, st, gl, num).contiguous()        # (R, 7, 440)
    envs_r = envmod.broadcast_environment(env.build(dev), MPNET_REQUESTS)
    every = branch_kernel(spec, envs_r, q_d.transpose(1, 2).contiguous(), "lanes")[0]
    one = branch_kernel(spec, envs1, q_d[:1].transpose(1, 2).contiguous(), "lanes")[0]
    one["device_ms"] = time_fkcc.graph_ms(time_fkcc.launcher(spec, envs1, q_d[:1], "lanes"))
    check(every["mismatches_outside_bands"] == 0 and one["mismatches_outside_bands"] == 0,
          "fkcc agrees with plain outside the contact band at MPNet's shape")
    for c in cmp:
        check(c["same_method"] and c["same_length"]
              and (c["max_vertex_diff"] is None or c["max_vertex_diff"] <= MPNET_VERTEX_ATOL),
              f"MPNet's rollouts on the card equal the CPU's: {json.dumps(c)}")

    emit({"phase": "mpnet", "robot": "panda", "scene": "sphere cage",
          "cloud_points": int(len(cloud)), "requests": recs,
          "methods": {m: sum(r["method"] == m for r in recs)
                      for m in ("mpnet", "rrtc_fallback", "partial")},
          "networks": nets, "encoder_bound_ms": nets["encoder"]["bytes_bound_ms"],
          "card_vs_cpu": {"max_iterations": MPNET_CPU_ITERATIONS, "requests": cmp,
                          "same_method_share": float(np.mean([c["same_method"] for c in cmp])),
                          "same_length_share": float(np.mean([c["same_length"] for c in cmp]))},
          "rollouts": untraced | {"of": "MPNetPlanner.plan of the first request, untraced"},
          "traced_rollouts": traced | {"of": "the same rollouts under profiling.trace",
                                       "profiled": True, "traced_us": traced_us,
                                       "step_ms": traced_us / 1e3 / max(traced["planner_forwards"], 1),
                                       "kernel_us": kernel_us,
                                       "device_busy_share": kernel_us / traced_us},
          "op_breakdown_top10": [list(r) for r in top],
          "fkcc_motion_check": one, "fkcc_request_segments": every})
    return recs, row("fkcc", one["kernel_ms"], one["plain_ms"], one, one["max_abs_err"],
                     mpnet_launches) | {
        "name": "fkcc_mpnet", "replaces": "vamp_mvt_tpu/ops/kernels/fkcc_pallas.py:568",
        "occupancy": one["occupancy"], "device_ms": one["device_ms"],
        "launches_of": f"the MPNet motion checks of {MPNET_REQUESTS} plan_with_mpnet requests",
        "launches_per_request": mpnet_launches / MPNET_REQUESTS,
        "ms_of": f"one motion check (1 x {num}, lanes)",
        "mismatches_outside_bands": every["mismatches_outside_bands"]}


def reset_launches() -> dict:
    """The three kernels' wrappers, each count set to 0."""
    from vamp_mvt_tpu_torch.ops.kernels import fkcc_cuda, rrtc_mega_cuda, simplify_mega_cuda

    kernels = {"fkcc": fkcc_cuda, "rrtc_mega": rrtc_mega_cuda, "simplify_mega": simplify_mega_cuda}
    for lib in kernels.values():
        lib.LAUNCHES = 0
    return kernels


def evaluate_mbm_phase(dev, spec, cages, c_envs, mega_median, pc_problems, pc_envs) -> dict:
    """The main path's command line, examples/evaluate_mbm.py's port, on its
    default device (the GPU): the MEGA_PROBLEMS cages through --problems_pkl
    at --planner auto --batch_size 700 --table (valid = solved = 700, every
    simplified path revalidated by the plain version, all three kernels
    launched, the median simplified cost equal to suite_mega's on the same
    problems), then the first PC_CHECK pointcloud scenes through
    --pointcloud at its defaults (CAPT, SCDF, PC_SAMPLES samples an object)
    and --batch_size PC_CHECK (its default, 700, would pad the batch with
    636 copies): every solved path revalidated by the plain version, every
    kernel launched.  Returns each run's launches."""
    import pickle
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch

    from vamp_mvt_tpu_torch.examples import evaluate_mbm

    out, launches = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        runs = (("cages", cages, ["--planner", "auto", "--batch_size", str(MEGA_PROBLEMS),
                                  "--table"], c_envs),
                ("pointcloud", {"problems": {"mbm_shaped": pc_problems[:PC_CHECK]}},
                 ["--pointcloud", "--batch_size", str(PC_CHECK)], pc_envs))
        for tag, data, args, envs in runs:
            pkl = Path(tmp) / f"{tag}.pkl"
            pkl.write_bytes(pickle.dumps(data))
            kernels = reset_launches()
            t0 = time.perf_counter()
            got = evaluate_mbm.main(["--problems_pkl", str(pkl), *args])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches[tag] = {n: lib.LAUNCHES for n, lib in kernels.items()}
            res, summ = got["suite"], got["summary"]
            solved = np.asarray(res.plan.solved) & res.valid
            ok = paths_revalidate_plain(spec, envs, res.simplified.path,
                                        res.simplified.path_length).cpu().numpy()
            out[tag] = {"problems": summ["total_problems"], "wall_s": wall, "summary": summ,
                        "problems_per_sec_wall": summ["total_problems"] / wall,
                        "launches": launches[tag],
                        "solved_paths_revalidated_plain": int((ok & solved).sum())}
            check(all(v > 0 for v in launches[tag].values()),
                  f"evaluate_mbm ({tag}) launched every kernel")
            check(bool(ok[solved].all()), f"every solved evaluate_mbm ({tag}) path revalidates")
            check(summ["solved_problems"] > 0, f"evaluate_mbm ({tag}) solves problems")
    cage = out["cages"]["summary"]
    out["cages"]["median_simplified_cost_vs_suite_mega"] = cage["median_simplified_cost"] - mega_median
    out["pointcloud"]["settings"] = "--pointcloud defaults (capt, scdf, 10000 samples)"
    emit({"phase": "evaluate_mbm", "entry": "python -m vamp_mvt_tpu_torch.examples.evaluate_mbm",
          **out})
    check(cage["valid_problems"] == cage["solved_problems"] == MEGA_PROBLEMS,
          "evaluate_mbm solves every cage")
    check(out["cages"]["solved_paths_revalidated_plain"] == MEGA_PROBLEMS,
          "every evaluate_mbm cage path revalidates (plain)")
    check(cage["median_simplified_cost"] == mega_median,
          "evaluate_mbm's median cost equals suite_mega's on the same problems")
    return launches


def mpnet_train_phase(dev, untrained) -> dict:
    """MPNet demonstrations and training, then the MBM-file examples, all
    through a cached parse of the problems (mbm.CACHE_DIR pointed at a
    temporary directory holding <robot>_problems.pkl, so that no tarball or
    PyYAML is needed):

    mpnet_train: TRAIN_PROBLEMS sphere-cage problems whose cage spheres are
    also cubes (bench/scenes.py::cage_box_problems: a cloud samples boxes,
    never spheres), start and goal seeded configurations valid among both
    (cage_box_requests, seed TRAIN_SEED: not the mpnet phase's requests);
    examples/prepare_mpnet_dataset.py's port writes the demonstrations
    (every written path revalidated by the plain version in its cloud),
    tools/train_mpnet.py's port trains at its defaults but --batch, the
    largest multiple of 16 that gives TRAIN_STEPS steps an epoch (at least
    4 steps an epoch; pairs and steps reported): the
    loss at its first and last printed epoch, a step's ms against its bound
    (6 x parameters x batch FP32 operations; each parameter, gradient and
    Adam moment read once and the parameters, gradients and moments written
    once, and the batch's clouds read); then plan_with_mpnet with the
    trained checkpoints on the mpnet phase's MPNET_REQUESTS requests, in its
    cage and cloud: methods and ms beside the untrained ones, every solution
    revalidated by the plain version.

    mbm_examples: examples/evaluate_mbm_mpnet.py's port with those
    checkpoints on EXAMPLE_MPNET_PROBLEMS of the problems (every solution
    revalidated), examples/prepare_query_dataset.py's port on
    EXAMPLE_QUERY_PROBLEMS, its `collides` equal to the plain mvt_collides
    on the CPU on the same queries.  Returns each run's launches."""
    import pickle
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch

    import vamp_mvt_tpu_torch as vmt
    from vamp_mvt_tpu_torch.bench import mbm, scenes
    from vamp_mvt_tpu_torch.collision.mvt import mvt_collides
    from vamp_mvt_tpu_torch.examples import (evaluate_mbm_mpnet, prepare_mpnet_dataset,
                                             prepare_query_dataset)
    from vamp_mvt_tpu_torch.planning import mpnet
    from vamp_mvt_tpu_torch.pointcloud import pipeline
    from vamp_mvt_tpu_torch.tools import train_mpnet

    spec = vmt.panda.spec
    problems = scenes.cage_box_problems(
        scenes.cage_box_requests(spec, TRAIN_PROBLEMS, TRAIN_SEED, device=dev))
    data = {"robot": "panda", "joints": list(spec.joint_names), "problems": {"cage": problems}}
    launches = {}

    def cloud_envs(plist, samples=2000):
        """Each problem's cloud as the examples build it, in the kernel form
        that the card's planner reads, stacked on the card."""
        from vamp_mvt_tpu_torch.collision import environment as envmod

        return envmod.stack_environments([envmod.EnvironmentBuilder(
            pck=pipeline.problem_to_pointcloud_env("panda", p, pc_repr="mvt",
                                                   samples_per_object=samples)[0].pck
        ).build(device="cpu") for p in plist]).to(dev)

    old_cache = mbm.CACHE_DIR
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        mbm.CACHE_DIR = tmp / "cache"
        try:
            mbm.CACHE_DIR.mkdir()
            (mbm.CACHE_DIR / "panda_problems.pkl").write_bytes(pickle.dumps(data))

            # --- the demonstrations
            kernels = reset_launches()
            t0 = time.perf_counter()
            ds = prepare_mpnet_dataset.main(["--problem", "cage", "--count", str(TRAIN_PROBLEMS),
                                             "--out", str(tmp / "data")])
            torch.cuda.synchronize()
            prep_s = time.perf_counter() - t0
            launches["prepare_mpnet_dataset"] = {n: lib.LAUNCHES for n, lib in kernels.items()}
            idx = [int(Path(f).stem.split("_")[1]) for f in ds["files"]]
            demo = [np.load(f)["path"] for f in ds["files"]]
            T = max(len(p) for p in demo)
            padded = np.stack([np.concatenate([p, np.repeat(p[-1:], T - len(p), 0)]) for p in demo])
            demo_ok = paths_revalidate_plain(spec, cloud_envs([problems[i] for i in idx]),
                                             torch.as_tensor(padded, device=dev),
                                             [len(p) for p in demo]).cpu().numpy()

            # --- the training
            pairs = len(train_mpnet.load_dataset(tmp / "data")[1])
            batch = min(256, 16 * (pairs // (16 * TRAIN_STEPS)))
            check(batch >= 16, f"{pairs} waypoint pairs make {TRAIN_STEPS} batches of 16")
            kernels = reset_launches()
            tr = train_mpnet.main(["--data", str(tmp / "data"), "--out", str(tmp / "ckpt"),
                                   "--batch", str(batch), "--epochs", str(TRAIN_EPOCHS)])
            torch.cuda.synchronize()
            launches["train_mpnet"] = {n: lib.LAUNCHES for n, lib in kernels.items()}
            enc = mpnet.load_torch_state_dict(tr["encoder"])
            pla = mpnet.load_torch_state_dict(tr["planner"])
            n_params = sum(p.numel() for net in (enc, pla) for p in net.parameters())
            flops = 6 * n_params * batch
            step_bytes = 4 * (8 * n_params + batch * enc.sizes[0])
            step_bound = bound(flops, step_bytes)
            alphas = [a.weight.item() for net in (enc, pla) for a in net.prelus[:-1]]

            # --- the trained planner on the mpnet phase's requests
            env = vmt.Environment()
            for c in mbm.CAGE_CENTERS:
                env.add_sphere(vmt.Sphere(c, mbm.CAGE_RADIUS))
            envs1 = env.build(dev).map(lambda t: t[None])
            cloud = scenes.cage_cloud(MPNET_CLOUD)
            requests = scenes.cage_requests(spec, MPNET_REQUESTS, device=dev)
            kernels = reset_launches()
            trained = []
            for start, goal in requests:
                t0 = time.perf_counter()
                path, method = mpnet.plan_with_mpnet("panda", start, goal, env, cloud,
                                                     encoder_path=tr["encoder"],
                                                     planner_path=tr["planner"], device=dev)
                torch.cuda.synchronize()
                rec = {"method": method, "ms": (time.perf_counter() - t0) * 1e3,
                       "path_vertices": 0 if path is None else len(path)}
                if path is not None and len(path) >= 2:
                    P = torch.as_tensor(np.stack(path).astype(np.float32), device=dev)
                    rec["revalidated_plain"] = bool(
                        paths_revalidate_plain(spec, envs1, P[None], [len(path)])[0])
                trained.append(rec)
            launches["plan_with_mpnet_trained"] = {n: lib.LAUNCHES for n, lib in kernels.items()}
            methods = lambda recs: {m: sum(r["method"] == m for r in recs)
                                    for m in ("mpnet", "rrtc_fallback", "partial")}
            emit({"phase": "mpnet_train", "problems": TRAIN_PROBLEMS, "scene": "sphere cage, "
                  f"each sphere also a cube of half side {scenes.CAGE_BOX_HALF}",
                  "demonstrations": {"written": ds["written"], "wall_s": prep_s,
                                     "path_vertices": [len(p) for p in demo],
                                     "revalidated_plain": int(demo_ok.sum()),
                                     "launches": launches["prepare_mpnet_dataset"]},
                  "training": {k: tr[k] for k in ("clouds", "pairs", "epochs", "lr", "batch",
                                                  "steps", "losses", "step_ms", "train_s",
                                                  "device")}
                  | {"steps_per_epoch": tr["steps"] / tr["epochs"], "parameters": n_params,
                     "step_flops": flops, "step_bytes": step_bytes, **step_bound,
                     "step_bound_share": step_bound["bound_ms"] / tr["step_ms"]
                     if tr["steps"] else None,
                     "trained_alphas": {"min": min(alphas), "max": max(alphas)},
                     "launches": launches["train_mpnet"]},
                  "requests": {"trained": trained, "untrained": untrained,
                               "methods_trained": methods(trained),
                               "methods_untrained": methods(untrained),
                               "median_ms_trained": float(np.median([r["ms"] for r in trained])),
                               "median_ms_untrained": float(np.median([r["ms"] for r in untrained])),
                               "launches": launches["plan_with_mpnet_trained"]}})
            check(ds["written"] > 0 and bool(demo_ok.all()),
                  "every demonstration path revalidates in its cloud (plain)")
            check(launches["prepare_mpnet_dataset"]["fkcc"] > 0,
                  "prepare_mpnet_dataset launched the fkcc kernel")
            check(tr["steps"] >= 4 * tr["epochs"], "at least 4 optimizer steps an epoch")
            check(all(np.isfinite(v) for v in tr["losses"].values()), "finite training losses")
            check(all(abs(a - 0.25) > 0 for a in alphas), "the checkpoints carry trained alphas")
            check(all(r.get("revalidated_plain", False) or r["method"] == "partial"
                      for r in trained), "every trained plan_with_mpnet solution revalidates")
            check(launches["plan_with_mpnet_trained"]["fkcc"] > 0,
                  "the trained planner's requests launched the fkcc kernel")

            # --- mbm_examples: evaluate_mbm_mpnet and prepare_query_dataset
            kernels = reset_launches()
            t0 = time.perf_counter()
            ev = evaluate_mbm_mpnet.main(["--problem", "cage", "--max_problems",
                                          str(EXAMPLE_MPNET_PROBLEMS), "--encoder", tr["encoder"],
                                          "--planner", tr["planner"]])
            torch.cuda.synchronize()
            ev_s = time.perf_counter() - t0
            launches["evaluate_mbm_mpnet"] = {n: lib.LAUNCHES for n, lib in kernels.items()}
            ev_envs = cloud_envs(problems[:EXAMPLE_MPNET_PROBLEMS], samples=10000)
            ev_ok = []
            for i, r in enumerate(ev["rows"]):
                if r["method"] in ("mpnet", "rrtc_fallback"):
                    P = torch.as_tensor(np.stack(r["path"]).astype(np.float32), device=dev)
                    ev_ok.append(bool(paths_revalidate_plain(
                        spec, ev_envs.map(lambda t, i=i: t[i : i + 1]), P[None],
                        [len(r["path"])])[0]))
            kernels = reset_launches()
            t0 = time.perf_counter()
            qd = prepare_query_dataset.main(["--problem", "cage", "--count",
                                             str(EXAMPLE_QUERY_PROBLEMS), "--out",
                                             str(tmp / "queries")])
            torch.cuda.synchronize()
            qd_s = time.perf_counter() - t0
            launches["prepare_query_dataset"] = {n: lib.LAUNCHES for n, lib in kernels.items()}
            q_equal, q_hits = [], 0
            for i, f in enumerate(qd["files"]):
                z = np.load(f)
                b = pipeline.problem_to_pointcloud_env("panda", problems[i], pc_repr="mvt",
                                                       samples_per_object=2000,
                                                       kernel_pc=False)[0]
                plain = mvt_collides(b.build(device="cpu").mvt, torch.from_numpy(z["query_centers"]),
                                     torch.from_numpy(z["query_radii"])).numpy()
                q_equal.append(bool(np.array_equal(plain, z["collides"])))
                q_hits += int(z["collides"].sum())
            emit({"phase": "mbm_examples", "source": "a cached parse of the mpnet_train problems",
                  "evaluate_mbm_mpnet": {
                      "problems": len(ev["rows"]), "wall_s": ev_s,
                      "rows": [{k: v for k, v in r.items() if k != "path"} for r in ev["rows"]],
                      "solved": ev["solved"], "neural": ev["neural"],
                      "solutions_revalidated_plain": int(sum(ev_ok)),
                      "launches": launches["evaluate_mbm_mpnet"]},
                  "prepare_query_dataset": {
                      "problems": len(qd["files"]), "wall_s": qd_s, "queries": 64 * spec.n_spheres,
                      "collides_equal_plain_cpu": q_equal, "collisions": q_hits,
                      "launches": launches["prepare_query_dataset"]}})
            check(len(ev["rows"]) == EXAMPLE_MPNET_PROBLEMS and all(ev_ok),
                  "every evaluate_mbm_mpnet solution revalidates (plain)")
            check(launches["evaluate_mbm_mpnet"]["fkcc"] > 0,
                  "evaluate_mbm_mpnet launched the fkcc kernel")
            check(len(q_equal) == EXAMPLE_QUERY_PROBLEMS and all(q_equal) and q_hits > 0,
                  "prepare_query_dataset's collides equal the plain mvt_collides on the CPU")
        finally:
            mbm.CACHE_DIR = old_cache
    return launches


def mesh_phase(dev):
    """parallel/mesh.py on the card under a world-size-1 NCCL group
    (init_distributed): plan_batch_mega_sharded over a one-card mesh on the
    MEGA_PROBLEMS cages against plan_batch_mega (identical),
    plan_batch_sharded on MESH_LOCKSTEP cages against rrtc.plan_batch
    (identical), and aorrtc_restarts_sharded at rounds=2 from VAMP's start A
    to goal B in the cage (its all_reduce(MIN) checked against the host
    minimum inside the function); the group destroyed after."""
    import socket

    import numpy as np
    import torch
    import torch.distributed as dist

    import vamp_mvt_tpu_torch as vmt
    from vamp_mvt_tpu_torch.bench import mbm
    from vamp_mvt_tpu_torch.ops.kernels import rrtc_mega_cuda
    from vamp_mvt_tpu_torch.parallel import mesh
    from vamp_mvt_tpu_torch.planning import rrtc, rrtc_mega

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    n = mesh.init_distributed(init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    try:
        check(n == 1 and dist.get_backend() == "nccl", "a world-size-1 NCCL group")
        m = mesh.make_mesh()
        spec = vmt.panda.spec
        c_envs, c_st, c_gl, c_mk = mbm.build_batch(
            mbm.cage_suite(MEGA_PROBLEMS)["problems"]["cage"], device=dev)
        s = mbm.default_settings("panda", "mega")
        rrtc_mega_cuda.LAUNCHES = 0
        t0 = time.perf_counter()
        sh = mesh.plan_batch_mega_sharded(spec, m, c_envs, c_st, c_gl, c_mk, s)
        torch.cuda.synchronize()
        sh_ms = (time.perf_counter() - t0) * 1e3
        sh_launches = rrtc_mega_cuda.LAUNCHES
        lo = rrtc_mega.plan_batch_mega(spec, c_envs, c_st, c_gl, c_mk, s, device=dev)
        mega_same = same_plan(sh, lo)
        k = MESH_LOCKSTEP
        e64 = c_envs.map(lambda t: t[:k])
        t0 = time.perf_counter()
        lsh = mesh.plan_batch_sharded(spec, m, e64, c_st[:k], c_gl[:k], c_mk[:k], s)
        torch.cuda.synchronize()
        lsh_ms = (time.perf_counter() - t0) * 1e3
        llo = rrtc.plan_batch(spec, e64, c_st[:k], c_gl[:k], c_mk[:k], s)
        lock_same = same_plan(lsh, llo)
        env = vmt.Environment()
        for c in mbm.CAGE_CENTERS:
            env.add_sphere(vmt.Sphere(c, mbm.CAGE_RADIUS))
        t0 = time.perf_counter()
        path, length, cost, history = mesh.aorrtc_restarts_sharded(
            spec, m, env.build(dev), mbm.PANDA_START, mbm.PANDA_GOAL,
            vmt.panda.default_rrtc_settings(), rounds=2)
        torch.cuda.synchronize()
        restart_ms = (time.perf_counter() - t0) * 1e3
        ok = paths_revalidate_plain(spec, env.build(dev).map(lambda t: t[None]),
                                    torch.as_tensor(path, device=dev)[None], [length])
        emit({"phase": "mesh", "backend": dist.get_backend(), "world_size": n,
              "mesh_devices": [str(d) for d in m.devices],
              "mega": {"problems": MEGA_PROBLEMS, "identical": int(mega_same.sum()),
                       "solved": int(sh.solved.sum()), "ms": sh_ms, "rrtc_mega_launches": sh_launches},
              "lockstep": {"problems": k, "identical": int(lock_same.sum()),
                           "solved": int(lsh.solved.sum()), "ms": lsh_ms},
              "aorrtc_restarts": {"rounds": 2, "history": history, "cost": cost,
                                  "path_vertices": length, "ms": restart_ms,
                                  "revalidated_plain": bool(ok[0]),
                                  "all_reduce_min_checked": True}})
        check(bool(mega_same.all()), "the sharded mega plan equals plan_batch_mega")
        check(sh_launches > 0, "the sharded mega plan launched the planner kernel")
        check(bool(lock_same.all()), "the sharded lockstep plan equals rrtc.plan_batch")
        check(len(history) == 3 and np.isfinite(cost) and bool(ok[0]),
              "aorrtc_restarts_sharded found a path that revalidates (plain)")
        check(all(b <= a for a, b in zip(history, history[1:])),
              "the restarts' best cost never rises")
    finally:
        dist.destroy_process_group()


def examples_phase(dev):
    """Each port example's main on the card at the JAX scripts' defaults:
    solved counts, walls and the kernels each launched.  sphere_cage_example
    runs both megakernels: every path of its timed run revalidated by the
    plain version, and its first EXAMPLE_PLAIN_CHECK trials held against the
    kernels' plain versions on the same inputs (the lockstep planner at the
    example's settings and sample offset, then the lockstep simplifier on
    the plain plan's paths), at least MIN_SHARE identical."""
    import torch

    from vamp_mvt_tpu_torch.examples import (
        attachments, flying_sphere, random_dance, sphere_cage_example)
    from vamp_mvt_tpu_torch.ops.kernels import fkcc_cuda, rrtc_mega_cuda, simplify_mega_cuda
    from vamp_mvt_tpu_torch.planning import rrtc, simplify_mega
    from vamp_mvt_tpu_torch.robots import registry

    libs = {"fkcc": fkcc_cuda, "rrtc_mega": rrtc_mega_cuda, "simplify_mega": simplify_mega_cuda}
    out = {}
    for name, fn in (("sphere_cage_example", lambda: sphere_cage_example.main(100, device=dev)),
                     ("random_dance", lambda: random_dance.main(5, device=dev)),
                     ("attachments", lambda: attachments.main(device=dev)),
                     ("flying_sphere", lambda: flying_sphere.main(device=dev))):
        for lib in libs.values():
            lib.LAUNCHES = 0
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out[name] = {"wall_s": time.perf_counter() - t0, "result": res,
                     "launches": {n: lib.LAUNCHES for n, lib in libs.items()}}
    out["attachments"]["result"].pop("path")

    cage = out["sphere_cage_example"]
    res = cage["result"]
    (envs, st, gl, mk), plan, simp = (res.pop(k) for k in ("batch", "plan", "simplified"))
    spec = registry.load("panda")
    plan_ok = paths_revalidate_plain(spec, envs, plan.path, plan.path_length)
    simp_ok = paths_revalidate_plain(spec, envs, simp.path, simp.path_length)
    k = EXAMPLE_PLAIN_CHECK
    sub = envs.map(lambda t: t[:k])
    offs = torch.full((k,), sphere_cage_example.TIMED_OFFSET, dtype=torch.long, device=dev)
    t0 = time.perf_counter()
    pp = rrtc.plan_batch_compact(spec, sub, st[:k], gl[:k], mk[:k], sphere_cage_example.SETTINGS,
                                 offs, device=dev)
    torch.cuda.synchronize()
    plan_plain_s = time.perf_counter() - t0
    same = same_plan(type(plan)(*(t[:k] for t in plan)), pp)
    # the simplify kernel on the plain plan's paths against its plain version
    ks = simplify_mega.simplify_batch_mega(spec, sub, pp.path, pp.path_length,
                                           sphere_cage_example.SIMPLIFY, device=dev)
    t0 = time.perf_counter()
    ps = simplify_mega.simplify_batch_plain(spec, sub, pp.path, pp.path_length,
                                            sphere_cage_example.SIMPLIFY)
    torch.cuda.synchronize()
    simp_plain_s = time.perf_counter() - t0
    s_len = ks.path_length == ps.path_length
    s_cost = (ks.cost - ps.cost).abs() <= SIMPLIFY_RTOL * ps.cost.abs()
    solved = plan.solved
    cage["checks"] = {
        "solved_paths_revalidated_plain": {"plan": int((plan_ok & solved).sum()),
                                           "simplified": int((simp_ok & solved).sum())},
        "against_plain": {"trials": k, "rrtc_mega_identical": int(same.sum()),
                          "plain_plan_s": plan_plain_s,
                          "simplify_mega_equal_length": int(s_len.sum()),
                          "simplify_mega_cost_within_rtol": int(s_cost.sum()),
                          "plain_simplify_s": simp_plain_s}}
    emit({"phase": "examples", **out})
    check(res["solved"] == 100, "sphere_cage_example solves its 100 trials")
    check(cage["launches"]["rrtc_mega"] > 0 and cage["launches"]["simplify_mega"] > 0,
          "sphere_cage_example ran both megakernels")
    check(bool(plan_ok[solved].all()) and bool(simp_ok[solved].all()),
          "every sphere_cage_example path revalidates (plain)")
    check(float(same.float().mean()) >= MIN_SHARE,
          "sphere_cage_example's plans equal the planner's plain version")
    check(float(s_len.float().mean()) >= MIN_SHARE and float(s_cost.float().mean()) >= MIN_SHARE,
          "sphere_cage_example's simplifier equals its plain version")
    check(out["attachments"]["result"]["solved"], "attachments solves")
    check(out["flying_sphere"]["result"]["solved"], "flying_sphere solves")
    check(all(v["launches"]["fkcc"] > 0 for k, v in out.items() if k != "sphere_cage_example"),
          "the API examples launched the fkcc kernel")


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
    kernel = {
        "phase": "kernel", "problems": KERNEL_PROBLEMS, "configs_per_problem": KERNEL_CONFIGS,
        "live_rows_mean": {n: float(live[n].mean()) for n in TABLES},
        "valid_share": float((vk >= 0).float().mean()),
        "mismatches": int(mism.sum()), "mismatches_outside_band": int(outside.sum()),
        "band": CONTACT_BAND, "max_abs_err": max_abs_err,
        "kernel_ms": kernel_ms, "occupancy": kernel_occupancy, "plain_ms": plain_ms,
        **bound(ops, n_bytes), "library_ms": None,
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
          "timings": phase_times(timings), "fkcc_launches": launches,
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
        for budget in (384, 260, 32 * 260):  # the last: solved rows' goals at their starts
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
                           + 2 * rrtc_mega_cuda.WORK_COLS) * 4)
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
          "timings": phase_times(mt), "launches": mega_launches,
          "simplified_paths_revalidated": m_ok, "past_max_path": m_past,
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
          "summary": ssum, "timings": phase_times(st_), "launches": s_launches,
          "past_max_path": rrtc_mega.PAST_MAX_PATH,
          "solved_paths_revalidated": int((s_ok & solved).sum())})
    check(bool(s_ok[solved].all()), "every solved MBM-shaped path revalidates")

    # the planner megakernel against its plain version on the first
    # MBM_CHECK of these scenes (capsule and cuboid tables): at the budget,
    # then as run_suite's retry (32x the budget on the unsolved rows alone)
    # (the plain planner's 32x retry is compared in mega_interleave, in the
    # interleaved cadence; here the kernel's retry runs alone)
    b_envs, b_st, b_gl, b_mk = mbm.build_batch(problems[:MBM_CHECK], device=dev)
    mbm_check = retry_compare(spec, b_envs, b_st, b_gl, b_mk, mega_s, plain_retry=False)
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
          "build_median_ms": ptm["build_median_ms"],
          "phases": phase_times(ptm["phases"]),
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
                      + 2 * rrtc_mega_cuda.WORK_COLS) * 4)
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

    # rrtc_mega_single: the planner kernel one problem a launch, as a cloud
    # request and a lone problem's retry launch it (SINGLE_CLUSTER blocks a
    # problem): cages, the MBM-shaped scenes and the clouds, each at the
    # budget and at its runner's retry budget (run_suite's 32x,
    # run_suite_pointcloud's 16x)
    s_envs, s_st, s_gl, s_mk = mbm.build_batch(cages["problems"]["cage"][:SINGLE_CHECK],
                                               device=dev)
    single_request_phase(dev, spec, [
        ("cages", s_envs, s_st, s_gl, s_mk, mega_s, 32, SINGLE_CHECK),
        ("mbm_shaped", b_envs, b_st, b_gl, b_mk, mega_s, 32, MBM_CHECK),
        ("pointcloud", pk_envs, c_st, c_gl, c_mk, pc_settings, 16, SINGLE_CHECK)])

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

    # --- evaluate_mbm: the main path's command line (this slice) -----------
    cli = evaluate_mbm_phase(dev, spec, cages, c_envs, msum["median_simplified_cost"],
                             pc_problems, pk_envs)

    # probe_gather: the six gather probes (off the main path; their launches
    # counted through the probe entry point, `gather.gather`)
    gather_row, gather_rows = probe_gather_phase(dev)

    # --- attachments and heightfields (this slice) ------------------------
    branch_rows, api_launches, batches = branch_phases(dev, spec, q, ss)

    # --- the Mosaic probes, the other robots, the roadmap planners (this slice)
    mosaic_row, mosaic_rows = probe_mosaic_phase(dev)
    robot_rows = suite_robots_phase(dev, ss)
    prm_row, planner_calls = api_planners_phase(dev)

    # --- fkcc at the one-problem paths' launch shapes (this slice) ---------
    path_rows, path_lines = fkcc_paths_phase(dev, api_launches, planner_calls, batches)
    prm_row["sample_wave_ms"] = path_lines["prm_samples"]["kernel_ms"]

    # --- AORRTC, REDUCE and PERTURB --------------------------------------
    aorrtc_rows = aorrtc_phase(dev)

    # --- MPNet, sharding and the examples (this slice) ----------------------
    mpnet_recs, mpnet_row = mpnet_phase(dev)
    mesh_phase(dev)
    examples_phase(dev)

    # --- MPNet demonstrations and training, the MBM-file examples (this slice)
    train = mpnet_train_phase(dev, mpnet_recs)
    mpnet_row["launches_trained_requests"] = train["plan_with_mpnet_trained"]["fkcc"]
    cli_launches = lambda kernel, tag: {
        f"evaluate_mbm{' --pointcloud' if tag == 'pointcloud' else ''}": cli[tag][kernel],
        **({k: v[kernel] for k, v in train.items()} if tag == "cages" else {})}

    # --- bench: the port's bench entry on its default source ----------------
    bench_phase()

    emit({"kernels": [
        row("fkcc", kernel_ms, plain_ms, kernel, max_abs_err, mega_launches["fkcc"])
        | {"replaces": "vamp_mvt_tpu/ops/kernels/fkcc_pallas.py:568",
           "occupancy": kernel_occupancy, "ms_of": "700 x 1024 MBM-shaped configurations",
           "launches_of": "suite_mega (its shapes: fkcc_bench_path)",
           "replaces_function": "vamp_mvt_tpu/ops/kernels/fkcc_pallas.py::_run",
           "launches_xla_suite": launches, "launches_entry_points": cli_launches("fkcc", "cages")},
        bench_fkcc_row,
        row("rrtc_mega", rrtc_ms, rrtc_plain_ms, r_bound, rrtc_err, mega_launches["rrtc_mega"])
        | {"replaces": "vamp_mvt_tpu/planning/rrtc_mega.py:943",
           "replaces_function": "vamp_mvt_tpu/planning/rrtc_mega.py::_run_mega",
           "warps_per_sm": r_launch["occupancy"]["warps_per_sm"],
           "phase_share": r_launch["phase_share"],
           "launches_entry_points": cli_launches("rrtc_mega", "cages")},
        inter_row,
        row("simplify_mega", simp_ms, simp_plain_ms, s_bound, simp_err,
            mega_launches["simplify_mega"])
        | {"replaces": "vamp_mvt_tpu/planning/simplify_mega.py:377",
           "replaces_function": "vamp_mvt_tpu/planning/simplify_mega.py::_run",
           "warps_per_sm": s_launch["occupancy"]["warps_per_sm"],
           "phase_share": s_launch["phase_share"],
           "launches_entry_points": cli_launches("simplify_mega", "cages")},
        # the pointcloud branch in each kernel, on this slice's path
        row("fkcc", pk_ms, pp_ms, pk_bound, p_err, pc_launches["fkcc"])
        | {"name": "fkcc_pc", "replaces": "vamp_mvt_tpu/ops/kernels/fkcc_pallas.py:568",
           "occupancy": pk_occupancy,
           "replaces_function": "vamp_mvt_tpu/ops/kernels/fkcc_pallas.py::tile_vmin "
                                "pointcloud branch (248-457)",
           "max_abs_err_of": "validity outside the contact band",
           "launches_entry_points": cli_launches("fkcc", "pointcloud")},
        row("rrtc_mega", rpc_ms, rpc_plain_ms, rpc_bound, rpc_err, pc_launches["rrtc_mega"])
        | {"name": "rrtc_mega_pc", "replaces": "vamp_mvt_tpu/planning/rrtc_mega.py:943",
           "replaces_function": "vamp_mvt_tpu/planning/rrtc_mega.py::_run_mega on pck",
           "warps_per_sm": rp_launch["occupancy"]["warps_per_sm"],
           "phase_share": rp_launch["phase_share"],
           "launches_entry_points": cli_launches("rrtc_mega", "pointcloud")},
        row("simplify_mega", spc_ms, spc_plain_ms, spc_bound, spc_err,
            pc_launches["simplify_mega"])
        | {"name": "simplify_mega_pc", "replaces": "vamp_mvt_tpu/planning/simplify_mega.py:377",
           "replaces_function": "vamp_mvt_tpu/planning/simplify_mega.py::_run on pck",
           "warps_per_sm": sp_launch["occupancy"]["warps_per_sm"],
           "phase_share": sp_launch["phase_share"],
           "launches_entry_points": cli_launches("simplify_mega", "pointcloud")},
        *path_rows,
        *branch_rows,
        gather_row,
        *gather_rows,
        mosaic_row,
        *mosaic_rows,
        *robot_rows,
        prm_row,
        *aorrtc_rows,
        mpnet_row,
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
