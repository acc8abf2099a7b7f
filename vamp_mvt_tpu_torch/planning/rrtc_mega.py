"""RRT-Connect with the planner megakernel: host side.

Port of `vamp_mvt_tpu/planning/rrtc_mega.py`.  The kernel
(`csrc/rrtc_mega.cu`, bound in `ops/kernels/rrtc_mega_cuda.py`) runs one
whole solve per block, or per cluster of blocks where the batch leaves SMs
free, and stops the moment its problem is done, so finished problems cost
nothing.  This module builds its inputs (the direct-goal
check, the control word and the initial node rows, `mega_inputs`) and turns
its outputs into an `RRTCResult` (`_finalize_mega`).

On CUDA tensors `plan_batch_mega` launches the kernel; on CPU tensors it runs
the plain version, the lockstep planner `planning/rrtc.py` in the cadence
`settings.interleave` names, which the kernel matches step for step.  The
sample budget is a runtime value of the control word, so the 32x-budget
retry of `run_suite` reuses the same kernel on the unsolved rows.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from vamp_mvt_tpu_torch.collision.environment import Environment
from vamp_mvt_tpu_torch.device import resolve_device
from vamp_mvt_tpu_torch.ops.kernels import rrtc_mega_cuda
from vamp_mvt_tpu_torch.planning import rrtc
from vamp_mvt_tpu_torch.planning import validate as validate_mod
from vamp_mvt_tpu_torch.planning.rrtc import RRTCResult, RRTCSettings
from vamp_mvt_tpu_torch.planning.validate import sum_last
from vamp_mvt_tpu_torch.robots.spec import RobotSpec
from vamp_mvt_tpu_torch.utils import profiling

# Radius of a node never updated (a finite stand-in for infinity).
_BIG = 1e30

# Problems the kernel solved whose two chains together pass max_path, since a
# caller last set it to 0.  Their path cannot be exported, so the result
# counts them as unsolved (rrtc.result_from_chains), where the JAX package
# reports them solved with a path cut short of the goal.
PAST_MAX_PATH = 0


def _kernel_config(spec: RobotSpec, s: RRTCSettings, G: int) -> dict:
    """The planner kernel's figures for these settings, refusing what
    csrc/rrtc_mega.cu cannot run: K * W <= 128 samples a step (kMaxLanes),
    K + C <= 64 edges (kMaxEdges) and d <= 16 (kMaxDim).  Whether a block's
    shared memory fits is the launch shape's own check
    (rrtc_mega_cuda.launch_shape raises when no shape fits)."""
    d = spec.dimension
    K, C, W = s.samples_per_step, s.connect_segments, s.sample_window
    KW = K * W
    if KW > rrtc_mega_cuda.MAX_LANES:
        raise ValueError("samples_per_step * sample_window must be <= 128")
    E = K + C
    if E > rrtc_mega_cuda.MAX_EDGES:
        raise ValueError("K + C must be <= 64")
    if d > rrtc_mega_cuda.MAX_DIM:
        raise ValueError(f"dimension {d} above {rrtc_mega_cuda.MAX_DIM}")
    return dict(d=d, K=K, C=C, W=W, KW=KW, E=E,
                N=validate_mod.n_points_bound(spec, s.range), M=s.max_samples, G=G)


def _check_settings(s: RRTCSettings) -> None:
    """Raise for settings the megakernel does not run."""
    rrtc._check_settings(s)
    if s.sampler != "halton":
        # the JAX megakernel has no sampler branch: it would plan with Halton
        raise NotImplementedError(f"the planner kernel samples Halton only, not {s.sampler!r}")
    if s.profile_mask != -1:
        raise NotImplementedError("profile_mask is a profiling-only switch, not ported")
    if s.pc_phase != 2:
        raise NotImplementedError("pc_phase is a profiling-only switch, not ported")


def mega_inputs(spec, envs, starts, goals, goal_masks, settings,
                sample_offsets=None, budget=None):
    """Control word and initial node rows of the kernel.

    Returns (ctl (B, 8) int32: sample offset, any direct goal, goal count,
    sample budget; nodes0 (B, 1 + G, d + 4) float32: configuration, in-start
    flag, dynamic-domain radius, parent index, squared norm; any_direct (B,);
    first_direct (B,))."""
    B, d = starts.shape
    G = goals.shape[1]
    dev = starts.device
    if sample_offsets is None:
        sample_offsets = torch.zeros(B, dtype=torch.int32, device=dev)

    # --- straight-line direct-goal check (rrtc.hh:60-73)
    span = float(np.linalg.norm(spec.limits_high - spec.limits_low))
    direct = validate_mod.validate_motion_batch(
        spec, envs, starts[:, None].expand(B, G, d), goals,
        validate_mod.n_points_bound(spec, span),
    ) & goal_masks
    any_direct = direct.any(1)
    first_direct = torch.argmax(direct.to(torch.int32), dim=1)

    # --- node 0 = start, nodes 1..G = goals (masked goals parked far away);
    # roots are their own parents
    far = torch.where(goal_masks[..., None], 0.0, 1e8)
    cfg = torch.cat([starts[:, None], (goals + far).to(torch.float32)], 1)   # (B, 1+G, d)
    ones = torch.ones((B, 1 + G, 1), dtype=torch.float32, device=dev)
    in_start = (torch.arange(1 + G, device=dev) == 0).to(torch.float32)
    parent = torch.arange(1 + G, dtype=torch.float32, device=dev)
    nodes0 = torch.cat([
        cfg, ones * in_start[:, None], ones * _BIG, ones * parent[:, None],
        sum_last(cfg * cfg)[..., None],
    ], 2).contiguous()

    if budget is None:
        budget = settings.max_iterations
    ctl = torch.zeros((B, 8), dtype=torch.int32, device=dev)
    ctl[:, 0] = sample_offsets.to(torch.int32)
    ctl[:, 1] = any_direct.to(torch.int32)
    ctl[:, 2] = goal_masks.to(torch.int32).sum(1)
    ctl[:, 3] = int(budget)
    return ctl, nodes0, any_direct, first_direct


def _finalize_mega(paths, scal, starts, goals, any_direct, first_direct) -> RRTCResult:
    """Orientation, padding, cost and direct overrides of the exported chain
    rows (the kernel writes them where rrtc._recover_path scatters them);
    adds the solved problems past the path buffer to PAST_MAX_PATH."""
    global PAST_MAX_PATH
    scal = scal.long()
    total = scal[:, 11] + scal[:, 12]
    PAST_MAX_PATH += int(((scal[:, 0] > 0) & (total > paths.shape[1]) & ~any_direct).sum())
    return rrtc.result_from_chains(
        paths, total, scal[:, 3] > 0, scal[:, 0] > 0, scal[:, 4],
        scal[:, 7], scal[:, 8], scal[:, 5], starts, goals, any_direct, first_direct,
    )


def plan_batch_mega(
    spec: RobotSpec,
    envs: Environment,
    starts: torch.Tensor,            # (B, d)
    goals: torch.Tensor,             # (B, G, d)
    goal_masks: torch.Tensor,        # (B, G) bool
    settings: RRTCSettings,
    sample_offsets: torch.Tensor | None = None,
    budget: int | None = None,
    device=None,
    shape=None,
    iter_count: str | None = None,
    block_count: str | None = None,
) -> RRTCResult:
    """Solve a batch with the planner megakernel, on `device` (default: the
    GPU).  `budget` replaces settings.max_iterations (the sample budget);
    `shape` overrides the kernel's launch shape and (T, G, k) its cluster
    size (rrtc_mega_cuda.plan).
    Under a runner's recorder that counts, the launch's block times and
    phase clocks are counted (`_count_blocks`), with `iter_count` its
    slowest block's us an iteration under that name (`slowest_iter_us`),
    and with `block_count` its blocks (problems x cluster size) under that
    name."""
    _check_settings(settings)
    _kernel_config(spec, settings, goals.shape[1])
    dev = resolve_device(device)
    envs = envs.to(dev)
    starts, goals, goal_masks = starts.to(dev), goals.to(dev), goal_masks.to(dev)
    if sample_offsets is not None:
        sample_offsets = sample_offsets.to(dev)
    if budget is None:
        budget = settings.max_iterations
    if dev.type != "cuda":
        return rrtc.plan_batch_compact(
            spec, envs, starts, goals, goal_masks,
            dataclasses.replace(settings, max_iterations=int(budget)),
            sample_offsets, device=dev, interleave=settings.interleave,
        )
    ctl, nodes0, any_direct, first_direct = mega_inputs(
        spec, envs, starts, goals, goal_masks, settings, sample_offsets, budget
    )
    paths, scal, work = rrtc_mega_cuda.plan(spec, envs, ctl, nodes0, settings, shape)
    if profiling.counting() and work.shape[0]:
        _count_blocks(work)
        if iter_count is not None:
            profiling.count(iter_count, slowest_iter_us(work, scal[:, 4]))
        if block_count is not None:
            profiling.count(block_count, work.shape[0] * rrtc_mega_cuda.LAST_LAUNCH["cluster"])
    return _finalize_mega(paths, scal, starts, goals, any_direct, first_direct)


@functools.cache
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _count_blocks(work) -> None:
    """One launch's counts for the active recorder (utils/profiling.py),
    from its problems' %globaltimer columns, summed on the card:
    planner_block_ns, the blocks' time (exit - entry of every block of every
    problem's cluster, summed), and planner_slot_ns, the launch's span (last
    exit - first entry) times the blocks the card holds at once (SMs x
    blocks an SM), so that their ratio is how full the card was; and from
    rank 0's phase clocks (`rrtc_mega_cuda.PHASES`, clock64 cycles) summed
    over the problems: planner_cyc, every phase, planner_fkcc_cyc, the FK +
    collision pass, and planner_nn_cyc, the two nearest-neighbour scans."""
    ph = rrtc_mega_cuda.PHASES
    t = rrtc_mega_cuda.WORK + len(ph)
    enter, leave = work[:, t], work[:, t + 1]
    profiling.count("planner_block_ns", work[:, t + 2].sum())
    slots = _sm_count(work.device) * rrtc_mega_cuda.LAST_LAUNCH["blocks_per_sm"]
    profiling.count("planner_slot_ns", (leave.max() - enter.min()) * slots)
    cyc = work[:, rrtc_mega_cuda.WORK:t].sum(0)
    profiling.count("planner_cyc", cyc.sum())
    profiling.count("planner_fkcc_cyc", cyc[ph.index("fkcc")])
    profiling.count("planner_nn_cyc", cyc[ph.index("nn_a")] + cyc[ph.index("nn_b")])


def slowest_iter_us(work: torch.Tensor, iterations: torch.Tensor) -> torch.Tensor:
    """A launch's slowest problem's microseconds an iteration, from its
    `work` (its cluster's first entry to last exit) and its rows' iterations
    (`scal[:, 4]`); a 0-dim float64 tensor on the card, no sync."""
    t = rrtc_mega_cuda.WORK + len(rrtc_mega_cuda.PHASES)
    dur = work[:, t + 1] - work[:, t]
    slow = dur.argmax().view(1)
    iters = iterations.long().gather(0, slow).clamp(min=1)
    return (dur.gather(0, slow).double() / iters / 1e3).sum()
