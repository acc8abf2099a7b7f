"""Raked motion validation, batched over problems.

Port of `vamp_mvt_tpu/planning/validate.py`.  A segment is checked at the
fractions k/N for k = 1..N (start excluded, endpoint included), with
N = 8 * max(ceil(dist * resolution / 8), 1) — the reference's grid
(planning/validate.hh:23-77).  Fractions past N clamp to the endpoint.

Where the JAX functions are single-problem and vmapped, these take an
explicit leading problem dimension B: environments (B, n, f) (or (1, n, f)
shared), segments (B, E, d).
"""

from __future__ import annotations

import math

import torch

from vamp_mvt_tpu_torch.collision.environment import Environment
from vamp_mvt_tpu_torch.ops.kernels import fkcc_cuda
from vamp_mvt_tpu_torch.robots.spec import RobotSpec

RAKE = 8  # the reference's SIMD width; defines the N = 8*ceil(d*res/8) grid


def n_points_bound(spec: RobotSpec, max_dist: float) -> int:
    """Static upper bound on N for segments of length <= max_dist."""
    return RAKE * max(int(math.ceil(max_dist * spec.resolution / RAKE)) + 1, 1)


def sum_last(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, left to right (a fixed rounding order)."""
    out = x[..., 0]
    for i in range(1, x.shape[-1]):
        out = out + x[..., i]
    return out


def norm_last(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(sum_last(v * v))


def fkcc_valid(spec: RobotSpec, envs: Environment, q: torch.Tensor) -> torch.Tensor:
    """q (B, ..., d) -> (B, ...) bool validity: the fkcc kernel on CUDA
    tensors and the plain version on CPU tensors, except for tables no kernel
    reads (an MVT or CAPT pointcloud without its kernel form,
    `fkcc_cuda.supports`): those take the plain version on q's own device,
    where the JAX package takes its XLA path (vamp_mvt_tpu/ops/fkcc.py)."""
    if q.is_cuda and not fkcc_cuda.supports(envs):
        B = q.shape[0]
        qf = q.reshape(B, -1, spec.dimension)
        return fkcc_cuda.fkcc_batched_plain(spec, envs, qf).reshape(q.shape[:-1])
    return fkcc_cuda.fkcc_batched(spec, envs, q)


def _fkcc_valid_lanes(spec: RobotSpec, envs: Environment, q_d: torch.Tensor) -> torch.Tensor:
    """fkcc_valid in the lanes layout: q_d (B, d, N) -> (B, N) bool."""
    if q_d.is_cuda and not fkcc_cuda.supports(envs):
        return fkcc_cuda.fkcc_batched_plain(spec, envs, q_d.transpose(1, 2))
    return fkcc_cuda.fkcc_batched_lanes(spec, envs, q_d)


def interpolation_fractions(spec: RobotSpec, dist: torch.Tensor, num: int) -> torch.Tensor:
    """(..., num) fractions k/N (k = 1..num), clamped to 1 past the endpoint."""
    n = torch.clamp_min(torch.ceil(dist * (spec.resolution / RAKE)), 1.0)
    N = RAKE * n
    k = torch.arange(1, num + 1, dtype=torch.float32, device=dist.device)
    return torch.clamp_max(k / N[..., None], 1.0)


def validate_vector(
    spec: RobotSpec,
    envs: Environment,
    start: torch.Tensor,    # (B, d)
    vector: torch.Tensor,   # (B, d)
    dist: torch.Tensor,     # (B,)
    num: int,
) -> torch.Tensor:
    """Validate start + t * vector for t in (0, 1], one segment a problem ->
    (B,) bool, True = collision-free.  `num` evaluated points must cover
    the segment's N (`n_points_bound` on the longest segment); mirrors
    validate_vector (reference planning/validate.hh:23-67)."""
    frac = interpolation_fractions(spec, dist, num)                     # (B, num)
    q = start[:, None, :] + vector[:, None, :] * frac[..., None]        # (B, num, d)
    return torch.all(fkcc_valid(spec, envs, q), dim=-1)


def motion_configs(spec: RobotSpec, starts: torch.Tensor, goals: torch.Tensor,
                   num: int) -> torch.Tensor:
    """The (B, d, E * num) configurations `validate_motion_batch` checks for
    segments (B, E, d), dimension-major (the kernel's lanes layout)."""
    B, E, d = starts.shape
    vectors = goals - starts
    frac = interpolation_fractions(spec, norm_last(vectors), num)       # (B, E, num)
    return (
        starts.transpose(1, 2)[..., None] + vectors.transpose(1, 2)[..., None] * frac[:, None]
    ).reshape(B, d, E * num)


def validate_motion_batch(
    spec: RobotSpec,
    envs: Environment,
    starts: torch.Tensor,   # (B, E, d)
    goals: torch.Tensor,    # (B, E, d)
    num: int,
    chunk: int | None = None,
) -> torch.Tensor:
    """Validate B x E straight segments at `num` points each -> (B, E) bool.

    One fused FK+CC evaluation over B x E x num configurations, or with
    `chunk`, one over each `chunk` segments of every problem in turn (the
    last chunk takes the remainder), which bounds the (B, chunk * num, S, 3)
    intermediate: on the GPU one fkcc launch a chunk."""
    B, E, _ = starts.shape
    if chunk is not None and chunk < E:
        return torch.cat([validate_motion_batch(spec, envs, starts[:, i : i + chunk],
                                                goals[:, i : i + chunk], num)
                          for i in range(0, E, chunk)], dim=1)
    block_d = motion_configs(spec, starts, goals, num)
    ok = _fkcc_valid_lanes(spec, envs, block_d).reshape(B, E, num)
    return torch.all(ok, dim=-1)


def validate_motion(
    spec: RobotSpec,
    envs: Environment,
    start: torch.Tensor,    # (B, d)
    goal: torch.Tensor,     # (B, d)
    num: int,
) -> torch.Tensor:
    """Validate one segment per problem -> (B,) bool."""
    return validate_motion_batch(spec, envs, start[:, None], goal[:, None], num)[:, 0]


def validate_motion_jobs(
    spec: RobotSpec,
    envs: Environment,
    starts: torch.Tensor,   # (B, E, d)
    goals: torch.Tensor,    # (B, E, d)
    live: torch.Tensor,     # (B, E) bool — dead segments produce no jobs
    t_cap: int,
) -> torch.Tensor:
    """Validate segments with per-segment EXACT point counts, compacted.

    Each live segment e contributes N_e interpolation points, laid out
    back-to-back in one list of `t_cap` jobs per problem; one fused FK+CC
    evaluation covers all jobs and each segment's validity is an AND over
    its run (a prefix-sum difference).  Segments whose jobs overflow t_cap
    return False (conservative: never reported valid); dead segments return
    False as well.
    """
    B, E, d = starts.shape
    dev = starts.device
    vectors = goals - starts
    n = torch.clamp_min(torch.ceil(norm_last(vectors) * (spec.resolution / RAKE)), 1.0)
    N = torch.where(live, (RAKE * n).to(torch.int32), 0)                 # (B, E)
    cum = torch.cumsum(N, dim=1, dtype=torch.int32)
    offsets = cum - N
    fits = cum <= t_cap

    # e_c[j] = index of job j's segment: marks at every segment end, summed;
    # an end at t_cap falls in the extra column, which is dropped
    marks = torch.zeros((B, t_cap + 1), dtype=torch.int32, device=dev)
    marks.scatter_add_(1, torch.clamp_max(cum, t_cap).long(), torch.ones_like(cum))
    e_c = torch.clamp_max(torch.cumsum(marks[:, :t_cap], dim=1, dtype=torch.int32), E - 1)
    j = torch.arange(t_cap, dtype=torch.int32, device=dev)
    valid_job = j[None] < torch.clamp_max(cum[:, -1:], t_cap)            # (B, t_cap)

    e_l = e_c.long()
    g_start = torch.gather(starts, 1, e_l[..., None].expand(B, t_cap, d))
    g_vec = torch.gather(vectors, 1, e_l[..., None].expand(B, t_cap, d))
    g_off = torch.gather(offsets.to(torch.float32), 1, e_l)
    g_n = torch.gather(N.to(torch.float32), 1, e_l)
    k = j.to(torch.float32)[None] - g_off
    frac = torch.where(valid_job, (k + 1.0) / torch.clamp_min(g_n, 1.0), 0.0)
    block_d = (g_start + g_vec * frac[..., None]).transpose(1, 2)         # (B, d, t_cap)
    ok_jobs = _fkcc_valid_lanes(spec, envs, block_d)

    bad = torch.where(valid_job, 1 - ok_jobs.to(torch.int32), 0)
    pref = torch.cat(
        [torch.zeros((B, 1), dtype=torch.int32, device=dev),
         torch.cumsum(bad, dim=1, dtype=torch.int32)], dim=1,
    )
    lo = torch.clamp_max(offsets, t_cap).long()
    hi = torch.clamp_max(cum, t_cap).long()
    return (torch.gather(pref, 1, hi) - torch.gather(pref, 1, lo) == 0) & fits & live
