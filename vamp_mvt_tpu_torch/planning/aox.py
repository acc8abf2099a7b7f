"""AOX_RRTC: RRT-Connect in the cost-augmented space, lockstep over a batch
(reference src/impl/vamp/planning/aorrtc.hh:20-342).

Port of `vamp_mvt_tpu/planning/aox.py`, the counterpart of
`jax.vmap(aox.solve)`.  Every node carries its cost-to-root; a sampled upper
cost bound c_rand in [g-hat, max_cost - h-hat] restricts which nodes may be
connection parents, nearest neighbours are taken in the augmented metric
sqrt(d^2 + (c_rand - cost)^2) over an eligibility mask of the whole node
buffer, and a connection to the other tree must improve on the incumbent
cost.  After each extension, `cost_bound_resamples` rounds look for a
cheaper parent (aorrtc.hh:197-237), each with one validation.

As in the lockstep planner (`planning/rrtc.py`), each step runs on the whole
batch and is kept only where a problem's own loop condition holds; node
buffers have M + 1 rows, row M a trash row for the JAX package's dropped
scatters; the host checks for live problems once every `rrtc._SYNC_EVERY`
steps and never inside a step, and draws the samples and uniforms of the
next `_SYNC_EVERY` sample indices at each check.  On the card the window of
steps between two checks is captured once as a CUDA graph and replayed
(`fkcc_cuda.capture` / `replay`, which count its fkcc launches).  Every segment check of a step (the grow or
connect segment, then each resample round's) is one `validate.fkcc_valid`
launch of B x num_points configurations; on the CPU the resample rounds stop
once no problem is resampling (the card launches every round, as a check
would cost a sync; the results are the same).  Distances are
sqrt(sum((configs - q)^2)) summed in index order.  The scalar uniforms come
from `sampling/threefry.py`, `jax.random`'s streams bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vamp_mvt_tpu_torch.collision.environment import Environment
from vamp_mvt_tpu_torch.device import resolve_device
from vamp_mvt_tpu_torch.ops.kernels import fkcc_cuda
from vamp_mvt_tpu_torch.planning import rrtc as rrtc_mod
from vamp_mvt_tpu_torch.planning import validate as validate_mod
from vamp_mvt_tpu_torch.planning.phs import PHS, phs_samples
from vamp_mvt_tpu_torch.planning.rrtc import (
    RRTCResult, RRTCSettings, _gather_rows, _recover_path, _scatter_rows, _select, _State,
)
from vamp_mvt_tpu_torch.planning.validate import sum_last
from vamp_mvt_tpu_torch.robots.spec import RobotSpec
from vamp_mvt_tpu_torch.sampling import threefry
from vamp_mvt_tpu_torch.sampling.halton import halton

_INF = float("inf")
# f32-safe bound: the augmented metric squares (c_rand - costs), so a 1e30
# "unbounded" sentinel overflows to inf and collapses every masked argmin to
# index 0 (the start), joining loop paths back into the start tree
MAX_COST_CLAMP = 1e8
_WINDOW = rrtc_mod._SYNC_EVERY  # steps between host checks, and draws drawn at once
HOST_SYNCS = 0  # host checks for live problems, counted over every search


class _Draws(NamedTuple):
    first: torch.Tensor      # (B,) sample index of column 0
    samples: torch.Tensor    # (B, W, d) the samples of indices first .. first + W - 1
    uniforms: torch.Tensor   # (1 + resamples, B, W) uniform(idx, salt)


# The lockstep planner's state (rrtc._State's fields) plus each node's
# cost-to-root, costs (B, M+1), and each problem's incumbent bound, max_cost (B,)
_AOXState = NamedTuple("_AOXState", [(f, torch.Tensor) for f in _State._fields]
                       + [("costs", torch.Tensor), ("max_cost", torch.Tensor)])


def _row(buf: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """buf (B, M, ...) at one index a problem (B,) -> (B, ...)."""
    return _gather_rows(buf, idx[:, None])[:, 0]


def _dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(sum_last((a - b) ** 2))


def _aug_nearest(d, costs, mask, c_rand):
    """Eligibility-masked augmented-metric nearest (aorrtc.hh:61-85): the
    closest (augmented) node with costs + d <= c_rand; a tree root (cost 0)
    is always eligible.  d, costs and mask (B, M): the nodes' distances to
    the query, c_rand (B,).  Returns (idx, d[idx], any_eligible): with
    nothing eligible the argmin of all-inf is index 0, a node of the wrong
    tree for connect targets, so callers gate on the flag."""
    aug = torch.sqrt(d * d + (c_rand[:, None] - costs) ** 2)
    eligible = mask & ((costs + d <= c_rand[:, None]) | (costs <= 0.0))
    aug = torch.where(eligible, aug, _INF)
    idx = torch.argmin(aug, dim=1)
    return idx, torch.gather(d, 1, idx[:, None])[:, 0], eligible.any(1)


def _make_step(spec: RobotSpec, s: RRTCSettings, envs: Environment, num_points: int,
               resamples: int, phs: PHS | None):
    M = s.max_samples
    d = spec.dimension
    dev = envs.device
    arange_m = torch.arange(M, device=dev)
    lows = torch.as_tensor(spec.limits_low, device=dev)
    highs = torch.as_tensor(spec.limits_high, device=dev)
    spans = highs - lows
    dyn = s.dynamic_domain
    kk = torch.arange(1, num_points + 1, dtype=torch.float32, device=dev)
    res_per_rake = spec.resolution / validate_mod.RAKE
    # the scalar uniforms: uniform(idx, salt) = uniform(fold_in(PRNGKey(29 +
    # salt), idx)) for the c_rand draw (salt 0) and each resample round, then
    # the PHS radius, fold_in(PRNGKey(23), idx)
    seeds = [29 + salt for salt in range(1 + resamples)] + ([23] if phs is not None else [])
    keys = torch.stack([threefry.prng_key(k, dev) for k in seeds])[:, None, None]  # (R,1,1,2)
    offsets = torch.arange(_WINDOW, device=dev)

    def window(first: torch.Tensor) -> _Draws:
        """The samples and uniforms of sample indices first .. first +
        _WINDOW - 1 (B,): every draw is a function of its index alone, so a
        window drawn once serves _WINDOW steps (each consumes at most one
        index)."""
        idx = first[:, None] + offsets                                   # (B, W)
        u = threefry.uniform(threefry.fold_in(keys, idx[None]), 1)[..., 0]  # (R, B, W)
        unit = halton(idx, d)
        if phs is None:
            samples = unit * spans + lows
        else:
            samples = torch.clamp(phs_samples(phs, unit, u[-1]), lows, highs)
        return _Draws(first, samples, u[: 1 + resamples])

    def validate_seg(start, vec, dist):
        """One launch: (B,) validity of each problem's segment."""
        n = torch.clamp_min(torch.ceil(dist * res_per_rake), 1.0)
        frac = torch.clamp_max(kk / (validate_mod.RAKE * n)[:, None], 1.0)
        block = start[:, None] + vec[:, None] * frac[..., None]
        return validate_mod.fkcc_valid(spec, envs, block).all(dim=-1)

    def step(ax: _AOXState, draws: _Draws) -> _AOXState:
        grow = ~ax.connect
        configs, costs = ax.configs[:, :M], ax.costs[:, :M]

        # --- balancing
        asize = torch.where(ax.a_is_start, ax.size_start, ax.size_goal).to(torch.float32)
        bsize = torch.where(ax.a_is_start, ax.size_goal, ax.size_start).to(torch.float32)
        ratio = torch.abs(asize - bsize) / asize
        do_swap = grow & ((not s.balance) | (ratio < s.tree_ratio))
        a_is_start = torch.where(do_swap, ~ax.a_is_start, ax.a_is_start)

        j = (ax.sample_idx - draws.first)[:, None]                       # (B, 1)
        sample = _gather_rows(draws.samples, j)[:, 0]
        u = torch.gather(draws.uniforms, 2, j[None].expand(len(draws.uniforms), -1, -1))[..., 0]

        node_mask = arange_m[None] < ax.n_nodes[:, None]
        in_a = ax.in_start[:, :M] == a_is_start[:, None]
        mask_a = node_mask & in_a
        mask_b = node_mask & ~in_a

        # nearest goal vert to the sample (aorrtc.hh:147-152): goal verts
        # are the goal tree's roots, cost 0
        goal_mask = node_mask & ~ax.in_start[:, :M] & (costs <= 0.0)
        d_sample = _dist(configs, sample[:, None])                       # (B, M)
        d_goals = torch.where(goal_mask, d_sample, _INF)
        goal_vert = torch.argmin(d_goals, dim=1)
        root_idx = torch.where(a_is_start, 0, goal_vert)
        target_idx = torch.where(a_is_start, goal_vert, 0)

        root_cfg = _row(configs, root_idx)
        g_hat = _dist(root_cfg, sample)
        h_hat = _dist(_row(configs, target_idx), sample)
        c_range = torch.clamp_min(ax.max_cost - (g_hat + h_hat), 0.0)
        c_rand = u[0] * c_range + g_hat

        nearest, nearest_dist, _ = _aug_nearest(d_sample, costs, mask_a, c_rand)
        nearest_cfg = _row(configs, nearest)
        nearest_radius = _row(ax.radii, nearest)
        dd_skip = (nearest_radius < nearest_dist) & dyn

        reach = nearest_dist < s.range
        scale = torch.where(reach, 1.0, s.range / torch.clamp_min(nearest_dist, 1e-12))
        ext_vec = (sample - nearest_cfg) * scale[:, None]
        ext_dist = torch.clamp_max(nearest_dist, s.range)
        new_cfg = nearest_cfg + ext_vec

        # one validation serves grow OR connect mode
        c_tip_cfg = _row(ax.configs, ax.c_tip)
        v_start = torch.where(grow[:, None], nearest_cfg, c_tip_cfg)
        v_vec = torch.where(grow[:, None], ext_vec, ax.c_inc)
        v_dist = torch.where(grow, ext_dist, ax.c_inc_len)
        valid = validate_seg(v_start, v_vec, v_dist)

        room = ax.n_nodes < M
        grow_active = grow & ~dd_skip
        grow_ok = grow_active & valid & room

        new_cost = _row(costs, nearest) + torch.sqrt(sum_last(ext_vec * ext_vec))

        # --- cost-bound resampling for a better parent (aorrtc.hh:197-237)
        par, active = nearest, grow_ok
        g_hat_n = _dist(root_cfg, new_cfg)
        d_new = _dist(configs, new_cfg[:, None])                         # (B, M)
        for i in range(resamples):
            if not active.is_cuda and not bool(active.any()):
                # nothing left to resample (on the card this would take a sync)
                break
            cr = torch.clamp_min(new_cost - g_hat_n, 0.0)
            bound = u[1 + i] * cr + g_hat_n
            cand, cand_d, _ = _aug_nearest(d_new, costs, mask_a, bound)
            cand_cost = _row(costs, cand)
            stop = (cand == par) | (cand_cost + cand_d >= new_cost) | (cr <= 0.0)
            active = active & ~stop
            cand_cfg = _row(configs, cand)
            cand_ok = active & validate_seg(cand_cfg, new_cfg - cand_cfg, cand_d)
            par = torch.where(cand_ok, cand, par)
            new_cost = torch.where(cand_ok, cand_cost + cand_d, new_cost)
            active = active & cand_ok

        # --- dynamic-domain updates
        inf_r = torch.isinf(nearest_radius)
        ok_upd = torch.where(inf_r, nearest_radius, nearest_radius * (1.0 + s.alpha))
        fail_upd = torch.where(
            inf_r, s.radius, torch.clamp_min(nearest_radius * (1.0 - s.alpha), s.min_radius))
        grow_fail = grow_active & ~valid
        new_r = torch.where(grow_ok & dyn, ok_upd,
                            torch.where(grow_fail & dyn, fail_upd, nearest_radius))
        radii = _scatter_rows(ax.radii, torch.where(grow_active, nearest, M)[:, None],
                              new_r[:, None])

        # --- connect target: the bound is what would improve the incumbent
        o_idx, o_d, o_elig = _aug_nearest(d_new, costs, mask_b, ax.max_cost - new_cost)
        o_cfg = _row(configs, o_idx)
        improves = o_elig & (new_cost + o_d + _row(costs, o_idx) < ax.max_cost)
        n_ext = torch.ceil(o_d / s.range).to(torch.long)
        n_ext_f = torch.clamp_min(n_ext.to(torch.float32), 1.0)
        inc = (o_cfg - new_cfg) / n_ext_f[:, None]
        inc_len = o_d / n_ext_f

        # --- inserts (the grow node, or one connect-chain node)
        conn_ok = ax.connect & valid & room
        do_insert = (grow_ok | conn_ok) & ~ax.done
        ins_cfg = torch.where(grow_ok[:, None], new_cfg, c_tip_cfg + ax.c_inc)
        ins_parent = torch.where(grow_ok, par, ax.c_tip)
        ins_cost = torch.where(grow_ok, new_cost, _row(ax.costs, ax.c_tip) + ax.c_inc_len)
        write = torch.where(do_insert, ax.n_nodes, M)[:, None]
        n_nodes = ax.n_nodes + do_insert.to(torch.long)

        # --- connect bookkeeping (enter only when it would improve)
        enter = grow_ok & improves & ~ax.done
        chain_ok = ax.connect & valid & (n_nodes == ax.n_nodes + 1)
        remaining_after = torch.where(
            enter, n_ext, torch.where(chain_ok, ax.c_remaining - 1, 0))
        tip_after = torch.where(do_insert, ax.n_nodes, ax.c_tip)
        joined = ((enter & (n_ext == 0)) | (chain_ok & (remaining_after == 0))) & ~ax.done
        connect_next = (((enter & (n_ext > 0)) | (chain_ok & (remaining_after > 0)))
                        & ~joined & (n_nodes < M))
        grown = grow.to(torch.long)
        return _AOXState(
            configs=_scatter_rows(ax.configs, write, ins_cfg[:, None]),
            parents=_scatter_rows(ax.parents, write, ins_parent[:, None]),
            radii=_scatter_rows(radii, write, torch.full_like(ins_cost[:, None], _INF)),
            in_start=_scatter_rows(ax.in_start, write, a_is_start[:, None]),
            n_nodes=n_nodes,
            size_start=ax.size_start + (do_insert & a_is_start).to(torch.long),
            size_goal=ax.size_goal + (do_insert & ~a_is_start).to(torch.long),
            a_is_start=a_is_start,
            iters=ax.iters + grown,
            sample_idx=ax.sample_idx + grown,
            connect=connect_next,
            c_tip=tip_after,
            c_inc=torch.where(enter[:, None], inc, ax.c_inc),
            c_inc_len=torch.where(enter, inc_len, ax.c_inc_len),
            c_remaining=remaining_after,
            c_other=torch.where(enter, o_idx, ax.c_other),
            done=ax.done | joined,
            junction_a=torch.where(joined, tip_after, ax.junction_a),
            junction_b=torch.where(joined, torch.where(enter, o_idx, ax.c_other),
                                   ax.junction_b),
            a_start_at_join=torch.where(joined, a_is_start, ax.a_start_at_join),
            costs=_scatter_rows(ax.costs, write, ins_cost[:, None]),
            max_cost=ax.max_cost,
        )

    return window, step


def solve_batch(
    spec: RobotSpec,
    envs: Environment,                 # (B, n, f) tables, or (1, n, f) shared
    starts: torch.Tensor,              # (B, d)
    goals: torch.Tensor,               # (B, G, d)
    goal_masks: torch.Tensor,          # (B, G) bool
    settings: RRTCSettings,
    max_costs,                         # (B,) incumbent bounds
    sample_offsets: torch.Tensor | None = None,  # (B,)
    phs: PHS | None = None,            # one transform a problem
    cost_bound_resamples: int = 4,
    device=None,
) -> RRTCResult:
    """AOX_RRTC searches bounded by max_costs, one a problem, in lockstep on
    `device` (default: the GPU)."""
    rrtc_mod._check_settings(settings)
    s = settings
    dev = resolve_device(device)
    envs = envs.to(dev)
    starts, goals, goal_masks = starts.to(dev), goals.to(dev), goal_masks.to(dev)
    B = starts.shape[0]
    if sample_offsets is None:
        sample_offsets = torch.zeros(B, dtype=torch.long, device=dev)
    if phs is not None:
        phs = PHS(*(t.to(dev) for t in phs))
    num_points = validate_mod.n_points_bound(spec, s.range)
    base = rrtc_mod.initial_state(spec, starts, goals, goal_masks, s,
                                  torch.as_tensor(sample_offsets, device=dev),
                                  torch.zeros(B, dtype=torch.bool, device=dev))
    max_cost = torch.clamp_max(
        torch.as_tensor(max_costs, dtype=torch.float32, device=dev).reshape(B), MAX_COST_CLAMP)
    ax = _AOXState(*base, costs=torch.zeros_like(base.radii), max_cost=max_cost)

    window, step = _make_step(spec, s, envs, num_points, cost_bound_resamples, phs)
    cond = rrtc_mod._cond(s)

    def run_window(ax):
        draws = window(ax.sample_idx)
        for _ in range(_WINDOW):
            ax = _select(cond(ax), step(ax, draws), ax)
        return ax

    # On the card a window (64 steps of a few hundred small kernels each)
    # costs the host far more than the device: after a first window run as
    # it comes, the window is captured once as a CUDA graph over the state's
    # tensors and replayed.
    graphs = dev.type == "cuda" and envs.pck is None
    global HOST_SYNCS
    captured, windows = None, 0
    while True:
        HOST_SYNCS += 1
        if not bool(cond(ax).any()):
            break
        if captured is None and graphs and windows:
            static = ax

            def body():
                for dst, src in zip(static, run_window(static)):
                    dst.copy_(src)

            captured = fkcc_cuda.capture(body)
        if captured is not None:
            fkcc_cuda.replay(captured)
        else:
            ax = run_window(ax)
        windows += 1

    path, total = _recover_path(ax, s.max_path, spec.dimension)
    none = torch.zeros(B, dtype=torch.bool, device=dev)
    return rrtc_mod.result_from_chains(
        path, total, ax.a_start_at_join, ax.done, ax.iters, ax.size_start, ax.size_goal,
        ax.sample_idx - 1, starts, goals, none, torch.zeros(B, dtype=torch.long, device=dev),
    )


def solve(spec, env, start, goals, goal_mask, settings, max_cost, sample_offset=0,
          phs: PHS | None = None, cost_bound_resamples: int = 4, device=None) -> RRTCResult:
    """One AOX_RRTC search: env tables (n, f), start (d,), goals (G, d)."""
    dev = resolve_device(device)
    res = solve_batch(
        spec, env.map(lambda t: t[None]), start[None], goals[None], goal_mask[None],
        settings, torch.tensor([float(max_cost)]),
        torch.full((1,), int(sample_offset), dtype=torch.long),
        None if phs is None else PHS(*(t[None] for t in phs)),
        cost_bound_resamples, dev,
    )
    return RRTCResult(*(t[0] for t in res))
