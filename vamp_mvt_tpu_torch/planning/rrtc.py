"""Dynamic-domain balanced bidirectional RRT-Connect, lockstep over a batch.

Port of `vamp_mvt_tpu/planning/rrtc.py`: a uniform-step state machine over
fixed-capacity buffers, stepping a batch of problems together.  Where the
JAX package vmaps a `lax.while_loop`, this module applies `step` to the
whole batch and writes each problem's new state back only where `_cond`
(and the segment's step count) still holds, so finished problems stop
consuming samples exactly as under vmap.  The host syncs once per segment.

Scatters that JAX writes with mode="drop" and the index M use node buffers
of M + 1 rows here: row M is a trash row that no read ever reaches.

Nearest neighbours use the dot form |n|^2 + |s|^2 - 2 n.s at full float32,
as the JAX package does with Precision.HIGHEST.

Samples come from the Halton sequence or (sampler="threefry") from
`sampling/threefry.py`, whose streams are `jax.random`'s bit for bit; with a
PHS (AORRTC's informed sampling) they are mapped into the prolate
hyperspheroid of each problem.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from vamp_mvt_tpu_torch.collision.environment import Environment
from vamp_mvt_tpu_torch.device import resolve_device
from vamp_mvt_tpu_torch.planning import validate as validate_mod
from vamp_mvt_tpu_torch.planning.phs import PHS, phs_samples
from vamp_mvt_tpu_torch.planning.validate import norm_last, sum_last
from vamp_mvt_tpu_torch.robots.spec import RobotSpec
from vamp_mvt_tpu_torch.sampling import threefry
from vamp_mvt_tpu_torch.sampling.halton import halton

# The nearest-neighbour dot products must be full float32: TF32 keeps ~10
# mantissa bits and reorders near ties, so the trees would drift from the
# JAX package's (which computes them at Precision.HIGHEST).
torch.backends.cuda.matmul.allow_tf32 = False

_INF = float("inf")
_SYNC_EVERY = 64  # steps between host checks in plan_batch


class IndexOrderTorch:
    """`torch` with `matmul` summed in index order without FMA, as the
    planner kernel sums its nearest-neighbour dot products
    (`csrc/rrtc_mega.cu::dot`); every other name is torch's.  Set as this
    module's `torch`, it makes the plain planner resolve near ties as the
    kernel does, where cuBLAS's summation order may resolve them the other
    way (a check of the kernel, never the planner's own path)."""

    _torch = torch  # the module itself: this module's `torch` may be this object

    def __getattr__(self, name):
        return getattr(self._torch, name)

    @staticmethod
    def matmul(a, b):
        acc = a[..., :, 0, None] * b[..., None, 0, :]
        for k in range(1, a.shape[-1]):
            acc = acc + a[..., :, k, None] * b[..., None, k, :]
        return acc


@dataclasses.dataclass(frozen=True)
class RRTCSettings:
    """Reference rrtc_settings.hh:5-20 plus batching knobs; field names and
    defaults as in the JAX package (megakernel-only fields are kept so the
    two settings objects carry the same values)."""

    range: float = 2.0
    dynamic_domain: bool = True
    radius: float = 4.0
    alpha: float = 1e-4
    min_radius: float = 1.0
    balance: bool = True
    tree_ratio: float = 1.0
    max_iterations: int = 2048   # sample budget (reference semantics)
    max_samples: int = 2048      # node buffer capacity M
    start_tree_first: bool = True
    max_path: int = 256          # path buffer capacity P
    samples_per_step: int = 1    # K parallel extensions per step
    connect_segments: int = 1    # C connect increments per step
    sample_window: int = 1       # W: each grow step examines K*W samples
    sampler: str = "halton"
    interleave: bool = False
    profile_mask: int = -1
    pc_phase: int = 2


class RRTCResult(NamedTuple):
    solved: torch.Tensor       # (B,) bool
    path: torch.Tensor         # (B, P, d) padded with the last vertex
    path_length: torch.Tensor  # (B,) int32 number of vertices
    cost: torch.Tensor         # (B,) float32 L2 path cost
    iterations: torch.Tensor   # (B,) int32 samples consumed
    size_start: torch.Tensor   # (B,) int32
    size_goal: torch.Tensor    # (B,) int32
    sample_count: torch.Tensor  # (B,) int32


class _State(NamedTuple):
    configs: torch.Tensor    # (B, M+1, d); row M is the trash row
    parents: torch.Tensor    # (B, M+1) int64
    radii: torch.Tensor      # (B, M+1) float32 dynamic-domain radii
    in_start: torch.Tensor   # (B, M+1) bool
    n_nodes: torch.Tensor    # (B,) int64
    size_start: torch.Tensor
    size_goal: torch.Tensor
    a_is_start: torch.Tensor  # (B,) bool — which tree is tree_a
    iters: torch.Tensor      # (B,) int64 samples consumed
    sample_idx: torch.Tensor  # (B,) int64 next 1-based Halton index
    connect: torch.Tensor    # (B,) bool — in connect mode
    c_tip: torch.Tensor      # (B,) int64 chain tip node index
    c_inc: torch.Tensor      # (B, d) connect increment
    c_inc_len: torch.Tensor  # (B,) float32
    c_remaining: torch.Tensor  # (B,) int64 increments left in the chain
    c_other: torch.Tensor    # (B,) int64 target node in tree_b
    done: torch.Tensor       # (B,) bool
    junction_a: torch.Tensor
    junction_b: torch.Tensor
    a_start_at_join: torch.Tensor  # (B,) bool


SAMPLERS = ("halton", "threefry")


def _check_settings(s: RRTCSettings) -> None:
    if s.sampler not in SAMPLERS:
        raise ValueError(f"unknown sampler {s.sampler!r}; one of {SAMPLERS}")


def _select(mask: torch.Tensor, new, old):
    """Per-problem where() over two states (or any tuples of tensors)."""
    out = []
    for n, o in zip(new, old):
        m = mask.reshape(mask.shape + (1,) * (n.dim() - 1))
        out.append(torch.where(m, n, o))
    return type(old)(*out)


def _take(tree, idx: torch.Tensor):
    return type(tree)(*(t[idx] for t in tree))


def _gather_rows(buf: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """buf (B, M, ...) gathered at idx (B, K) -> (B, K, ...)."""
    B = buf.shape[0]
    return buf[torch.arange(B, device=buf.device)[:, None], idx]


def _last_wins(idx: torch.Tensor, drop: int) -> torch.Tensor:
    """Replace by `drop` every lane whose index appears again in a later lane,
    so a scatter writes the LAST lane's value for each index (what XLA's
    scatter does on the CPU) whatever order the device applies writes in."""
    K = idx.shape[-1]
    later = torch.triu(torch.ones(K, K, dtype=torch.bool, device=idx.device), 1)
    dup = ((idx[..., :, None] == idx[..., None, :]) & later).any(-1)
    return torch.where(dup, drop, idx)


def _scatter_rows(buf: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """Out-of-place buf[b, idx[b, k]] = vals[b, k]; indices repeat within a
    row only at the trash row, which nothing reads."""
    out = buf.clone()
    B = buf.shape[0]
    out[torch.arange(B, device=buf.device)[:, None], idx] = vals
    return out


def _make_sampler(spec: RobotSpec, s: RRTCSettings, dev, phs: PHS | None = None):
    """draw(idx0 (B,)) -> the KW samples (B, KW, d) at the absolute indices
    idx0 .. idx0 + KW - 1 (vamp_mvt_tpu/planning/rrtc.py::draw_samples).

    Threefry keys each sample by its absolute index, fold_in(PRNGKey(8), i),
    so a partly consumed window replays the same values next step, as the
    stateless Halton sequence does.  With a PHS (one a problem) the unit
    samples go through phs_samples with radius uniforms keyed by the
    window's first index, fold_in(PRNGKey(17), idx0), and are clamped to the
    joint limits."""
    KW = s.samples_per_step * s.sample_window
    d = spec.dimension
    lows = torch.as_tensor(spec.limits_low, device=dev)
    highs = torch.as_tensor(spec.limits_high, device=dev)
    spans = highs - lows
    arange_kw = torch.arange(KW, device=dev)
    key8, key17 = threefry.prng_key(8, dev), threefry.prng_key(17, dev)

    def draw(idx0: torch.Tensor) -> torch.Tensor:
        idx = idx0[:, None] + arange_kw
        if s.sampler == "threefry":
            unit = threefry.uniform(threefry.fold_in(key8, idx), d)
        else:
            unit = halton(idx, d)
        if phs is None:
            return unit * spans + lows
        radius_u = threefry.uniform(threefry.fold_in(key17, idx0), KW)
        return torch.clamp(phs_samples(phs, unit, radius_u), lows, highs)

    return draw


def _make_step(spec: RobotSpec, s: RRTCSettings, envs: Environment,
               num_points: int, nn_prefix: int | None = None, interleave: bool = False,
               phs: PHS | None = None):
    """One step of the batch.  interleave=True is the planner megakernel's
    other cadence (vamp_mvt_tpu/planning/rrtc_mega.py, INTER): the grow part
    runs every step and an active connect chain advances in the same step;
    its inserts come first, the grow inserts after them.  Only
    rrtc_mega.plan_batch_mega's plain version selects it: the lockstep
    planner keeps the reference's alternating cadence and ignores
    settings.interleave, as the JAX package's does."""
    M, K, C = s.max_samples, s.samples_per_step, s.connect_segments
    NP = M if nn_prefix is None else min(nn_prefix, M)
    KW = K * s.sample_window
    dev = envs.device
    draw = _make_sampler(spec, s, dev, phs)
    arange_np = torch.arange(NP, device=dev)
    j_seg = torch.arange(C, dtype=torch.float32, device=dev)
    c_order = torch.arange(C, device=dev)
    kk = torch.arange(1, num_points + 1, dtype=torch.float32, device=dev)
    res_per_rake = spec.resolution / validate_mod.RAKE
    dyn = s.dynamic_domain

    def step(st: _State) -> _State:
        B = st.n_nodes.shape[0]
        grow = ~st.connect
        do_grow = torch.ones_like(grow) if interleave else grow

        # --- tree balancing (rrtc.hh:100-108), while no chain is active
        asize = torch.where(st.a_is_start, st.size_start, st.size_goal).to(torch.float32)
        bsize = torch.where(st.a_is_start, st.size_goal, st.size_start).to(torch.float32)
        ratio = torch.abs(asize - bsize) / asize
        do_swap = grow & ((not s.balance) | (ratio < s.tree_ratio))
        a_is_start = torch.where(do_swap, ~st.a_is_start, st.a_is_start)

        # =============================== GROW ===============================
        samples = draw(st.sample_idx)                                   # (B, KW, d)

        cfg_nn = st.configs[:, :NP]
        node_mask = arange_np[None] < st.n_nodes[:, None]
        in_a = st.in_start[:, :NP] == a_is_start[:, None]
        mask_a = node_mask & in_a
        mask_b = node_mask & ~in_a

        n2 = sum_last(cfg_nn * cfg_nn)                              # (B, NP)
        s2 = sum_last(samples * samples)                            # (B, KW)
        dots = torch.matmul(samples, cfg_nn.transpose(1, 2))        # (B, KW, NP)
        d2a = s2[:, :, None] + n2[:, None] - 2.0 * dots
        d2a = torch.where(mask_a[:, None], d2a, _INF)
        nearest = torch.argmin(d2a, dim=-1)                          # (B, KW)
        nearest_dist = torch.sqrt(torch.clamp_min(
            torch.gather(d2a, 2, nearest[..., None])[..., 0], 0.0))
        nearest_radius = torch.gather(st.radii, 1, nearest)

        dd_skip = (nearest_radius < nearest_dist) & dyn                 # (B, KW)

        if s.sample_window > 1:
            # spend the K validation lanes on the first K non-skipped samples;
            # consume exactly the samples examined to reach them
            accepted = ~dd_skip
            acc_rank = torch.cumsum(accepted.to(torch.int32), dim=1) - 1
            chosen = accepted & (acc_rank < K)
            nth = chosen & (acc_rank == K - 1)
            consumed = torch.where(
                nth.any(1), torch.argmax(nth.to(torch.int32), dim=1) + 1, KW
            )
            perm = torch.argsort((~chosen).to(torch.int32), dim=1, stable=True)[:, :K]
            samples = _gather_rows(samples, perm)
            nearest = torch.gather(nearest, 1, perm)
            nearest_dist = torch.gather(nearest_dist, 1, perm)
            nearest_radius = torch.gather(nearest_radius, 1, perm)
            lane_ok = torch.gather(chosen, 1, perm)                      # (B, K)
        else:
            consumed = torch.full((B,), K, dtype=torch.long, device=dev)
            lane_ok = ~dd_skip
        nearest_cfg = _gather_rows(st.configs, nearest)                  # (B, K, d)

        reach = nearest_dist < s.range
        scale = torch.where(reach, 1.0, s.range / torch.clamp_min(nearest_dist, 1e-12))
        ext_vec = (samples - nearest_cfg) * scale[..., None]
        ext_dist = torch.clamp_max(nearest_dist, s.range)
        new_cfg = nearest_cfg + ext_vec

        # ============================= CONNECT ==============================
        c_tip_cfg = _gather_rows(st.configs, st.c_tip[:, None])[:, 0]    # (B, d)
        seg_active = c_order[None] < st.c_remaining[:, None]             # (B, C)

        # ====================== one fused validation ========================
        n_g = torch.clamp_min(torch.ceil(ext_dist * res_per_rake), 1.0)
        frac_g = torch.clamp_max(kk / (validate_mod.RAKE * n_g)[..., None], 1.0)
        grow_block = nearest_cfg[:, :, None] + ext_vec[:, :, None] * frac_g[..., None]

        n_c = torch.clamp_min(torch.ceil(st.c_inc_len * res_per_rake), 1.0)
        frac_c = torch.clamp_max(kk / (validate_mod.RAKE * n_c)[:, None], 1.0)  # (B, num)
        conn_block = c_tip_cfg[:, None, None] + st.c_inc[:, None, None] * (
            j_seg[None, :, None, None] + frac_c[:, None, :, None]
        )                                                                # (B, C, num, d)

        block = torch.cat([grow_block, conn_block], dim=1)               # (B, K+C, num, d)
        ok = validate_mod.fkcc_valid(spec, envs, block).all(dim=-1)      # (B, K+C)
        grow_valid, seg_valid = ok[:, :K], ok[:, K:]

        room_for = M - st.n_nodes

        # --- connect prefix inserts, at n_nodes onwards
        seg_eff = seg_active & seg_valid
        prefix = torch.cumprod(seg_eff.to(torch.long), dim=1).sum(1)     # leading run
        c_active = st.connect[:, None] & (c_order[None] < prefix[:, None])
        c_ins = c_active & (c_order[None] < room_for[:, None])
        c_pos = torch.where(c_ins, st.n_nodes[:, None] + c_order, M)
        c_cfgs = c_tip_cfg[:, None] + st.c_inc[:, None] * (j_seg[None, :, None] + 1.0)
        c_parents = torch.where(
            c_order[None] == 0, st.c_tip[:, None], st.n_nodes[:, None] + c_order - 1
        )
        n_conn_ins = c_ins.sum(1)

        # --- grow inserts after them: every valid, non-dd-skipped extension,
        # in order, while room remains
        g_active = do_grow[:, None] & lane_ok & grow_valid
        g_order = torch.cumsum(g_active.to(torch.long), dim=1) - 1
        g_ins = g_active & (g_order < (room_for - n_conn_ins)[:, None])
        g_pos = torch.where(g_ins, (st.n_nodes + n_conn_ins)[:, None] + g_order, M)

        # --- apply inserts (inactive lanes point at the trash row)
        all_pos = torch.cat([g_pos, c_pos], 1)
        all_cfg = torch.cat([new_cfg, c_cfgs], 1)
        all_par = torch.cat([nearest, c_parents], 1)
        configs = _scatter_rows(st.configs, all_pos, all_cfg)
        parents = _scatter_rows(st.parents, all_pos, all_par)
        in_start = _scatter_rows(
            st.in_start, all_pos, a_is_start[:, None].expand_as(all_pos)
        )
        radii = _scatter_rows(st.radii, all_pos, torch.full_like(all_cfg[..., 0], _INF))

        n_ins = g_ins.sum(1) + n_conn_ins
        n_nodes = st.n_nodes + n_ins
        size_start = st.size_start + torch.where(a_is_start, n_ins, 0)
        size_goal = st.size_goal + torch.where(a_is_start, 0, n_ins)

        # --- dynamic-domain radius updates (rrtc.hh:152-155, 226-237)
        inf_r = torch.isinf(nearest_radius)
        ok_upd = torch.where(inf_r, nearest_radius, nearest_radius * (1.0 + s.alpha))
        fail_upd = torch.where(
            inf_r, s.radius,
            torch.clamp_min(nearest_radius * (1.0 - s.alpha), s.min_radius),
        )
        g_attempt = do_grow[:, None] & lane_ok
        new_r = torch.where(
            g_attempt & grow_valid & dyn, ok_upd,
            torch.where(g_attempt & ~grow_valid & dyn, fail_upd, nearest_radius),
        )
        # two lanes may share a `nearest` node with different radii: the
        # last lane wins, as in the JAX package's scatter
        r_idx = _last_wins(torch.where(g_attempt, nearest, M), M)
        radii = _scatter_rows(radii, r_idx, new_r)

        # --- connect bookkeeping: enter connect from the most promising new
        # node (nearest to the other tree), as rrtc.hh:158-171 does per insert
        q2 = sum_last(new_cfg * new_cfg)                                  # (B, K)
        dots_b = torch.matmul(new_cfg, cfg_nn.transpose(1, 2))
        d2b = q2[:, :, None] + n2[:, None] - 2.0 * dots_b
        d2b = torch.where(mask_b[:, None], d2b, _INF)
        o_idx = torch.argmin(d2b, dim=-1)                                 # (B, K)
        o_d = torch.sqrt(torch.clamp_min(
            torch.gather(d2b, 2, o_idx[..., None])[..., 0], 0.0))
        o_d_masked = torch.where(g_ins, o_d, _INF)
        kc = torch.argmin(o_d_masked, dim=1, keepdim=True)               # (B, 1)
        any_g = g_ins.any(1)
        other = torch.gather(o_idx, 1, kc)[:, 0]
        other_dist = torch.gather(o_d, 1, kc)[:, 0]
        n_ext = torch.ceil(other_dist / s.range).to(torch.long)
        n_ext_f = torch.clamp_min(n_ext.to(torch.float32), 1.0)
        new_kc = _gather_rows(new_cfg, kc)[:, 0]
        inc = (_gather_rows(st.configs, other[:, None])[:, 0] - new_kc) / n_ext_f[:, None]
        inc_len = other_dist / n_ext_f

        attempted = torch.clamp_max(st.c_remaining, C)
        fail_chain = st.connect & (prefix < attempted)
        chain_ok = st.connect & ~fail_chain & (n_conn_ins == prefix)
        # a new chain starts only where the old one failed or was absent
        enter = do_grow & any_g & ~chain_ok
        tip_after = torch.where(
            enter,
            torch.gather(g_pos, 1, kc)[:, 0],
            torch.where(chain_ok & (prefix > 0), st.n_nodes + prefix - 1, st.c_tip),
        )
        remaining_after = torch.where(
            enter, n_ext, torch.where(st.connect, st.c_remaining - prefix, 0)
        )
        c_inc_new = torch.where(enter[:, None], inc, st.c_inc)
        c_inc_len_new = torch.where(enter, inc_len, st.c_inc_len)

        joined = (
            (enter & (n_ext == 0)) | (chain_ok & (remaining_after == 0))
        ) & ~st.done
        connect_next = (
            (enter & (n_ext > 0)) | (chain_ok & (remaining_after > 0))
        ) & ~joined & (n_nodes < M)

        done = st.done | joined
        junction_a = torch.where(joined, tip_after, st.junction_a)
        junction_b = torch.where(
            joined, torch.where(enter, other, st.c_other), st.junction_b
        )
        a_start_at_join = torch.where(joined, a_is_start, st.a_start_at_join)
        used = torch.where(do_grow, consumed, 0)

        return _State(
            configs=configs, parents=parents, radii=radii, in_start=in_start,
            n_nodes=n_nodes, size_start=size_start, size_goal=size_goal,
            a_is_start=a_is_start, iters=st.iters + used,
            sample_idx=st.sample_idx + used, connect=connect_next,
            c_tip=tip_after, c_inc=c_inc_new, c_inc_len=c_inc_len_new,
            c_remaining=remaining_after,
            c_other=torch.where(enter, other, st.c_other), done=done,
            junction_a=junction_a, junction_b=junction_b,
            a_start_at_join=a_start_at_join,
        )

    return step


def _walk(parents: torch.Tensor, start_idx: torch.Tensor, cap: int):
    """Chains of node indices from start_idx (B,) to each tree root.

    Returns (idxs (B, cap), length (B,)).  Past the root the chain repeats
    the root."""
    B = parents.shape[0]
    idxs = torch.zeros((B, cap), dtype=torch.long, device=parents.device)
    length = torch.full((B,), -1, dtype=torch.long, device=parents.device)
    cur = start_idx
    for i in range(cap):
        idxs[:, i] = cur
        nxt = torch.gather(parents, 1, cur[:, None])[:, 0]
        length = torch.where((length < 0) & (nxt == cur), i + 1, length)
        cur = nxt
    return idxs, torch.clamp_min(length, 1)


def _recover_path(st: _State, P: int, d: int):
    """Each problem's path through both junction nodes (rrtc.hh:193-224),
    laid out as chain A root..junction at rows 0..la-1 and chain B
    junction..root after it.  Returns (path (B, P, d), total = la + lb)."""
    B = st.n_nodes.shape[0]
    dev = st.configs.device
    chain_a, la = _walk(st.parents, st.junction_a, P)
    chain_b, lb = _walk(st.parents, st.junction_b, P)
    total = la + lb

    k = torch.arange(P, device=dev)
    path = torch.zeros((B, P + 1, d), dtype=torch.float32, device=dev)
    # chain A reversed: root_a ... junction_a at positions 0..la-1
    pos_a = torch.where(k[None] < la[:, None], la[:, None] - 1 - k[None], P)
    path = _scatter_rows(path, pos_a, _gather_rows(st.configs, chain_a))
    # chain B forward: junction_b ... root_b at positions la..la+lb-1
    pos_b = torch.where(k[None] < lb[:, None], la[:, None] + k[None], P)
    pos_b = torch.clamp_max(pos_b, P)
    path = _scatter_rows(path, pos_b, _gather_rows(st.configs, chain_b))[:, :P]
    return path, total


def result_from_chains(path, total, a_start_at_join, solved, iterations, size_start,
                       size_goal, sample_count, starts, goals, any_direct,
                       first_direct) -> RRTCResult:
    """Planner result from the chain rows of _recover_path: orientation,
    padding, cost and the direct-connection overrides (rrtc.hh:193-224).
    Shared by the lockstep planner and the megakernel's host side."""
    P = path.shape[1]
    k = torch.arange(P, device=path.device)
    # If tree_a was the goal tree at join, reverse the whole path:
    # roll(flip(path), total - P)[k] = path[P - 1 - ((k - total + P) mod P)]
    src = P - 1 - torch.remainder(k[None] - total[:, None] + P, P)
    rev = _gather_rows(path, src)
    path = torch.where(a_start_at_join[:, None, None], path, rev)
    last = _gather_rows(path, torch.clamp(total - 1, 0, P - 1)[:, None])
    path = torch.where((k[None] < total[:, None])[..., None], path, last)
    lens = norm_last(path[:, 1:] - path[:, :-1])
    cost = torch.where(k[None, 1:] < total[:, None], lens, 0.0).sum(1)

    direct_goal = _gather_rows(goals, first_direct[:, None])[:, 0]       # (B, d)
    direct_path = torch.where(
        (k == 0)[None, :, None], starts[:, None], direct_goal[:, None]
    )
    path = torch.where(any_direct[:, None, None], direct_path, path)
    total = torch.where(any_direct, 2, total)
    cost = torch.where(any_direct, norm_last(direct_goal - starts), cost)
    # Chains longer than the path buffer together cannot be exported.  The
    # JAX package clamps the index of the last row and reports a cut path
    # that stops short of the goal; here such a problem counts as unsolved.
    solved = solved & (total <= P)

    i32 = torch.int32
    return RRTCResult(
        solved=solved,
        path=path,
        path_length=torch.where(solved, total, 0).to(i32),
        cost=torch.where(solved, cost, _INF),
        iterations=iterations.to(i32),
        size_start=size_start.to(i32),
        size_goal=size_goal.to(i32),
        sample_count=sample_count.to(i32),
    )


def _init_state(spec, envs, starts, goals, goal_masks, settings, sample_offsets):
    """Initial planner state + direct-connection info (rrtc.hh:60-96)."""
    B, G = goals.shape[:2]
    d = spec.dimension

    # --- straight-line goal check (rrtc.hh:60-73)
    span = float(np.linalg.norm(spec.limits_high - spec.limits_low))
    direct_points = validate_mod.n_points_bound(spec, span)
    direct = validate_mod.validate_motion_batch(
        spec, envs, starts[:, None].expand(B, G, d), goals, direct_points
    )
    direct = direct & goal_masks
    any_direct = direct.any(1)
    first_direct = torch.argmax(direct.to(torch.int32), dim=1)
    st = initial_state(spec, starts, goals, goal_masks, settings, sample_offsets, any_direct)
    return st, any_direct, first_direct


def initial_state(spec, starts, goals, goal_masks, settings, sample_offsets, done) -> _State:
    """The trees before the first step: node 0 = start; nodes 1..G = goals,
    masked-out goals parked far outside the workspace so NN never selects
    them; `done` (B,) marks problems that need no search."""
    s = settings
    M, d = s.max_samples, spec.dimension
    B, G = goals.shape[:2]
    dev = starts.device
    configs = torch.zeros((B, M + 1, d), dtype=torch.float32, device=dev)
    configs[:, 0] = starts
    far = torch.where(goal_masks[..., None], 0.0, 1e8)
    configs[:, 1 : 1 + G] = (goals + far).to(torch.float32)
    parents = torch.zeros((B, M + 1), dtype=torch.long, device=dev)
    parents[:, : 1 + G] = torch.arange(1 + G, device=dev)
    in_start = torch.zeros((B, M + 1), dtype=torch.bool, device=dev)
    in_start[:, 0] = True
    n_goals = goal_masks.to(torch.long).sum(1)

    def full(v, dtype=torch.long):
        return torch.full((B,), v, dtype=dtype, device=dev)

    return _State(
        configs=configs,
        parents=parents,
        radii=torch.full((B, M + 1), _INF, device=dev),
        in_start=in_start,
        n_nodes=full(1 + G),
        size_start=full(1),
        size_goal=n_goals,
        a_is_start=full(not s.start_tree_first, torch.bool),
        iters=full(0),
        sample_idx=sample_offsets.to(torch.long) + 1,
        connect=full(False, torch.bool),
        c_tip=full(0),
        c_inc=torch.zeros((B, d), dtype=torch.float32, device=dev),
        c_inc_len=full(1.0, torch.float32),
        c_remaining=full(0),
        c_other=full(0),
        done=done,
        junction_a=full(0),
        junction_b=full(0),
        a_start_at_join=full(True, torch.bool),
    )


def _cond(s: RRTCSettings):
    def cond(st: _State) -> torch.Tensor:
        # a pending connect phase may finish past the sample budget, as in the
        # reference (its connect loop runs inside the final iteration)
        budget = (st.iters < s.max_iterations) | st.connect
        return (~st.done) & budget & (st.n_nodes < s.max_samples)

    return cond


def _run_steps(spec, s, envs, st, num_points, max_steps=None, nn_prefix=None,
               interleave=False, phs=None):
    """Advance every problem until done/budget (or for at most max_steps).

    Each step runs on the whole batch and is kept only where `_cond` holds,
    which is what the vmapped while_loop computes.  With max_steps the
    segment runs exactly that many masked steps and never syncs; without it,
    the host checks for live problems once every _SYNC_EVERY steps.
    nn_prefix soundness: n_nodes + max_steps * (K + C) <= nn_prefix.  A step
    inserts at most K + C nodes in either cadence (the interleaved one at
    most K grow and C connect nodes together), so the bound holds for both.
    """
    step = _make_step(spec, s, envs, num_points, nn_prefix=nn_prefix, interleave=interleave,
                      phs=phs)
    cond = _cond(s)
    if max_steps is not None:
        for _ in range(max_steps):
            st = _select(cond(st), step(st), st)
        return st
    while bool(cond(st).any()):
        for _ in range(_SYNC_EVERY):
            st = _select(cond(st), step(st), st)
    return st


def _finalize(spec, s: RRTCSettings, st: _State, starts, goals, any_direct,
              first_direct) -> RRTCResult:
    """Path recovery + direct-connection overrides (rrtc.hh:193-224)."""
    path, total = _recover_path(st, s.max_path, spec.dimension)
    return result_from_chains(
        path, total, st.a_start_at_join, st.done, st.iters, st.size_start,
        st.size_goal, st.sample_idx - 1, starts, goals, any_direct, first_direct,
    )


def plan_batch(
    spec: RobotSpec,
    envs: Environment,                 # (B, n, f) tables
    starts: torch.Tensor,              # (B, d)
    goals: torch.Tensor,               # (B, G, d)
    goal_masks: torch.Tensor,          # (B, G) bool
    settings: RRTCSettings,
    sample_offsets: torch.Tensor | None = None,  # (B,)
    phs: PHS | None = None,            # one transform a problem (leading axis B)
) -> RRTCResult:
    """Solve a batch of problems in lockstep; tensors stay on their device.
    phs: informed sampling (AORRTC's anytime loop, reference
    aorrtc.hh:450-459), as the JAX package's vmapped plan(phs=) takes it."""
    _check_settings(settings)
    if sample_offsets is None:
        sample_offsets = torch.zeros(starts.shape[0], dtype=torch.long, device=starts.device)
    num_points = validate_mod.n_points_bound(spec, settings.range)
    st, ad, fd = _init_state(spec, envs, starts, goals, goal_masks, settings, sample_offsets)
    st = _run_steps(spec, settings, envs, st, num_points, phs=phs)
    return _finalize(spec, settings, st, starts, goals, ad, fd)


def plan(spec, env, start, goals, goal_mask, settings, sample_offset=0,
         phs: PHS | None = None) -> RRTCResult:
    """Solve one problem: env tables (n, f), start (d,), goals (G, d), and
    optionally one PHS."""
    res = plan_batch(
        spec, env.map(lambda t: t[None]), start[None], goals[None], goal_mask[None],
        settings,
        torch.full((1,), int(sample_offset), dtype=torch.long, device=start.device),
        phs=None if phs is None else PHS(*(t[None] for t in phs)),
    )
    return RRTCResult(*(t[0] for t in res))


def plan_batch_compact(
    spec: RobotSpec,
    envs: Environment,
    starts: torch.Tensor,
    goals: torch.Tensor,
    goal_masks: torch.Tensor,
    settings: RRTCSettings,
    sample_offsets: torch.Tensor | None = None,
    segment_steps: int = 64,
    min_batch: int = 32,
    device=None,
    *,
    interleave: bool = False,
) -> RRTCResult:
    """Lockstep planning with straggler compaction.

    Runs the state machine in segments; whenever the number of unfinished
    problems drops below the next power of two, finished problems are
    finalized and the stragglers gathered into a smaller batch.  Results
    equal plan_batch's.  Runs on `device` (default: the GPU).
    settings.interleave is ignored, as in plan_batch; interleave=True runs
    the megakernel's interleaved cadence instead (_make_step), which only
    rrtc_mega.plan_batch_mega's plain version asks for.
    """
    _check_settings(settings)
    dev = resolve_device(device)
    envs = envs.to(dev)
    starts, goals, goal_masks = starts.to(dev), goals.to(dev), goal_masks.to(dev)
    B = starts.shape[0]
    if sample_offsets is None:
        sample_offsets = torch.zeros(B, dtype=torch.long, device=dev)
    sample_offsets = sample_offsets.to(dev)
    num_points = validate_mod.n_points_bound(spec, settings.range)
    cond = _cond(settings)

    M = settings.max_samples
    per_step = settings.samples_per_step + settings.connect_segments
    min_prefix = 512

    st, ad, fd = _init_state(spec, envs, starts, goals, goal_masks, settings, sample_offsets)
    work_envs = envs
    work = (starts, goals, ad, fd)
    gidx = np.arange(B)
    out: dict[str, np.ndarray] = {}

    def write_back(res, rows):
        for f in res._fields:
            arr = getattr(res, f).cpu().numpy()
            if f not in out:
                out[f] = np.zeros((B,) + arr.shape[1:], arr.dtype)
            out[f][gidx[rows]] = arr[rows]

    while True:
        # NN-prefix bucket: smallest power of two covering the current max
        # tree size plus this segment's worst-case growth
        n_nodes = st.n_nodes.cpu().numpy()
        n_max = int(np.max(n_nodes[gidx >= 0], initial=1))
        prefix = min_prefix
        while prefix < M and prefix < n_max + 2 * per_step:
            prefix *= 2
        prefix = min(prefix, M)
        steps = segment_steps
        if prefix < M:
            steps = min(segment_steps, max((prefix - n_max) // per_step, 2))
        st = _run_steps(spec, settings, work_envs, st, num_points,
                        max_steps=steps, nn_prefix=prefix, interleave=interleave)
        active = cond(st).cpu().numpy() & (gidx >= 0)
        n_act = int(active.sum())
        cur = len(gidx)
        if n_act == 0:
            write_back(_finalize(spec, settings, st, *work), gidx >= 0)
            break
        target = max(min_batch, 1 << int(np.ceil(np.log2(n_act))))
        if target < cur:
            # finalize and retire everything not active, compact the rest
            write_back(_finalize(spec, settings, st, *work), (~active) & (gidx >= 0))
            keep = np.flatnonzero(active)
            take_np = np.resize(keep, target)
            take = torch.as_tensor(take_np, device=dev)
            st = _take(st, take)
            work = tuple(t[take] for t in work)
            work_envs = work_envs.map(lambda t: t[take] if t.shape[0] > 1 else t)
            new_gidx = gidx[take_np]
            new_gidx[len(keep):] = -1  # padding rows
            gidx = new_gidx

    return RRTCResult(**{f: torch.as_tensor(v, device=dev) for f, v in out.items()})
