"""Path simplification: SHORTCUT, BSPLINE, REDUCE and PERTURB, batched over
problems.

Port of `vamp_mvt_tpu/planning/simplify.py` (reference simplify.hh:14-261;
the default operation sequence is ("shortcut", "bspline"),
simplify_settings.hh:44).

- SHORTCUT (simplify.hh:115-141): every candidate pair of a path is
  validated in one fused FK+CC evaluation, then the reference's greedy erase
  order (ascending i, largest valid j) is replayed over the validity matrix.
- BSPLINE (simplify.hh:14-53): subdivide, pull every even vertex toward the
  midpoint of its neighbours, check both neighbour segments in one batch.
- REDUCE (simplify.hh:55-113) and PERTURB (simplify.hh:143-190): randomized
  vertex removal and perturbation, each problem with its own key, drawn from
  `sampling/threefry.py` (`jax.random`'s streams bit for bit); every loop
  body checks its segments in one launch over the batch.

Paths are (B, P, d) buffers padded with their last vertex.  Loops that the
JAX package runs per problem under vmap run here on the whole batch, each
problem's state written back only while its own loop condition holds.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from vamp_mvt_tpu_torch.collision.environment import Environment
from vamp_mvt_tpu_torch.device import resolve_device
from vamp_mvt_tpu_torch.planning import validate as validate_mod
from vamp_mvt_tpu_torch.planning.validate import norm_last
from vamp_mvt_tpu_torch.robots.spec import RobotSpec
from vamp_mvt_tpu_torch.sampling import threefry

OPS = ("shortcut", "bspline", "reduce", "perturb")


@dataclasses.dataclass(frozen=True)
class SimplifySettings:
    """Mirrors reference simplify_settings.hh:15-51 and the JAX package's
    fields and defaults."""

    max_iterations: int = 5
    interpolate: int = 0
    operations: tuple = ("shortcut", "bspline")
    bspline_max_steps: int = 1
    bspline_min_change: float = 0.1
    bspline_midpoint_interpolation: float = 0.5
    reduce_max_steps: int = 10
    reduce_max_empty_steps: int = 5
    reduce_range_ratio: float = 0.5
    perturb_max_steps: int = 10
    perturb_max_empty_steps: int = 5
    perturb_attempts: int = 5
    perturb_range: float = 0.1
    pair_chunk: int | None = 64
    # shortcut pair-compaction caps: first driver iteration / later ones
    pair_cap_first: int = 1024
    pair_cap_rest: int = 512
    # job-list capacities for the exact-N compacted validator
    shortcut_jobs_first: int = 32768
    shortcut_jobs_rest: int = 8192
    bspline_jobs: int = 6144


class SimplifyResult(NamedTuple):
    path: torch.Tensor         # (B, P, d) padded with last vertex
    path_length: torch.Tensor  # (B,) int32
    cost: torch.Tensor         # (B,) float32
    iterations: torch.Tensor   # (B,) int32


def _check_settings(s: SimplifySettings) -> None:
    for op in s.operations:
        if op not in OPS:
            raise ValueError(f"unknown op {op}")


def default_keys(B: int, device) -> torch.Tensor:
    """split(PRNGKey(0), B): the JAX package's default key a problem."""
    return threefry.split(threefry.prng_key(0, device), B)


def _gather_path(path: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """path (B, P, d) at idx (B, K) -> (B, K, d)."""
    return torch.gather(path, 1, idx[..., None].expand(-1, -1, path.shape[-1]))


def path_cost(path: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    lens = norm_last(path[:, 1:] - path[:, :-1])
    k = torch.arange(1, path.shape[1], device=path.device)
    return torch.where(k[None] < length[:, None], lens, 0.0).sum(1)


def _pad_tail(path: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """Fill entries past `length` with the final vertex."""
    k = torch.arange(path.shape[1], device=path.device)
    last = _gather_path(path, torch.clamp_min(length - 1, 0)[:, None])
    return torch.where((k[None] < length[:, None])[..., None], path, last)


def _shortcut(spec, envs, path, length, pair_cap, job_cap):
    """Batched-validation greedy shortcut (reference simplify.hh:115-141).

    Of the P(P-1)/2 static candidate pairs, those inside the live path come
    first (stable partition) and the first `pair_cap` are validated with
    exact per-pair point counts; pairs past the caps are simply not
    shortcut candidates."""
    B, P, _ = path.shape
    dev = path.device
    ii_np, jj_np = np.triu_indices(P, k=2)
    ii = torch.as_tensor(ii_np, device=dev)
    jj = torch.as_tensor(jj_np, device=dev)
    in_range = jj[None] < length[:, None]                             # (B, npairs)
    cap = min(pair_cap, ii.shape[0])
    order = torch.argsort((~in_range).to(torch.int32), dim=1, stable=True)[:, :cap]
    ii_c, jj_c = ii[order], jj[order]
    live = torch.gather(in_range, 1, order)
    vflat = validate_mod.validate_motion_jobs(
        spec, envs, _gather_path(path, ii_c), _gather_path(path, jj_c), live, job_cap
    )
    V = torch.zeros((B, P, P), dtype=torch.bool, device=dev)
    V[torch.arange(B, device=dev)[:, None], ii_c, jj_c] = vflat & live

    karange = torch.arange(P, device=dev)
    idx = karange.expand(B, P).clone()
    n = length.to(torch.long)
    i = torch.zeros(B, dtype=torch.long, device=dev)
    changed = torch.zeros(B, dtype=torch.bool, device=dev)
    # the JAX while_loop runs while i < n - 2; i grows by one per pass and
    # n never grows, so max(length) - 2 passes cover every problem
    for _ in range(max(int(length.max()) - 2, 0)):
        act = i < n - 2
        row = torch.gather(idx, 1, i[:, None])[:, 0]                     # idx[i]
        vrow = torch.gather(V[torch.arange(B, device=dev), row], 1, idx)
        cand = vrow & (karange[None] > (i + 1)[:, None]) & (karange[None] < n[:, None])
        has = cand.any(1)
        j = P - 1 - torch.argmax(torch.flip(cand, [1]).to(torch.int32), dim=1)
        shift = torch.where(has, j - (i + 1), 0)
        gathered = torch.gather(idx, 1, torch.clamp_max(karange[None] + shift[:, None], P - 1))
        new_idx = torch.where(karange[None] <= i[:, None], idx, gathered)
        idx = torch.where(act[:, None], new_idx, idx)
        n = torch.where(act, n - shift, n)
        changed = changed | (act & (shift > 0))
        i = torch.where(act, i + 1, i)
    return _gather_path(path, idx), n.to(length.dtype), changed


def _bspline(spec, envs, path, length, s: SimplifySettings):
    """Subdivide + midpoint-pull passes (reference simplify.hh:14-53)."""
    B, P, _ = path.shape
    dev = path.device
    mi = s.bspline_midpoint_interpolation
    j = torch.arange(P, device=dev)
    half = (j // 2).expand(B, P)
    nxt = torch.clamp_max(j // 2 + 1, P - 1).expand(B, P)
    prev_i = torch.clamp_min(j - 1, 0).expand(B, P)
    next_i = torch.clamp_max(j + 1, P - 1).expand(B, P)
    even = (j % 2 == 0)
    changed = torch.zeros(B, dtype=torch.bool, device=dev)

    for _ in range(s.bspline_max_steps):
        old_path, old_length = path, length
        can = (2 * length - 1 <= P) & (length >= 3)
        # subdivide: even slots keep vertices, odd slots get midpoints
        ph = _gather_path(path, half)
        sub = torch.where(even[None, :, None], ph, 0.5 * (ph + _gather_path(path, nxt)))
        path = torch.where(can[:, None, None], sub, path)
        length = torch.where(can, 2 * length - 1, length)

        prev = _gather_path(path, prev_i)
        nxt2 = _gather_path(path, next_i)
        t1 = path + (prev - path) * mi
        t2 = path + (nxt2 - path) * mi
        mid = t1 + (t2 - t1) * 0.5

        cand = can[:, None] & even[None] & (j[None] >= 2) & (j[None] < (length - 1)[:, None])
        moved = norm_last(path - mid) > s.bspline_min_change
        # both neighbour segments in one batched, job-compacted validation
        keep = cand & moved
        v = validate_mod.validate_motion_jobs(
            spec, envs, torch.cat([prev, mid], 1), torch.cat([mid, nxt2], 1),
            torch.cat([keep, keep], 1), s.bspline_jobs,
        )
        accept = keep & v[:, :P] & v[:, P:]
        path = torch.where(accept[..., None], mid, path)

        # The reference takes the halves of a subdivided segment as valid,
        # but they are checked on their own, shorter grid, whose points the
        # whole segment's grid did not visit: a grazing contact can hide
        # there.  Check every half that no accepted pull re-validated, and
        # undo this pass for a problem where one fails (JAX-package parity
        # holds whenever all halves are valid).
        nxt_acc = torch.cat([accept[:, 1:], torch.zeros_like(accept[:, :1])], 1)
        halves = can[:, None] & (j[None] < (length - 1)[:, None]) & ~accept & ~nxt_acc
        hv = validate_mod.validate_motion_jobs(
            spec, envs, path, _gather_path(path, next_i), halves, s.bspline_jobs
        )
        sound = ~(halves & ~hv).any(1)
        path = torch.where(sound[:, None, None], path, old_path)
        length = torch.where(sound, length, old_length)
        changed = changed | (accept.any(1) & sound)

    return path, length, changed


def _reduce(spec, envs, path, length, s: SimplifySettings, key, num_long):
    """Randomized vertex removal (reference simplify.hh:55-113), each
    problem looping under its own stop rule; one launch a pass."""
    B, P, _ = path.shape
    dev = path.device
    karange = torch.arange(P, device=dev)
    max_steps = s.reduce_max_steps if s.reduce_max_steps else P
    max_empty = s.reduce_max_empty_steps if s.reduce_max_empty_steps else P
    n = length.to(torch.long)
    i = torch.zeros(B, dtype=torch.long, device=dev)
    no_change = torch.zeros_like(i)
    changed = torch.zeros(B, dtype=torch.bool, device=dev)

    def live():
        return (((i < max_steps) | (no_change < max_empty)) & (n >= 3)
                & (i < 4 * max_steps + 4 * max_empty))

    act = live()
    while bool(act.any()):
        keys = threefry.split(key, 3)
        k1, k2 = keys[:, 1], keys[:, 2]
        max_n = n - 1
        rng_span = 1 + torch.floor(0.5 + n.to(torch.float32) * s.reduce_range_ratio).to(torch.long)
        p0 = threefry.randint(k1, 0, torch.clamp_min(max_n + 1, 1))
        lo = torch.clamp_min(p0 - rng_span, 0)
        hi = torch.minimum(max_n, p0 + rng_span)
        p1 = threefry.randint(k2, lo, torch.maximum(hi + 1, lo + 1))
        # adjust degenerate picks (reference simplify.hh:85-99)
        near = (p0 - p1).abs() < 2
        fwd = p0 < max_n - 1
        p1 = torch.where(near & fwd, p0 + 2, p1)
        p1 = torch.where(near & ~fwd & (p0 > 1), p0 - 2, p1)
        skip = near & ~fwd & ~(p0 > 1)
        a = torch.minimum(p0, p1)
        b = torch.maximum(p0, p1)
        ends = _gather_path(path, torch.stack([a, b], 1).clamp(0, P - 1))
        v = validate_mod.validate_motion(spec, envs, ends[:, 0], ends[:, 1], num_long)
        do = act & v & ~skip & (b - a >= 2)
        shift = torch.where(do, b - (a + 1), 0)
        gathered = _gather_path(path, torch.clamp_max(karange[None] + shift[:, None], P - 1))
        path = torch.where((do[:, None] & (karange[None] > a[:, None]))[..., None], gathered, path)
        n = n - shift
        no_change = torch.where(act, torch.where(do, 0, no_change + 1), no_change)
        i = torch.where(act, i + 1, i)
        changed = changed | do
        key = torch.where(act[:, None], keys[:, 0], key)
        act = live()
    return path, n.to(length.dtype), changed


def _perturb(spec, envs, path, length, s: SimplifySettings, key, num_long):
    """Randomized vertex perturbation toward lower cost (reference
    simplify.hh:143-190): up to `perturb_attempts` proposals a pass, the
    two segments of each checked in one launch over the batch."""
    B, P, d = path.shape
    dev = path.device
    lows = torch.as_tensor(spec.limits_low, device=dev)
    highs = torch.as_tensor(spec.limits_high, device=dev)
    spans = highs - lows
    max_steps = s.perturb_max_steps if s.perturb_max_steps else P
    max_empty = s.perturb_max_empty_steps if s.perturb_max_empty_steps else P
    i = torch.zeros(B, dtype=torch.long, device=dev)
    no_change = torch.zeros_like(i)
    changed = torch.zeros(B, dtype=torch.bool, device=dev)
    rows = torch.arange(B, device=dev)

    def live():
        return (i < max_steps) & (no_change < max_empty) & (length >= 3)

    act = live()
    while bool(act.any()):
        keys = threefry.split(key, 3)
        idx = threefry.randint(keys[:, 1], 1, torch.clamp_min(length.to(torch.long) - 1, 2))
        around = _gather_path(path, torch.stack([idx, idx - 1, idx + 1], 1).clamp(0, P - 1))
        cur, before, after = around[:, 0], around[:, 1], around[:, 2]
        old_cost = norm_last(cur - before) + norm_last(cur - after)
        best, found = cur, torch.zeros(B, dtype=torch.bool, device=dev)
        key2 = keys[:, 2]
        for _ in range(s.perturb_attempts):
            trying = act & ~found
            if not bool(trying.any()):
                break
            k = threefry.split(key2, 2)
            target = threefry.uniform(k[:, 1], d) * spans + lows
            new = cur + (target - cur) * s.perturb_range
            new_cost = norm_last(new - before) + norm_last(new - after)
            v = validate_mod.validate_motion_batch(
                spec, envs, torch.stack([before, after], 1), torch.stack([new, new], 1), num_long)
            ok = trying & (new_cost < old_cost) & v.all(1)
            best = torch.where(ok[:, None], new, best)
            found = found | ok
            key2 = torch.where(trying[:, None], k[:, 0], key2)
        put = path.clone()
        put[rows, idx.clamp(0, P - 1)] = best
        path = torch.where(found[:, None, None], put, path)
        no_change = torch.where(act, torch.where(found, 0, no_change + 1), no_change)
        i = torch.where(act, i + 1, i)
        changed = changed | found
        key = torch.where(act[:, None], keys[:, 0], key)
        act = live()
    return path, length, changed


def _driver_iteration(spec, envs, s: SimplifySettings, pair_cap, job_cap):
    """One pass of the op sequence (reference simplify.hh:239-256); each
    randomized op takes key, sub = split(key) first."""
    span = float(np.linalg.norm(spec.limits_high - spec.limits_low))
    num_long = validate_mod.n_points_bound(spec, span)

    def body(path, length, key):
        changed = torch.zeros(path.shape[0], dtype=torch.bool, device=path.device)
        for op in s.operations:
            if op == "shortcut":
                path, length, ch = _shortcut(spec, envs, path, length, pair_cap, job_cap)
            elif op == "bspline":
                path, length, ch = _bspline(spec, envs, path, length, s)
            else:
                keys = threefry.split(key, 2)
                key, sub = keys[:, 0], keys[:, 1]
                fn = _reduce if op == "reduce" else _perturb
                path, length, ch = fn(spec, envs, path, length, s, sub, num_long)
            changed = changed | ch
        return path, length, changed, key

    return body


def _straight(spec, envs, paths, lengths):
    """Problems whose endpoints connect directly (or are <= 2 vertices)."""
    span = float(np.linalg.norm(spec.limits_high - spec.limits_low))
    num_long = validate_mod.n_points_bound(spec, span)
    first = paths[:, 0]
    last = _gather_path(paths, torch.clamp_min(lengths - 1, 0)[:, None])[:, 0]
    return (lengths <= 2) | validate_mod.validate_motion(spec, envs, first, last, num_long)


def _finish(path, length, iters, straight, orig_path, orig_length) -> SimplifyResult:
    P = path.shape[1]
    first = orig_path[:, 0]
    last = _gather_path(orig_path, torch.clamp_min(orig_length - 1, 0)[:, None])[:, 0]
    k = torch.arange(P, device=path.device)
    straight_path = torch.where((k == 0)[None, :, None], first[:, None], last[:, None])
    out_path = torch.where(straight[:, None, None], straight_path, path)
    out_len = torch.where(straight, 2, length).to(torch.int32)
    out_path = _pad_tail(out_path, out_len)
    return SimplifyResult(
        path=out_path,
        path_length=out_len,
        cost=path_cost(out_path, out_len),
        iterations=torch.where(straight, 0, iters).to(torch.int32),
    )


def simplify_batch(spec, envs, paths, lengths, settings, rng_keys=None) -> SimplifyResult:
    """Simplify a batch of paths (the reference's driver per problem).

    envs (B, n, f) tables, paths (B, P, d), lengths (B,); rng_keys (B, 2)
    for REDUCE and PERTURB, by default split(PRNGKey(0), B) as in the JAX
    package."""
    s = settings
    _check_settings(s)
    lengths = lengths.to(torch.long)
    keys = default_keys(paths.shape[0], paths.device) if rng_keys is None else rng_keys
    straight = _straight(spec, envs, paths, lengths)
    path, length, changed, keys = _driver_iteration(
        spec, envs, s, s.pair_cap_first, s.shortcut_jobs_first
    )(paths, lengths, keys)
    iters = torch.ones_like(lengths)
    rest = _driver_iteration(spec, envs, s, s.pair_cap_rest, s.shortcut_jobs_rest)
    while True:
        act = changed & (iters < s.max_iterations)
        if not bool(act.any()):
            break
        new_path, new_len, new_changed, new_keys = rest(path, length, keys)
        path = torch.where(act[:, None, None], new_path, path)
        length = torch.where(act, new_len, length)
        changed = torch.where(act, new_changed, changed)
        keys = torch.where(act[:, None], new_keys, keys)
        iters = torch.where(act, iters + 1, iters)
    return _finish(path, length, iters, straight, paths, lengths)


def simplify(spec, env, path, length, settings, rng_key=None) -> SimplifyResult:
    """Simplify one path: env tables (n, f), path (P, d), length (); its key
    is PRNGKey(0) unless given, as in the JAX package."""
    key = threefry.prng_key(0, path.device) if rng_key is None else rng_key
    res = simplify_batch(
        spec, env.map(lambda t: t[None]), path[None],
        torch.as_tensor(length, device=path.device).reshape(1), settings, key[None],
    )
    return SimplifyResult(*(t[0] for t in res))


def simplify_batch_compact(
    spec: RobotSpec,
    envs: Environment,
    paths: torch.Tensor,
    lengths: torch.Tensor,
    settings: SimplifySettings,
    min_batch: int = 32,
    device=None,
    rng_keys=None,
) -> SimplifyResult:
    """simplify_batch with straggler compaction: each driver iteration is one
    batched pass; problems that stopped changing (or take the straight-line
    exit) are retired between passes and the rest compacted to the next
    power of two, each keeping its key.  Runs on `device` (default: the
    GPU)."""
    s = settings
    _check_settings(s)
    dev = resolve_device(device)
    envs = envs.to(dev)
    paths, lengths = paths.to(dev), lengths.to(dev).to(torch.long)
    B = paths.shape[0]
    keys = default_keys(B, dev) if rng_keys is None else rng_keys.to(dev)

    straight = _straight(spec, envs, paths, lengths)
    path, length, changed, keys = _driver_iteration(
        spec, envs, s, s.pair_cap_first, s.shortcut_jobs_first
    )(paths, lengths, keys)
    iters = torch.ones_like(lengths)
    rest = _driver_iteration(spec, envs, s, s.pair_cap_rest, s.shortcut_jobs_rest)
    orig_path, orig_length = paths, lengths
    gidx = np.arange(B)
    out: dict[str, np.ndarray] = {}

    def write_back(res, rows):
        for f in res._fields:
            arr = getattr(res, f).cpu().numpy()
            if f not in out:
                out[f] = np.zeros((B,) + arr.shape[1:], arr.dtype)
            out[f][gidx[rows]] = arr[rows]

    while True:
        act_t = changed & (iters < s.max_iterations) & ~straight
        active = act_t.cpu().numpy() & (gidx >= 0)
        n_act = int(active.sum())
        cur = len(gidx)
        target = max(min_batch, 1 << max(int(np.ceil(np.log2(max(n_act, 1)))), 0))
        if n_act == 0 or target < cur:
            write_back(
                _finish(path, length, iters, straight, orig_path, orig_length),
                (~active) & (gidx >= 0),
            )
            if n_act == 0:
                break
            keep = np.flatnonzero(active)
            take_np = np.resize(keep, target)
            take = torch.as_tensor(take_np, device=dev)
            path, length, changed, iters, straight, keys = (
                t[take] for t in (path, length, changed, iters, straight, keys)
            )
            orig_path, orig_length = orig_path[take], orig_length[take]
            envs = envs.map(lambda t: t[take] if t.shape[0] > 1 else t)
            rest = _driver_iteration(spec, envs, s, s.pair_cap_rest, s.shortcut_jobs_rest)
            new_gidx = gidx[take_np]
            new_gidx[len(keep):] = -1
            gidx = new_gidx
            act_t = changed & (iters < s.max_iterations) & ~straight
        new_path, new_len, new_changed, new_keys = rest(path, length, keys)
        path = torch.where(act_t[:, None, None], new_path, path)
        length = torch.where(act_t, new_len, length)
        changed = torch.where(act_t, new_changed, changed)
        keys = torch.where(act_t[:, None], new_keys, keys)
        iters = torch.where(act_t, iters + 1, iters)

    return SimplifyResult(**{f: torch.as_tensor(v, device=dev) for f, v in out.items()})
