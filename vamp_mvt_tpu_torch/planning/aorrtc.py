"""AORRTC: the anytime asymptotically-optimal meta-planner.

Port of `vamp_mvt_tpu/planning/aorrtc.py` (reference src/impl/vamp/planning/
aorrtc.hh:350-492): RRT-Connect for an initial solution, intermediate
simplification, then repeated informed searches whose prolate-hyperspheroid
sampler shrinks with every improvement.  `anytime=True` runs fresh
RRT-Connect searches over the PHS-restricted samples (aorrtc.hh:449-462);
`anytime=False` (the reference default) runs AOX_RRTC cost-bounded searches
(`planning/aox.py`).

`solve` is the reference's one-problem host loop; `solve_batch` advances a
batch of problems through rounds of lockstep AOX searches with per-problem
cost carries.  Both plan with the lockstep planners (`rrtc.plan_batch`,
`aox.solve_batch`) and simplify with `simplify.simplify_batch`, as the JAX
package plans with its vmapped XLA planners: the megakernels are not used.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from vamp_mvt_tpu_torch.collision.environment import Environment
from vamp_mvt_tpu_torch.device import resolve_device
from vamp_mvt_tpu_torch.planning import aox
from vamp_mvt_tpu_torch.planning import rrtc as rrtc_mod
from vamp_mvt_tpu_torch.planning import simplify as simplify_mod
from vamp_mvt_tpu_torch.planning.phs import PHS, make_phs, wahba_rotation
from vamp_mvt_tpu_torch.robots.spec import RobotSpec
from vamp_mvt_tpu_torch.sampling import threefry


@dataclasses.dataclass(frozen=True)
class AORRTCSettings:
    """Mirrors reference aorrtc_settings.hh:8-23 and the JAX package's
    fields and defaults."""

    rrtc: rrtc_mod.RRTCSettings = dataclasses.field(default_factory=rrtc_mod.RRTCSettings)
    simplify: simplify_mod.SimplifySettings = dataclasses.field(
        default_factory=simplify_mod.SimplifySettings)
    optimize: bool = True
    simplify_intermediate: bool = True
    use_phs: bool = True
    anytime: bool = False
    max_iterations: int = 32768
    max_internal_iterations: int = 4096
    # solve_batch stops after this many consecutive rounds in which no
    # problem's cost dropped by stale_rel_tol or more (0: a fixed budget)
    stale_rounds: int = 2
    stale_rel_tol: float = 1e-3


def solve(spec: RobotSpec, env: Environment, start, goals,
          settings: AORRTCSettings | None = None, sample_offset: int = 0, device=None):
    """One problem, env tables (n, f): returns (SimplifyResult of tensors on
    `device` (default: the GPU), iterations)."""
    s = settings or AORRTCSettings()
    dev = resolve_device(device)
    env = env.to(dev)
    start = np.asarray(start, np.float32)
    goals = np.asarray(goals, np.float32).reshape(-1, spec.dimension)
    G = goals.shape[0]
    start_t = torch.as_tensor(start, device=dev)
    goals_t = torch.as_tensor(goals, device=dev)
    mask = torch.ones(G, dtype=torch.bool, device=dev)

    def simp(r):
        return simplify_mod.simplify(spec, env, r.path, r.path_length, s.simplify)

    iters, offset, res = 0, sample_offset, None
    # initial solution (aorrtc.hh:392-397)
    while iters < s.max_iterations:
        res = rrtc_mod.plan(spec, env, start_t, goals_t, mask, s.rrtc, offset)
        iters += int(res.iterations)
        offset += int(res.sample_count)
        if bool(res.solved):
            break
    if res is None or not bool(res.solved):
        return res, iters

    if s.simplify_intermediate:
        sres = simp(res)
        best_path, best_len, best_cost = sres.path, sres.path_length, float(sres.cost)
    else:
        best_path, best_len, best_cost = res.path, res.path_length, float(res.cost)

    def result():
        return simplify_mod.SimplifyResult(
            best_path, best_len, torch.tensor(best_cost, dtype=torch.float32, device=dev),
            torch.tensor(0, dtype=torch.int32, device=dev))

    if not s.optimize or int(best_len) == 2:
        return result(), iters

    best_possible = float(min(np.linalg.norm(g - start) for g in goals))
    internal = dataclasses.replace(s.rrtc, max_iterations=s.max_internal_iterations)
    while iters < s.max_iterations and (best_cost - best_possible) > 1e-8:
        phs = make_phs(start, goals[0], best_cost, dev) if (s.use_phs and G == 1) else None
        if s.anytime:
            r = rrtc_mod.plan(spec, env, start_t, goals_t, mask, internal, offset, phs=phs)
        else:
            # AOX_RRTC cost-bounded search (reference aorrtc.hh:443)
            r = aox.solve(spec, env, start_t, goals_t, mask, internal, np.float32(best_cost),
                          offset, phs=phs, device=dev)
        iters += int(r.iterations)
        offset += int(r.sample_count)
        if bool(r.solved):
            cand = simp(r) if s.simplify_intermediate else r
            if float(cand.cost) < best_cost:
                best_path, best_len, best_cost = cand.path, cand.path_length, float(cand.cost)
    return result(), iters


def _phs_rotations(starts: np.ndarray, goals0: np.ndarray) -> np.ndarray:
    """(B, d, d) Wahba rotations, the cost-independent part of make_phs."""
    return np.stack([wahba_rotation(a, b) for a, b in zip(starts, goals0)])


def _phs_batch(rots, starts, goals0, diameters, device) -> PHS:
    """One PHS a problem for per-problem transverse diameters (make_phs over
    the batch, the rotations computed once)."""
    d = starts.shape[1]
    min_td = np.linalg.norm(goals0 - starts, axis=1)
    conj = np.sqrt(np.maximum(diameters**2 - min_td**2, 0.0))
    diag = np.repeat((0.5 * conj)[:, None], d, axis=1)
    diag[:, 0] = 0.5 * diameters

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return PHS(center=f32(0.5 * (starts + goals0)), tf=f32(rots * diag[:, None, :]),
               min_td=f32(min_td))


def solve_batch(spec: RobotSpec, envs: Environment, starts, goals, masks,
                settings: AORRTCSettings | None = None, sample_offsets=None,
                history: bool = False, device=None):
    """Batched anytime-optimal refinement on `device` (default: the GPU):
    the batch advances through rounds of lockstep AOX searches with
    per-problem cost carries and a batched simplify, where the reference
    loops over one problem (aorrtc.hh:431-487).

    Returns (SimplifyResult batch, per-problem samples drawn[, cost history
    (rounds + 1, B) numpy when history=True]).  Single-goal problems sample
    their PHS (the reference requires one goal, aorrtc.hh:422-425)."""
    s = settings or AORRTCSettings()
    dev = resolve_device(device)
    envs = envs.to(dev)
    starts = torch.as_tensor(starts, dtype=torch.float32).to(dev)
    goals = torch.as_tensor(goals, dtype=torch.float32).to(dev)
    masks = torch.as_tensor(masks, dtype=torch.bool).to(dev)
    B, G, d = goals.shape
    if sample_offsets is None:
        sample_offsets = torch.zeros(B, dtype=torch.long)
    first = torch.as_tensor(sample_offsets).to(dev).to(torch.long)
    # simplify(spec, e, p, l, settings) vmapped: every problem's key is PRNGKey(0)
    keys = threefry.prng_key(0, dev).expand(B, 2)

    def simp(r):
        return simplify_mod.simplify_batch(spec, envs, r.path, r.path_length, s.simplify, keys)

    # --- initial solutions (aorrtc.hh:392-397), batched
    res = rrtc_mod.plan_batch(spec, envs, starts, goals, masks, s.rrtc, first)
    offsets = first + res.sample_count
    sres = simp(res)
    solved0 = res.solved
    best_path = torch.where(solved0[:, None, None], sres.path, res.path)
    best_len = torch.where(solved0, sres.path_length, 0)
    best_cost = torch.where(solved0, sres.cost, torch.inf)
    zeros = torch.zeros(B, dtype=torch.int32, device=dev)

    def out(hist=None):
        o = (simplify_mod.SimplifyResult(best_path, best_len, best_cost, zeros),
             (offsets - first).to(torch.int32))
        return o + (np.stack(hist),) if history and hist is not None else o

    if not s.optimize:
        return out()

    starts_np = starts.cpu().numpy().astype(np.float64)
    goals0_np = goals[:, 0].cpu().numpy().astype(np.float64)
    rots = _phs_rotations(starts_np, goals0_np)
    use_phs = s.use_phs and G == 1
    span = float(np.linalg.norm(np.asarray(spec.limits_high) - np.asarray(spec.limits_low)))
    internal = dataclasses.replace(s.rrtc, max_iterations=s.max_internal_iterations)

    rounds = max((s.max_iterations - int(s.rrtc.max_iterations)) // s.max_internal_iterations, 0)
    hist = [best_cost.cpu().numpy()]
    stale = 0
    for _ in range(rounds):
        # an unsolved problem searches under the f32-safe bound
        mc = torch.where(torch.isfinite(best_cost), best_cost, aox.MAX_COST_CLAMP)
        phs = None
        if use_phs:
            bc = hist[-1].astype(np.float64)
            phs = _phs_batch(rots, starts_np, goals0_np, np.where(np.isfinite(bc), bc, span), dev)
        r = aox.solve_batch(spec, envs, starts, goals, masks, internal, mc, offsets, phs=phs,
                            device=dev)
        offsets = offsets + r.sample_count
        sr = simp(r)
        improved = r.solved & (sr.cost < best_cost)
        best_path = torch.where(improved[:, None, None], sr.path, best_path)
        best_len = torch.where(improved, sr.path_length, best_len)
        best_cost = torch.where(improved, sr.cost, best_cost)
        pc, bc2 = hist[-1], best_cost.cpu().numpy()
        hist.append(bc2)
        # early exit: no problem's cost moved meaningfully for stale_rounds
        if s.stale_rounds:
            moved = np.any((pc - bc2) > s.stale_rel_tol * np.where(np.isfinite(pc), pc, 0.0))
            stale = 0 if moved else stale + 1
            if stale >= s.stale_rounds:
                break
    return out(hist)
