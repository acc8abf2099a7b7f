"""Port parity: AOX_RRTC (`planning/aox.py`) and the lockstep planner's
informed sampling, on the CPU.

The AOX cases of tests/test_planners.py (the sphere robot's wall with a gap)
and the vmapped JAX searches run through both packages with the same inputs.
Every random stream is `jax.random`'s bit for bit (`sampling/threefry.py`),
so the searches agree exactly: solved flags, iterations, sample counts and
tree sizes equal, costs within rtol 1e-5, paths within atol 1e-5.

One case holds outcomes only: AOX under the unbounded 1e30 sentinel, which
the search clamps to 1e8.  There c_rand lies in the tens of millions, where
float32's spacing is 4-8, so the augmented distances of nodes whose costs
differ by less than that tie, and one rounding decides which node an argmin
takes: XLA on the CPU contracts some multiply-adds into FMAs (on the wall
problem at offset 200 the two packages part at the 23rd sample).  The test
holds both packages to the JAX test's soundness: a solved path runs from the
start to the goal, costs at least the straight line and validates.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from vamp_mvt_tpu.planning import aox as jaox
from vamp_mvt_tpu.planning import phs as jphs
from vamp_mvt_tpu.planning import rrtc as jrrtc
from vamp_mvt_tpu_torch.planning import aorrtc, aox, rrtc

from test_torch_aorrtc import (  # noqa: F401
    BASE, CPU, GOAL, START, _fresh_jax_caches, _problem, _same_search, _valid_segments,
)
from test_torch_planner import assert_same_plan, sphere_problem

torch.set_num_threads(1)


def test_aox_respects_cost_bound():
    """AOX_RRTC connections must improve on the incumbent cost bound."""
    spec, env, jspec, jenv = _problem()
    s = rrtc.RRTCSettings(**dict(BASE, max_iterations=1024, max_samples=1024))
    js = jrrtc.RRTCSettings(**dict(BASE, max_iterations=1024, max_samples=1024))
    start, goal, mask = torch.tensor(START), torch.tensor(GOAL), torch.ones(1, dtype=torch.bool)
    r0 = rrtc.plan(spec, env, start, goal, mask, s)
    assert bool(r0.solved)
    bound = float(r0.cost)
    r1 = aox.solve(spec, env, start, goal, mask, s, bound, device=CPU)
    ref = jax.jit(lambda e, a, g, m, mc: jaox.solve(jspec, e, a, g, m, js, mc))(
        jenv, jnp.asarray(START), jnp.asarray(GOAL), jnp.asarray([True]), jnp.float32(bound))
    _same_search(r1, ref)
    if bool(r1.solved):
        assert float(r1.cost) < bound + 1e-4
        assert _valid_segments(spec, env, r1.path.numpy()[: int(r1.path_length)])


@pytest.mark.parametrize("mc", [1e30, 3.0])
def test_aox_unbounded_sentinel_is_sound(mc):
    """With the 1e30 sentinel (clamped to 1e8) or three times the straight
    line as the bound, a solved path ends at the goal and costs at least the
    straight line; at the finite bound the port equals the JAX package."""
    spec, env, jspec, jenv = _problem()
    s = rrtc.RRTCSettings(**dict(BASE, max_iterations=1024, max_samples=1024))
    js = jrrtc.RRTCSettings(**dict(BASE, max_iterations=1024, max_samples=1024))
    lower = float(np.linalg.norm(np.subtract(GOAL[0], START)))
    bound = mc if mc > 1e8 else mc * lower
    got = aox.solve(spec, env, torch.tensor(START), torch.tensor(GOAL),
                    torch.ones(1, dtype=torch.bool), s, bound, device=CPU)
    ref = jax.jit(lambda e, a, g, m, c: jaox.solve(jspec, e, a, g, m, js, c))(
        jenv, jnp.asarray(START), jnp.asarray(GOAL), jnp.asarray([True]), jnp.float32(bound))
    if bound < 1e8:
        _same_search(got, ref)
    for r in (got, ref):
        if not bool(r.solved):
            continue
        p = np.asarray(r.path)[: int(r.path_length)]
        assert np.linalg.norm(p[0] - START) < 1e-5
        assert np.linalg.norm(p[-1] - GOAL[0]) < 1e-5
        assert float(r.cost) >= lower - 1e-4
        assert _valid_segments(spec, env, p)


def test_plan_batch_with_phs_matches_jax():
    """The lockstep planner with one PHS a problem (Halton and threefry
    units) against the JAX package's vmapped plan(phs=)."""
    jspec, spec, envs_j, envs_t, starts, goals, masks = sphere_problem(3)
    diam = np.linalg.norm(goals[:, 0] - starts, axis=1) * np.array([1.4, 1.8, 2.5])
    rots = aorrtc._phs_rotations(starts.astype(np.float64), goals[:, 0].astype(np.float64))
    t_phs = aorrtc._phs_batch(rots, starts.astype(np.float64), goals[:, 0].astype(np.float64),
                              diam, CPU)
    j_phs = jphs.PHS(*(jnp.asarray(t.numpy()) for t in t_phs))
    offs = np.arange(3, dtype=np.int32) * 100
    for sampler in ("halton", "threefry"):
        kw = dict(range=1.0, max_iterations=384, max_samples=512, max_path=64,
                  samples_per_step=4, connect_segments=2, sample_window=2, sampler=sampler)
        ref = jax.jit(jax.vmap(lambda e, a, g, m, o, p: jrrtc.plan(
            jspec, e, a, g, m, jrrtc.RRTCSettings(**kw), o, phs=p)))(
            envs_j, jnp.asarray(starts), jnp.asarray(goals), jnp.asarray(masks),
            jnp.asarray(offs), j_phs)
        got = rrtc.plan_batch(spec, envs_t, torch.as_tensor(starts), torch.as_tensor(goals),
                              torch.as_tensor(masks), rrtc.RRTCSettings(**kw),
                              torch.as_tensor(offs), phs=t_phs)
        assert bool(got.solved.any())
        assert_same_plan(ref, got, 3)
        np.testing.assert_array_equal(got.sample_count.numpy(), np.asarray(ref.sample_count))
        # every sample lay in its problem's ellipsoid, so every path vertex does
        for i in range(3):
            L = int(got.path_length[i])
            p = got.path.numpy()[i, :L]
            foci = (np.linalg.norm(p - starts[i], axis=1)
                    + np.linalg.norm(p - goals[i, 0], axis=1))
            assert (foci <= diam[i] * (1 + 1e-4)).all()


def test_batched_aox_matches_vmapped_jax():
    """aox.solve_batch against jax.vmap(aox.solve) at per-problem finite
    bounds and offsets, and its one-problem form against the batch row."""
    jspec, spec, envs_j, envs_t, starts, goals, masks = sphere_problem(3)
    mc = np.float32([9.0, 7.5, 8.2])
    offs = np.arange(3, dtype=np.int32) * 100
    s = rrtc.RRTCSettings(**dict(BASE, max_iterations=768, max_samples=1024))
    js = jrrtc.RRTCSettings(**dict(BASE, max_iterations=768, max_samples=1024))
    ref = jax.jit(jax.vmap(lambda e, a, g, m, c, o: jaox.solve(jspec, e, a, g, m, js, c, o)))(
        envs_j, jnp.asarray(starts), jnp.asarray(goals), jnp.asarray(masks), jnp.asarray(mc),
        jnp.asarray(offs))
    got = aox.solve_batch(spec, envs_t, torch.as_tensor(starts), torch.as_tensor(goals),
                          torch.as_tensor(masks), s, torch.as_tensor(mc), torch.as_tensor(offs),
                          device=CPU)
    assert bool(got.solved.any())
    for i in range(3):
        _same_search(type(got)(*(t[i] for t in got)), type(ref)(*(t[i] for t in ref)))
    one = aox.solve(spec, envs_t.map(lambda t: t[0]), torch.as_tensor(starts[0]),
                    torch.as_tensor(goals[0]), torch.as_tensor(masks[0]), s, float(mc[0]),
                    int(offs[0]), device=CPU)
    for a, b in zip(one, got):
        assert torch.equal(a, b[0])
    # the resample rounds off (a short budget): the search still matches
    s0, js0 = (dataclasses.replace(x, max_iterations=256) for x in (s, js))
    r0 = aox.solve_batch(spec, envs_t, torch.as_tensor(starts), torch.as_tensor(goals),
                         torch.as_tensor(masks), s0, torch.as_tensor(mc), torch.as_tensor(offs),
                         cost_bound_resamples=0, device=CPU)
    ref0 = jax.jit(jax.vmap(lambda e, a, g, m, c, o: jaox.solve(
        jspec, e, a, g, m, js0, c, o, cost_bound_resamples=0)))(
        envs_j, jnp.asarray(starts), jnp.asarray(goals), jnp.asarray(masks), jnp.asarray(mc),
        jnp.asarray(offs))
    for i in range(3):
        _same_search(type(r0)(*(t[i] for t in r0)), type(ref0)(*(t[i] for t in ref0)))
