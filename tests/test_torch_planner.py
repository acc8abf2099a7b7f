"""Port parity: the lockstep RRT-Connect planner (plan_batch, plan_batch_compact).

On the sphere-robot wall problem of tests/test_mega.py (B = 3, sample
offsets 0/100/200) the port must reproduce the JAX planner exactly in solved
flags, iterations, tree sizes and path lengths, with costs within rtol 1e-5
and paths within atol 1e-6, at (K, C, W) = (1, 1, 1) and (4, 2, 2) — the
latter exercises the dynamic-domain window and the radius scatter where two
lanes share a nearest node.

On a perturbed Panda cage the port must solve and every segment of its path
must validate.  Iteration counts are not compared there: Panda FK rounds
differently in the two packages (cos/sin, fused multiply-adds), which can
move a sample across a contact and change the tree.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from vamp_mvt_tpu.collision import environment as jenv
from vamp_mvt_tpu.planning import rrtc as jrrtc
from vamp_mvt_tpu.robots import registry as jregistry
from vamp_mvt_tpu_torch.collision import environment as envmod
from vamp_mvt_tpu_torch.planning import rrtc, validate
from vamp_mvt_tpu_torch.robots import registry

torch.set_num_threads(1)

CAGE = [
    [0.55, 0, 0.25], [0.35, 0.35, 0.25], [0, 0.55, 0.25], [-0.55, 0, 0.25],
    [-0.35, -0.35, 0.25], [0, -0.55, 0.25], [0.35, -0.35, 0.25],
    [0.35, 0.35, 0.8], [0, 0.55, 0.8], [-0.35, 0.35, 0.8], [-0.55, 0, 0.8],
    [-0.35, -0.35, 0.8], [0, -0.55, 0.8], [0.35, -0.35, 0.8],
]
PANDA_START = [0.0, -0.785, 0.0, -2.356, 0.0, 1.571, 0.785]
PANDA_GOAL = [2.35, 1.0, 0.0, -0.8, 0.0, 2.5, 0.785]


def sphere_problem(B=3):
    """The wall-with-a-gap problem of tests/test_mega.py, for both packages."""
    lows, highs = (-3, -3, 0), (3, 3, 3)
    jb, tb = jenv.EnvironmentBuilder(), envmod.EnvironmentBuilder()
    for y in np.linspace(-3, 3, 13):
        for z in np.linspace(0, 3, 7):
            if y > 2.0 and z > 2.0:
                continue
            jb.add_sphere([0.0, y, z], 0.3)
            tb.add_sphere([0.0, y, z], 0.3)
    env_j = jb.build()
    envs_j = jax.tree_util.tree_map(lambda a: jnp.broadcast_to(a[None], (B,) + a.shape), env_j)
    envs_t = envmod.broadcast_environment(tb.build(device="cpu"), B)
    starts = np.tile(np.float32([-2.0, 0.0, 1.0]), (B, 1))
    goals = np.tile(np.float32([2.0, 0.0, 1.0]), (B, 1, 1))
    goals = goals + np.arange(B, dtype=np.float32)[:, None, None] * np.float32(0.05)
    masks = np.ones((B, 1), bool)
    return (
        jregistry.sphere_spec(lows=lows, highs=highs, radius=0.1),
        registry.sphere_spec(lows=lows, highs=highs, radius=0.1),
        envs_j, envs_t, starts, goals, masks,
    )


def assert_same_plan(ref, got, B, rtol=1e-5):
    for f in ("solved", "iterations", "size_start", "size_goal", "path_length"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)), f)
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(ref.cost), rtol=rtol)
    for i in range(B):
        L = int(np.asarray(ref.path_length)[i])
        np.testing.assert_allclose(
            got.path.numpy()[i, :L], np.asarray(ref.path)[i, :L], atol=1e-6
        )


@pytest.mark.parametrize("k,c,w", [(1, 1, 1), (4, 2, 2)])
def test_plan_batch_matches_jax(k, c, w):
    jspec, spec, envs_j, envs_t, starts, goals, masks = sphere_problem()
    kw = dict(range=1.0, max_iterations=384, max_samples=512, max_path=64,
              samples_per_step=k, connect_segments=c, sample_window=w)
    offs = np.arange(3, dtype=np.int32) * 100
    ref = jax.jit(lambda e, s, g, m, o: jrrtc.plan_batch(
        jspec, e, s, g, m, jrrtc.RRTCSettings(**kw), o
    ))(envs_j, jnp.asarray(starts), jnp.asarray(goals), jnp.asarray(masks), jnp.asarray(offs))
    args = (spec, envs_t, torch.as_tensor(starts), torch.as_tensor(goals),
            torch.as_tensor(masks), rrtc.RRTCSettings(**kw))
    got = rrtc.plan_batch(*args, torch.as_tensor(offs))
    assert bool(got.solved.any())
    assert_same_plan(ref, got, 3)
    compact = rrtc.plan_batch_compact(
        *args, torch.as_tensor(offs), segment_steps=16, min_batch=1, device="cpu"
    )
    for f in got._fields:
        assert torch.equal(getattr(compact, f), getattr(got, f)), f
    one = rrtc.plan(spec, envs_t.map(lambda t: t[2]), torch.as_tensor(starts[2]),
                    torch.as_tensor(goals[2]), torch.as_tensor(masks[2]),
                    rrtc.RRTCSettings(**kw), sample_offset=int(offs[2]))
    for f in got._fields:
        assert torch.equal(getattr(one, f), getattr(got, f)[2]), f


def test_last_lane_wins_on_duplicate_scatter():
    idx = torch.tensor([[1, 1, 2, 1], [0, 3, 3, 5]])
    out = rrtc._last_wins(idx, 9)
    assert out.tolist() == [[9, 9, 2, 1], [0, 9, 3, 5]]
    buf = rrtc._scatter_rows(torch.zeros(2, 10), out, torch.tensor(
        [[5.0, 7.0, 3.0, 9.0], [1.0, 2.0, 4.0, 6.0]]))
    assert buf[0, 1] == 9.0 and buf[0, 2] == 3.0 and buf[1, 3] == 4.0


def test_index_order_torch_stands_in_for_torch(monkeypatch):
    """rrtc.IndexOrderTorch set as the module's `torch` (as the card checks
    set it): the plain planner runs on it and matches the JAX package on the
    wall problem, and its matmul sums the products in index order."""
    jspec, spec, envs_j, envs_t, starts, goals, masks = sphere_problem()
    kw = dict(range=1.0, max_iterations=384, max_samples=512, max_path=64,
              samples_per_step=4, connect_segments=2, sample_window=2)
    offs = np.arange(3, dtype=np.int32) * 100
    ref = jax.jit(lambda e, s, g, m, o: jrrtc.plan_batch(
        jspec, e, s, g, m, jrrtc.RRTCSettings(**kw), o
    ))(envs_j, jnp.asarray(starts), jnp.asarray(goals), jnp.asarray(masks), jnp.asarray(offs))
    monkeypatch.setattr(rrtc, "torch", rrtc.IndexOrderTorch())
    got = rrtc.plan_batch(spec, envs_t, torch.as_tensor(starts), torch.as_tensor(goals),
                          torch.as_tensor(masks), rrtc.RRTCSettings(**kw), torch.as_tensor(offs))
    monkeypatch.undo()
    assert bool(got.solved.any())
    assert_same_plan(ref, got, 3)
    g = torch.Generator().manual_seed(0)
    a, b = torch.randn(2, 5, 3, generator=g), torch.randn(2, 3, 4, generator=g)
    want = (a[:, :, 0, None] * b[:, None, 0] + a[:, :, 1, None] * b[:, None, 1]) \
        + a[:, :, 2, None] * b[:, None, 2]
    assert torch.equal(rrtc.IndexOrderTorch.matmul(a, b), want)


def test_chains_past_the_path_buffer_count_as_unsolved():
    """result_from_chains when the two chains together pass max_path: the
    problem is unsolved (the JAX package clamps the index of the last row
    and reports a cut path that stops short of the goal); within the buffer
    the result is as before."""
    B, P, d = 3, 4, 2
    path = torch.arange(B * P * d, dtype=torch.float32).reshape(B, P, d)
    total = torch.tensor([3, 4, 6])
    yes, zero = torch.ones(B, dtype=torch.bool), torch.zeros(B, dtype=torch.long)
    r = rrtc.result_from_chains(path, total, yes, yes, zero, zero, zero, zero,
                                path[:, 0], path[:, None, -1], ~yes, zero)
    assert r.solved.tolist() == [True, True, False]
    assert r.path_length.tolist() == [3, 4, 0]
    assert bool(torch.isinf(r.cost[2])) and bool(torch.isfinite(r.cost[:2]).all())
    assert torch.equal(r.path[:2, :3], path[:2, :3])


def test_unported_sampler_raises():
    """The threefry sampler, which raised before it was ported: samples
    keyed by their absolute index through `sampling/threefry.py` equal
    `jax.random`'s, so plan_batch equals the JAX planner exactly on the wall
    problem, compacted or not; an unknown sampler raises."""
    jspec, spec, envs_j, envs_t, starts, goals, masks = sphere_problem()
    kw = dict(range=1.0, max_iterations=384, max_samples=512, max_path=64,
              samples_per_step=4, connect_segments=2, sample_window=2, sampler="threefry")
    offs = np.arange(3, dtype=np.int32) * 100
    ref = jax.jit(lambda e, s, g, m, o: jrrtc.plan_batch(
        jspec, e, s, g, m, jrrtc.RRTCSettings(**kw), o
    ))(envs_j, jnp.asarray(starts), jnp.asarray(goals), jnp.asarray(masks), jnp.asarray(offs))
    args = (spec, envs_t, torch.as_tensor(starts), torch.as_tensor(goals),
            torch.as_tensor(masks), rrtc.RRTCSettings(**kw))
    got = rrtc.plan_batch(*args, torch.as_tensor(offs))
    assert bool(got.solved.any())
    assert_same_plan(ref, got, 3)
    np.testing.assert_array_equal(got.sample_count.numpy(), np.asarray(ref.sample_count))
    compact = rrtc.plan_batch_compact(
        *args, torch.as_tensor(offs), segment_steps=16, min_batch=1, device="cpu")
    for f in got._fields:
        assert torch.equal(getattr(compact, f), getattr(got, f)), f
    with pytest.raises(ValueError, match="unknown sampler"):
        rrtc.plan_batch(*args[:-1], rrtc.RRTCSettings(sampler="mt19937"))


def test_panda_cage_solves_with_valid_path():
    spec = registry.load("panda")
    rng = np.random.default_rng(0)
    b = envmod.EnvironmentBuilder()
    for c in CAGE:
        b.add_sphere(np.asarray(c) + rng.uniform(-0.01, 0.01, 3), 0.2)
    envs = envmod.broadcast_environment(b.build(device="cpu"), 1)
    settings = rrtc.RRTCSettings(
        range=1.0, max_iterations=4096, max_samples=512, max_path=96,
        samples_per_step=16, connect_segments=8, sample_window=4,
    )
    res = rrtc.plan_batch_compact(
        spec, envs, torch.tensor([PANDA_START]), torch.tensor([[PANDA_GOAL]]),
        torch.ones((1, 1), dtype=torch.bool), settings, device="cpu",
    )
    assert bool(res.solved[0])
    L = int(res.path_length[0])
    path = res.path[0, :L]
    np.testing.assert_allclose(path[0].numpy(), PANDA_START, atol=1e-6)
    np.testing.assert_allclose(path[-1].numpy(), PANDA_GOAL, atol=1e-6)
    num = validate.n_points_bound(
        spec, float(np.linalg.norm(spec.limits_high - spec.limits_low))
    )
    ok = validate.validate_motion_batch(spec, envs, path[None, :-1], path[None, 1:], num)
    assert bool(ok.all())
    assert float(res.cost[0]) < 25.0
