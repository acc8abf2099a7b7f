"""Port parity: the planner and simplifier megakernels' host sides.

The JAX side runs as tests/test_mega.py runs it, the Pallas kernels in
interpret mode on the CPU.  The port side runs with device="cpu", where
`plan_batch_mega` and `simplify_batch_mega` take their plain versions (the
lockstep planner and simplifier); the CUDA kernels themselves are held
against those plain versions in tests/test_torch_gpu.py and chip_smoke.py.

- `_kernel_config`: the same dict and the same errors as the JAX package.
- `mega_inputs`: the same control word and initial node rows (configuration,
  in-start flag, radius, parent, squared norm) on the sphere-robot wall
  problem and on four Panda cages.
- `plan_batch_mega` on the wall problem (the assertions of
  tests/test_mega.py): exact solved flags, iterations, tree sizes and path
  lengths, costs within rtol 1e-6, paths within atol 1e-6; also the retry
  call (a runtime budget, solved rows' goals replaced by their starts).
- The interleaved cadence (interleave=True): the port's plain version
  against the JAX megakernel's with the same assertions (costs within rtol
  1e-5); every problem solved with valid segments at test_mega.py's
  settings; the lockstep planners of both packages ignore the flag.
- `simplify_batch_mega` on the wall problem's planned paths: equal path
  lengths, costs within rtol 1e-5, paths within atol 1e-5 (B-spline pulls
  accumulate float32 rounding that the two packages order differently);
  and the straight-line exit.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from vamp_mvt_tpu.bench import mbm as jmbm
from vamp_mvt_tpu.planning import rrtc as jrrtc
from vamp_mvt_tpu.planning import rrtc_mega as jrrtc_mega
from vamp_mvt_tpu.planning import simplify as jsimplify
from vamp_mvt_tpu.planning import simplify_mega as jsimplify_mega
from vamp_mvt_tpu.robots import registry as jregistry
from vamp_mvt_tpu_torch.bench import mbm
from vamp_mvt_tpu_torch.collision import environment as envmod
from vamp_mvt_tpu_torch.planning import rrtc, rrtc_mega, simplify, simplify_mega, validate
from vamp_mvt_tpu_torch.robots import registry

from test_torch_planner import assert_same_plan, sphere_problem

torch.set_num_threads(1)

OFFSETS = np.arange(3, dtype=np.int32) * 100


def _suite_settings(robot: str) -> dict:
    """run_suite's planner="mega" defaults (mbm.py, both packages)."""
    return dict(range=registry.RRT_RANGES.get(robot, 1.0), max_iterations=4096,
                max_samples=16384, max_path=96,
                samples_per_step=32 if robot == "fetch" else 16, connect_segments=8,
                sample_window=4 if robot == "fetch" else 8)


def _wall_settings(k, c, w, **kw) -> dict:
    return dict(range=1.0, max_iterations=384, max_samples=512, max_path=64,
                samples_per_step=k, connect_segments=c, sample_window=w) | kw


@pytest.mark.parametrize("robot", ["panda", "fetch", "baxter", "sphere"])
def test_kernel_config_matches_jax(robot):
    """The port keeps the settings' figures of the JAX package's dict (not
    its TPU tile figures: dp, P, R, EPT, NT, CH, C0, Erow, PP)."""
    kw = _suite_settings(robot)
    jspec, spec = jregistry.load(robot), registry.load(robot)
    for G in (1, 4):
        ref = jrrtc_mega._kernel_config(jspec, jrrtc.RRTCSettings(**kw), G)
        got = rrtc_mega._kernel_config(spec, rrtc.RRTCSettings(**kw), G)
        assert set(got) == {"d", "K", "C", "W", "KW", "E", "N", "M", "G"}
        assert got == {k: ref[k] for k in got}


@pytest.mark.parametrize("k,c,w,cuda_runs", [
    pytest.param(32, 8, 8, False, id="32-8-8"),
    pytest.param(60, 8, 1, False, id="60-8-1"),
    # the TPU's "aligned K + C" rule refuses it; K + C = 63 fits the kernel
    pytest.param(33, 30, 1, True, id="33-30-1"),
])
def test_kernel_config_raises_as_jax(k, c, w, cuda_runs):
    """The JAX package's refusals that are the CUDA kernel's limits too
    (K * W <= 128, K + C <= 64) raise alike; its TPU-only refusal does not."""
    kw = _suite_settings("panda") | dict(samples_per_step=k, connect_segments=c,
                                         sample_window=w)
    with pytest.raises(ValueError) as ref:
        jrrtc_mega._kernel_config(jregistry.load("panda"), jrrtc.RRTCSettings(**kw), 1)
    if cuda_runs:
        got = rrtc_mega._kernel_config(registry.load("panda"), rrtc.RRTCSettings(**kw), 1)
        assert (got["KW"], got["E"]) == (33, 63) and "aligned" in str(ref.value)
        return
    with pytest.raises(ValueError) as got:
        rrtc_mega._kernel_config(registry.load("panda"), rrtc.RRTCSettings(**kw), 1)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("what", ["KW", "E", "d"])
def test_kernel_config_cuda_limits(what):
    """csrc/rrtc_mega.cu's own limits, one past each edge: K * W = 129
    (kMaxLanes 128), K + C = 65 (kMaxEdges 64), d = 17 (kMaxDim 16); at the
    edge itself the settings pass."""
    spec = registry.load("panda")
    edge, past = {
        "KW": (dict(samples_per_step=16, sample_window=8),
               dict(samples_per_step=43, sample_window=3)),
        "E": (dict(samples_per_step=56, connect_segments=8, sample_window=2),
              dict(samples_per_step=57, connect_segments=8, sample_window=2)),
        "d": ({}, {}),
    }[what]
    s_edge = rrtc.RRTCSettings(**(_suite_settings("panda") | edge))
    s_past = rrtc.RRTCSettings(**(_suite_settings("panda") | past))
    spec_edge = dataclasses.replace(spec, dimension=16) if what == "d" else spec
    spec_past = dataclasses.replace(spec, dimension=17) if what == "d" else spec
    got = rrtc_mega._kernel_config(spec_edge, s_edge, 1)
    assert {"KW": got["KW"], "E": got["E"], "d": got["d"]}[what] == {
        "KW": 128, "E": 64, "d": 16}[what]
    with pytest.raises(ValueError):
        rrtc_mega._kernel_config(spec_past, s_past, 1)


def test_kernel_config_long_edges():
    """An edge of more than 128 interpolation points: the TPU layout refused
    it (_pad_div128); the CUDA kernel has no per-edge point limit."""
    spec = registry.load("sphere")
    s = rrtc.RRTCSettings(**_wall_settings(4, 2, 2, range=50.0))
    with pytest.raises(ValueError):
        jrrtc_mega._kernel_config(jregistry.load("sphere"), jrrtc.RRTCSettings(
            **_wall_settings(4, 2, 2, range=50.0)), 1)
    assert rrtc_mega._kernel_config(spec, s, 1)["N"] > 128


def _two_goal_wall():
    """The wall problem with a second goal per row: row 0's reaches the start
    in a straight line (a direct solve), row 1's is masked out."""
    jspec, spec, envs_j, envs_t, starts, goals, masks = sphere_problem()
    second = np.tile(np.float32([-1.5, 0.5, 1.0]), (3, 1, 1))
    second[1:] = np.float32([2.0, 0.5, 2.0])
    goals = np.concatenate([goals, second], 1)
    masks = np.array([[True, True], [True, False], [True, True]])
    return jspec, spec, envs_j, envs_t, starts, goals, masks


def _assert_same_inputs(ref, got, d):
    ctl_j, nodes_j, ad_j, fd_j = (np.asarray(x) for x in ref)
    ctl, nodes, ad, fd = (x.numpy() for x in got)
    dp = max(8, 8 * ((d + 7) // 8))
    np.testing.assert_array_equal(ctl, ctl_j[:, 0])
    np.testing.assert_array_equal(ad, ad_j)
    np.testing.assert_array_equal(fd, fd_j)
    np.testing.assert_array_equal(nodes[..., :d], nodes_j[..., :d])   # configuration
    for lane in range(4):  # in_start, radius, parent, squared norm
        np.testing.assert_array_equal(nodes[..., d + lane], nodes_j[..., dp + lane], str(lane))


def test_mega_inputs_match_jax_on_the_wall():
    jspec, spec, envs_j, envs_t, starts, goals, masks = _two_goal_wall()
    kw = _wall_settings(4, 2, 2)
    ref = jrrtc_mega.mega_inputs(
        jspec, envs_j, jnp.asarray(starts), jnp.asarray(goals), jnp.asarray(masks),
        jrrtc.RRTCSettings(**kw), jnp.asarray(OFFSETS), 777)
    got = rrtc_mega.mega_inputs(
        spec, envs_t, torch.as_tensor(starts), torch.as_tensor(goals), torch.as_tensor(masks),
        rrtc.RRTCSettings(**kw), torch.as_tensor(OFFSETS), 777)
    _assert_same_inputs(ref, got, 3)
    assert got[2].tolist() == [True, False, False]
    assert got[0][:, 2].tolist() == [2, 1, 2] and got[0][:, 3].tolist() == [777] * 3


def test_mega_inputs_match_jax_on_panda_cages():
    problems = mbm.cage_suite(4, seed=3)["problems"]["cage"]
    envs_j, starts, goals, masks = jmbm.build_batch(problems)
    envs_t, st, gl, mk = mbm.build_batch(problems, device="cpu")
    np.testing.assert_array_equal(st.numpy(), np.asarray(starts))
    kw = _suite_settings("panda")
    ref = jrrtc_mega.mega_inputs(jregistry.load("panda"), envs_j, starts, goals, masks,
                                 jrrtc.RRTCSettings(**kw))
    got = rrtc_mega.mega_inputs(registry.load("panda"), envs_t, st, gl, mk,
                                rrtc.RRTCSettings(**kw))
    _assert_same_inputs(ref, got, 7)


def _plan_both(kw, starts, goals, budget=None):
    jspec, spec, envs_j, envs_t, _, _, masks = sphere_problem()
    ref = jrrtc_mega.plan_batch_mega(
        jspec, envs_j, jnp.asarray(starts), jnp.asarray(goals), jnp.asarray(masks),
        jrrtc.RRTCSettings(**kw), jnp.asarray(OFFSETS), budget=budget)
    got = rrtc_mega.plan_batch_mega(
        spec, envs_t, torch.as_tensor(starts), torch.as_tensor(goals), torch.as_tensor(masks),
        rrtc.RRTCSettings(**kw), torch.as_tensor(OFFSETS), budget=budget, device="cpu")
    return ref, got


@pytest.mark.parametrize("k,c,w", [(1, 1, 1), (4, 2, 2)])
def test_plan_batch_mega_matches_jax(k, c, w):
    _, _, _, _, starts, goals, _ = sphere_problem()
    ref, got = _plan_both(_wall_settings(k, c, w), starts, goals)
    assert bool(got.solved.any())
    assert_same_plan(ref, got, 3, rtol=1e-6)


def test_plan_batch_mega_retry_call_matches_jax():
    """run_suite's retry: the same kernel at 32x a small budget, with the
    goals of the rows the first call solved replaced by their starts."""
    _, _, _, _, starts, goals, _ = sphere_problem()
    kw = _wall_settings(4, 2, 2)
    ref, got = _plan_both(kw, starts, goals, budget=260)
    assert_same_plan(ref, got, 3, rtol=1e-6)
    unsolved = ~got.solved.numpy()
    assert unsolved.any() and not unsolved.all()
    goals2 = np.where(unsolved[:, None, None], goals, starts[:, None])
    ref, got = _plan_both(kw, starts, goals2, budget=32 * 260)
    assert_same_plan(ref, got, 3, rtol=1e-6)
    assert bool(got.solved.all())
    # solved rows became start == goal problems, closed by the direct check
    assert (got.iterations.numpy()[~unsolved] == 0).all()


def test_mega_solver_retry_of_the_live_rows_equals_the_relaunch():
    """run_suite's mega retry plans the unsolved rows alone and writes them
    back in place; a row's search does not depend on its place in the batch,
    so the result equals the earlier relaunch of every row with the solved
    rows' goals replaced by their starts.  Five wall problems: one solved
    at the first budget, three by the 32x retry, one never (its goal inside
    a wall sphere)."""
    B = 5
    b = envmod.EnvironmentBuilder()
    for y in np.linspace(-3, 3, 13):
        for z in np.linspace(0, 3, 7):
            if not (y > 2.0 and z > 2.0):
                b.add_sphere([0.0, y, z], 0.3)
    envs = envmod.broadcast_environment(b.build(device="cpu"), B)
    starts = torch.tensor([[-2.0, 0.0, 1.0]] * B) + torch.arange(B)[:, None] * 0.07
    goals = torch.tensor([[[2.0, 0.0, 1.0]]] * B) + torch.arange(B)[:, None, None] * 0.05
    goals[0, 0] = torch.tensor([-2.0, 1.0, 1.5])
    goals[2, 0] = torch.tensor([0.0, 0.0, 1.0])
    masks = torch.ones((B, 1), dtype=torch.bool)
    spec = registry.sphere_spec(lows=(-3, -3, 0), highs=(3, 3, 3), radius=0.1)
    s = rrtc.RRTCSettings(**_wall_settings(4, 2, 2, max_iterations=16))

    def plan_fn(e, s_, g, m, budget, iter_count=None, block_count=None):
        return rrtc_mega.plan_batch_mega(spec, e, s_, g, m, s, budget=budget, device="cpu")

    got = mbm._mega_solver(plan_fn, s, 32, lambda: None)(envs, starts, goals, masks)
    first = plan_fn(envs, starts, goals, masks, 16)
    um = ~first.solved
    again = plan_fn(envs, starts, torch.where(um[:, None, None], goals, starts[:, None]), masks,
                    32 * 16)
    ref = type(first)(*(torch.where(um.reshape(um.shape + (1,) * (o.dim() - 1)), n, o)
                        for o, n in zip(first, again)))
    assert first.solved.tolist() == [True, False, False, False, False]
    assert ref.solved.tolist() == [True, True, False, True, True]
    for f in ref._fields:
        assert torch.equal(getattr(got, f), getattr(ref, f)), f


@pytest.mark.parametrize("k,c,w", [(1, 1, 1), (4, 2, 2)])
def test_plan_batch_mega_interleave_matches_jax(k, c, w):
    """The interleaved cadence (grow every step, an active chain riding
    along): the port's plain version against the JAX megakernel with
    interleave=True, in interpret mode."""
    _, _, _, _, starts, goals, _ = sphere_problem()
    ref, got = _plan_both(_wall_settings(k, c, w, interleave=True), starts, goals)
    assert bool(got.solved.any())
    assert_same_plan(ref, got, 3, rtol=1e-5)


def test_plan_batch_mega_interleave_solves_with_valid_paths():
    """tests/test_mega.py's interleave checks on the port's result: every
    problem solved, every segment of every path valid."""
    _, spec, _, envs_t, starts, goals, masks = sphere_problem()
    res = rrtc_mega.plan_batch_mega(
        spec, envs_t, torch.as_tensor(starts), torch.as_tensor(goals), torch.as_tensor(masks),
        rrtc.RRTCSettings(**_wall_settings(4, 2, 2, max_iterations=2048, interleave=True)),
        device="cpu")
    assert bool(res.solved.all())
    for i in range(3):
        L = int(res.path_length[i])
        assert L >= 2
        p = res.path[i, :L]
        ok = validate.validate_motion_batch(spec, envs_t.map(lambda t: t[i : i + 1]),
                                            p[None, :-1], p[None, 1:], 64)
        assert bool(ok.all())


def test_lockstep_planner_ignores_interleave_as_jax():
    """rrtc.plan_batch keeps the alternating cadence under interleave=True,
    as the JAX lockstep planner does: both equal their interleave=False
    results and each other."""
    jspec, spec, envs_j, envs_t, starts, goals, masks = sphere_problem()
    kw = _wall_settings(4, 2, 2)
    plan_j = jax.jit(lambda e, s, g, m, o, st: jrrtc.plan_batch(jspec, e, s, g, m, st, o),
                     static_argnums=5)
    args_j = (envs_j, jnp.asarray(starts), jnp.asarray(goals), jnp.asarray(masks),
              jnp.asarray(OFFSETS))
    args_t = (spec, envs_t, torch.as_tensor(starts), torch.as_tensor(goals),
              torch.as_tensor(masks))
    ref = plan_j(*args_j, jrrtc.RRTCSettings(**kw, interleave=True))
    ref_alt = plan_j(*args_j, jrrtc.RRTCSettings(**kw))
    got = rrtc.plan_batch(*args_t, rrtc.RRTCSettings(**kw, interleave=True),
                          torch.as_tensor(OFFSETS))
    got_alt = rrtc.plan_batch(*args_t, rrtc.RRTCSettings(**kw), torch.as_tensor(OFFSETS))
    assert_same_plan(ref, got, 3, rtol=1e-6)
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(got_alt, f)), f
        np.testing.assert_array_equal(np.asarray(getattr(ref, f)), np.asarray(getattr(ref_alt, f)))


def test_finalize_mega_counts_solutions_past_the_path_buffer():
    """PAST_MAX_PATH counts the problems the kernel's scalars mark done
    whose chains together pass max_path and that no direct goal closed; the
    result counts them unsolved."""
    B, P, d = 4, 4, 2
    paths = torch.zeros((B, P, d))
    scal = torch.zeros((B, 16), dtype=torch.int32)
    scal[:, 0] = torch.tensor([1, 1, 1, 0])           # done
    scal[:, 3] = 1                                    # tree a was the start tree
    scal[:, 11] = torch.tensor([2, 3, 3, 3])          # chain lengths: totals
    scal[:, 12] = torch.tensor([2, 2, 2, 2])          # 4, 5, 5, 5
    direct = torch.tensor([False, False, True, False])
    rrtc_mega.PAST_MAX_PATH = 0
    res = rrtc_mega._finalize_mega(paths, scal, paths[:, 0], paths[:, None, -1], direct,
                                   torch.zeros(B, dtype=torch.long))
    assert rrtc_mega.PAST_MAX_PATH == 1
    assert res.solved.tolist() == [True, False, True, False]


def test_unported_planner_settings_raise():
    _, spec, _, envs_t, starts, goals, masks = sphere_problem(1)
    args = (spec, envs_t, torch.as_tensor(starts), torch.as_tensor(goals), torch.as_tensor(masks))
    base = rrtc.RRTCSettings(**_wall_settings(4, 2, 2))
    for change in (dict(profile_mask=3), dict(pc_phase=1), dict(sampler="threefry")):
        with pytest.raises(NotImplementedError):
            rrtc_mega.plan_batch_mega(*args, dataclasses.replace(base, **change), device="cpu")
    with pytest.raises(ValueError):
        rrtc_mega.plan_batch_mega(
            *args, dataclasses.replace(base, samples_per_step=32, sample_window=8), device="cpu")


@pytest.fixture(scope="module")
def planned():
    jspec, spec, envs_j, envs_t, starts, goals, masks = sphere_problem()
    settings = jrrtc.RRTCSettings(**_wall_settings(4, 2, 2, max_iterations=1024))
    pr = jax.jit(lambda e, s, g, m: jrrtc.plan_batch(jspec, e, s, g, m, settings))(
        envs_j, jnp.asarray(starts), jnp.asarray(goals), jnp.asarray(masks))
    assert bool(np.all(np.asarray(pr.solved)))
    return jspec, spec, envs_j, envs_t, np.array(pr.path), np.array(pr.path_length)


def test_simplify_batch_mega_matches_jax(planned):
    jspec, spec, envs_j, envs_t, paths, lengths = planned
    ss = simplify.SimplifySettings()
    ref = jsimplify_mega.simplify_batch_mega(
        jspec, envs_j, jnp.asarray(paths), jnp.asarray(lengths), jsimplify.SimplifySettings())
    got = simplify_mega.simplify_batch_mega(
        spec, envs_t, torch.as_tensor(paths), torch.as_tensor(lengths), ss, device="cpu")
    np.testing.assert_array_equal(got.path_length.numpy(), np.asarray(ref.path_length))
    np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(ref.iterations))
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(ref.cost), rtol=1e-5)
    for i in range(3):
        L = int(np.asarray(ref.path_length)[i])
        np.testing.assert_allclose(got.path.numpy()[i, :L], np.asarray(ref.path)[i, :L],
                                   atol=1e-5)
    assert (got.path_length.numpy() < lengths).all()


def test_simplify_batch_mega_straight_line():
    """tests/test_mega.py's straight-line case: endpoints that connect
    directly give a 2-vertex path after 0 iterations, in both packages."""
    from vamp_mvt_tpu.collision import environment as jenv

    lows, highs = (-3, -3, 0), (3, 3, 3)
    jb, tb = jenv.EnvironmentBuilder(), envmod.EnvironmentBuilder()
    jb.add_sphere([0.0, 0.0, 2.9], 0.05)
    tb.add_sphere([0.0, 0.0, 2.9], 0.05)
    envs_j = jax.tree_util.tree_map(lambda a: jnp.broadcast_to(a[None], (2,) + a.shape), jb.build())
    envs_t = envmod.broadcast_environment(tb.build(device="cpu"), 2)
    path = np.zeros((2, 16, 3), np.float32)
    path[:, 0] = [-2.0, -2.5, 1.0]
    path[:, 1] = [-1.0, -2.6, 1.2]
    path[:, 2] = [0.5, -2.7, 1.1]
    path[:, 3:] = [1.5, -2.5, 1.0]
    lengths = np.array([4, 4], np.int32)
    ref = jsimplify_mega.simplify_batch_mega(
        jregistry.sphere_spec(lows=lows, highs=highs, radius=0.1), envs_j,
        jnp.asarray(path), jnp.asarray(lengths), jsimplify.SimplifySettings())
    got = simplify_mega.simplify_batch_mega(
        registry.sphere_spec(lows=lows, highs=highs, radius=0.1), envs_t,
        torch.as_tensor(path), torch.as_tensor(lengths), simplify.SimplifySettings(),
        device="cpu")
    for f in ("path_length", "iterations"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)))
    np.testing.assert_array_equal(got.path_length.numpy(), [2, 2])
    np.testing.assert_allclose(got.path.numpy()[:, :2], np.asarray(ref.path)[:, :2])
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(ref.cost), rtol=1e-6)


def test_unported_simplify_settings_raise(planned):
    _, spec, _, envs_t, paths, lengths = planned
    for ops in (("shortcut", "reduce"), ("bspline", "shortcut"), ("shortcut",)):
        ss = simplify.SimplifySettings(operations=ops)
        assert not simplify_mega.supports(ss)
        with pytest.raises(ValueError):
            simplify_mega.simplify_batch_mega(
                spec, envs_t, torch.as_tensor(paths), torch.as_tensor(lengths), ss,
                device="cpu")
    assert simplify_mega.supports(simplify.SimplifySettings())
