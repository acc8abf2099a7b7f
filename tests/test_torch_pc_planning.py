"""Port parity: planning and simplifying against pointclouds.

- `plan_batch_mega(device="cpu")` (the plain version: the lockstep planner
  on `pc_vmin_plain`) against the JAX package's planner megakernel in Pallas
  interpret mode, on tests/test_kernel_branches.py's pck wall: its problem
  (a straight line through the gap) and one whose start and goal sit low on
  either side of the wall.  Solved, iterations, tree sizes and path lengths
  equal, costs within rtol 1e-6, paths within 1e-6.
- `simplify_batch_mega(device="cpu")` against the JAX simplify megakernel on
  those paths: path lengths and iterations equal, costs within rtol 1e-5.
- The whole slice: `run_suite_pointcloud(device="cpu")` (the lockstep path on
  batched CAPT structures) against the JAX package's `run_suite_pointcloud`
  on the CPU, on two problems of the upper ring of the Panda cage
  expressed as boxes: validity, solved, iterations and path lengths equal,
  simplified costs within rtol 1e-5; and the node-buffer guard of its retry.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from vamp_mvt_tpu.bench import mbm as jmbm
from vamp_mvt_tpu.collision import environment as jenvmod
from vamp_mvt_tpu.collision.pc_kernel import radius_classes as jradius_classes
from vamp_mvt_tpu.planning import rrtc as jrrtc
from vamp_mvt_tpu.planning import rrtc_mega as jrrtc_mega
from vamp_mvt_tpu.planning import simplify as jsimplify
from vamp_mvt_tpu.planning import simplify_mega as jsimplify_mega
from vamp_mvt_tpu.robots import registry as jregistry
from vamp_mvt_tpu_torch.bench import mbm
from vamp_mvt_tpu_torch.collision import environment as envmod
from vamp_mvt_tpu_torch.collision import pc_kernel
from vamp_mvt_tpu_torch.planning import rrtc, rrtc_mega, simplify, simplify_mega
from vamp_mvt_tpu_torch.robots import registry

from test_torch_pc_fkcc import R_POINT, WMAX, WMIN, wall_points
from test_torch_planner import assert_same_plan

torch.set_num_threads(1)

B = 2
OFFSETS = np.arange(B, dtype=np.int32) * 100
ROUTES = {  # start, goal of problem 0 (problem 1's goal is 0.1 further along)
    "gap": ([-2.0, 0.0, 2.6], [2.0, 0.0, 2.6]),
    "around": ([-2.0, 1.5, 1.0], [2.0, -1.5, 1.0]),
}
SETTINGS = dict(range=1.0, max_iterations=256, max_samples=256, max_path=64,
                samples_per_step=4, connect_segments=2, sample_window=2)


def pck_wall(route):
    """Both packages' environments with the wall as the kernel form, and the
    problem of `route`.  The JAX package's also holds the wall as MVT, as its
    kernel-branch tests build it: its plain path (the direct check on the
    CPU) reads MVT, its kernel reads pck."""
    jspec = jregistry.sphere_spec(lows=WMIN, highs=WMAX, radius=0.25)
    spec = registry.sphere_spec(lows=WMIN, highs=WMAX, radius=0.25)
    pts = wall_points()
    jb = jenvmod.EnvironmentBuilder()
    jb.add_mvt_pointcloud(pts, 0.25, 0.25, WMIN, WMAX, R_POINT)
    jb.add_kernel_pointcloud(pts, jradius_classes(jspec.sphere_radius), WMIN, WMAX, R_POINT,
                             0.25)
    envs_j = jax.tree_util.tree_map(lambda a: jnp.broadcast_to(a[None], (B,) + a.shape),
                                    jb.build())
    tb = envmod.EnvironmentBuilder()
    tb.add_kernel_pointcloud(pts, pc_kernel.radius_classes(spec.sphere_radius), WMIN, WMAX,
                             R_POINT, 0.25)
    envs_t = envmod.broadcast_environment(tb.build(device="cpu"), B)
    start, goal = ROUTES[route]
    starts = np.tile(np.float32(start), (B, 1))
    goals = np.tile(np.float32(goal), (B, 1, 1)) + (
        np.arange(B, dtype=np.float32)[:, None, None] * np.float32(0.1))
    return jspec, spec, envs_j, envs_t, starts, goals, np.ones((B, 1), bool)


def plan_both(route):
    jspec, spec, envs_j, envs_t, starts, goals, masks = pck_wall(route)
    ref = jrrtc_mega.plan_batch_mega(
        jspec, envs_j, jnp.asarray(starts), jnp.asarray(goals), jnp.asarray(masks),
        jrrtc.RRTCSettings(**SETTINGS), jnp.asarray(OFFSETS))
    got = rrtc_mega.plan_batch_mega(
        spec, envs_t, torch.as_tensor(starts), torch.as_tensor(goals), torch.as_tensor(masks),
        rrtc.RRTCSettings(**SETTINGS), torch.as_tensor(OFFSETS), device="cpu")
    return ref, got


@pytest.fixture(scope="module")
def around():
    return plan_both("around")


def test_plan_batch_mega_pck_gap():
    ref, got = plan_both("gap")
    assert bool(got.solved.all())
    assert_same_plan(ref, got, B, rtol=1e-6)


def test_plan_batch_mega_pck_around(around):
    ref, got = around
    assert bool(got.solved.all()) and bool((got.iterations > 0).all())
    assert_same_plan(ref, got, B, rtol=1e-6)


def test_simplify_batch_mega_pck(around):
    _, got = around
    jspec, spec, envs_j, envs_t, _, _, _ = pck_wall("around")
    paths, lengths = got.path.numpy(), got.path_length.numpy()
    assert (lengths > 2).all()
    ref = jsimplify_mega.simplify_batch_mega(
        jspec, envs_j, jnp.asarray(paths), jnp.asarray(lengths), jsimplify.SimplifySettings())
    out = simplify_mega.simplify_batch_mega(
        spec, envs_t, torch.as_tensor(paths), torch.as_tensor(lengths),
        simplify.SimplifySettings(), device="cpu")
    np.testing.assert_array_equal(out.path_length.numpy(), np.asarray(ref.path_length))
    np.testing.assert_array_equal(out.iterations.numpy(), np.asarray(ref.iterations))
    np.testing.assert_allclose(out.cost.numpy(), np.asarray(ref.cost), rtol=1e-5)
    assert (out.path_length.numpy() < lengths).all()


CAGE = [
    [0.55, 0, 0.25], [0.35, 0.35, 0.25], [0, 0.55, 0.25], [-0.55, 0, 0.25],
    [-0.35, -0.35, 0.25], [0, -0.55, 0.25], [0.35, -0.35, 0.25],
    [0.35, 0.35, 0.8], [0, 0.55, 0.8], [-0.35, 0.35, 0.8], [-0.55, 0, 0.8],
    [-0.35, -0.35, 0.8], [0, -0.55, 0.8], [0.35, -0.35, 0.8],
]
PANDA_START = [0.0, -0.785, 0.0, -2.356, 0.0, 1.571, 0.785]
PANDA_GOAL = [2.35, 1.0, 0.0, -0.8, 0.0, 2.5, 0.785]


def cage_box_suite(n, seed, cage=CAGE):
    """tests/test_pointcloud_planning.py's cage of boxes, n copies with every
    box moved by up to 0.01."""
    rng = np.random.default_rng(seed)
    problems = []
    for i in range(n):
        boxes = [{"position": (np.asarray(c) + rng.uniform(-0.01, 0.01, 3)).tolist(),
                  "orientation_quat_xyzw": [0, 0, 0, 1], "half_extents": [0.14, 0.14, 0.14]}
                 for c in cage]
        problems.append({"problem": "cage", "index": i, "sphere": [], "cylinder": [],
                         "box": boxes, "start": PANDA_START, "goals": [PANDA_GOAL]})
    return {"problems": {"cage": problems}}


SUITE_SETTINGS = dict(range=registry.RRT_RANGES.get("panda", 1.0), max_iterations=512,
                      max_samples=1024, max_path=64, samples_per_step=4, connect_segments=4,
                      sample_window=2)


def test_run_suite_pointcloud_matches_jax():
    data = cage_box_suite(2, seed=0, cage=CAGE[7:])
    kw = SUITE_SETTINGS
    common = dict(pc_repr="capt", filter_type="scdf", batch_size=2, samples_per_object=600,
                  warmup=False, data=data)
    ref, ref_t = jmbm.run_suite_pointcloud(
        "panda", settings=jrrtc.RRTCSettings(**kw),
        simp_settings=jsimplify.SimplifySettings(pair_chunk=64), **common)
    got, got_t = mbm.run_suite_pointcloud(
        "panda", settings=rrtc.RRTCSettings(**kw),
        simp_settings=simplify.SimplifySettings(pair_chunk=64), device="cpu", **common)
    np.testing.assert_array_equal(got.valid, ref.valid)
    assert got.valid.all()
    for f in ("solved", "iterations", "size_start", "size_goal", "path_length"):
        np.testing.assert_array_equal(np.asarray(getattr(got.plan, f)),
                                      np.asarray(getattr(ref.plan, f)), f)
    assert np.asarray(got.plan.solved).any()
    np.testing.assert_array_equal(np.asarray(got.simplified.path_length),
                                  np.asarray(ref.simplified.path_length))
    np.testing.assert_allclose(np.asarray(got.simplified.cost),
                               np.asarray(ref.simplified.cost), rtol=1e-5)
    assert got.summary()["solved_problems"] == ref.summary()["solved_problems"]
    for k in ("pc_repr", "filter_type"):
        assert got_t[k] == ref_t[k]
    assert got_t["filter_ns"].shape == ref_t["filter_ns"].shape == (2,)
    assert (got_t["filter_ns"] > 0).all() and (got_t["build_ns"] > 0).all()
    assert {"pointcloud", "validity", "plan", "simplify", "gather"} <= set(got_t["phases"])


def test_run_suite_pointcloud_refuses_a_full_retry():
    """A problem left unsolved with a full node buffer would fill it again in
    the 16x retry: the suite refuses it (raise max_samples)."""
    kw = SUITE_SETTINGS | dict(max_iterations=64, max_samples=16)
    with pytest.raises(ValueError, match="max_samples=16 cannot hold the 16x retry"):
        mbm.run_suite_pointcloud("panda", settings=rrtc.RRTCSettings(**kw), batch_size=1,
                                 samples_per_object=300, warmup=False, device="cpu",
                                 data=cage_box_suite(1, seed=1))
