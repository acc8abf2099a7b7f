"""Port parity: `run_suite` on the other robots (UR5, Fetch, Baxter).

`default_settings(robot, planner)` must be the settings the JAX package's
`run_suite` plans with for that robot (its range from RRT_RANGES, K = 32 and
W = 4 on Fetch); the JAX side's are captured at its planner call.  Then
`run_suite("ur5", planner="xla", device="cpu")` against the JAX package's on
three seeded MBM-shaped scenes: the same valid and solved flags and
iterations, planner costs and simplified costs within rtol 1e-5.  And
`run_suite("fetch", planner="xla", device="cpu")` on problems drawn as the
benchmark's `fetch_prim_suite` cell draws them, judged by the benchmark's
plain float64 reference (`planbench/reference/check.py`) as that cell's
runs are, and the same answers with a vertex in self-contact planted not.

The JAX package memoizes robot tables and compiled planners by `id(spec)`
without keeping the spec alive, so a spec freed earlier in the same process
(a test's `sphere_spec()`) can leave an entry that a later spec allocated at
its address picks up: the reference then plans with another robot's
self-collision thresholds.  `_fresh_jax_caches` gives every test here empty
caches, so the reference result does not depend on which tests ran before
it in the worker.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from vamp_mvt_tpu import api as japi
from vamp_mvt_tpu.bench import mbm as jmbm
from vamp_mvt_tpu.ops import fkcc as jfkcc
from vamp_mvt_tpu.ops.kernels import fkcc_pallas as jfkcc_pallas
from vamp_mvt_tpu.planning import rrtc as jrrtc
from vamp_mvt_tpu.planning import rrtc_mega as jrrtc_mega
from vamp_mvt_tpu.planning import simplify as jsimplify
from vamp_mvt_tpu.planning import simplify_mega as jsimplify_mega
from planbench import faults, generator, harness
from planbench.reference import check, geometry
from planbench.reference import robot as ref_robot
from vamp_mvt_tpu_torch.bench import mbm, scenes
from vamp_mvt_tpu_torch.ops.kernels import fkcc_cuda
from vamp_mvt_tpu_torch.planning import rrtc, simplify
from vamp_mvt_tpu_torch.robots import registry

torch.set_num_threads(1)


# the JAX package's caches keyed by id(spec) (module, attribute)
_JAX_ID_CACHES = (
    (jfkcc, "_THRESH_CACHE"), (jfkcc_pallas, "_STAB_CACHE"), (jfkcc_pallas, "_VMAP_CACHE"),
    (jfkcc_pallas, "_VMAP_LANES_CACHE"), (jrrtc, "_COMPACT_CACHE"),
    (jsimplify, "_COMPACT_CACHE"), (jsimplify_mega, "_RUN_CACHE"), (japi, "_JIT_CACHE"),
    (jmbm, "_FN_CACHE"),
)


@pytest.fixture(autouse=True)
def _fresh_jax_caches(monkeypatch):
    for mod, name in _JAX_ID_CACHES:
        monkeypatch.setattr(mod, name, {})


class _Stop(Exception):
    pass


@pytest.mark.parametrize("planner", ["mega", "xla"])
@pytest.mark.parametrize("robot", ["ur5", "fetch", "baxter"])
def test_default_settings_match_jax(robot, planner, monkeypatch, tmp_path):
    seen = {}

    def capture(spec, envs, starts, goals, masks, settings, *args, **kw):
        seen["settings"] = settings
        raise _Stop

    if planner == "mega":
        monkeypatch.setattr(jrrtc_mega, "plan_batch_mega", capture)
    else:
        monkeypatch.setattr(jrrtc, "plan_batch_compact", capture)
    monkeypatch.setattr(jmbm, "CACHE_DIR", tmp_path)
    d = registry.load(robot).dimension
    data = {"problems": {"p": [{"problem": "p", "index": 0, "sphere": [], "cylinder": [],
                                "box": [], "start": [0.0] * d, "goals": [[0.1] * d]}]}}
    with pytest.raises(_Stop):
        jmbm.run_suite(robot, data=data, planner=planner, batch_size=1, warmup=False)
    want = seen["settings"]
    got = mbm.default_settings(robot, planner)
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.range == registry.RRT_RANGES[robot]
    if planner == "mega":
        assert (got.samples_per_step, got.sample_window) == ((32, 4) if robot == "fetch"
                                                             else (16, 8))


def _ur5_problems(seed=5, rows=(6, 7, 8)):
    """Scenes `rows` of 12 seeded MBM-shaped scenes, start and goal the first
    two of 256 seeded UR5 configurations valid there.  The first pass solves
    all three (0, 32 and 64 samples), so neither package enters the 32x
    straggler retry, which is slow on the CPU."""
    spec = registry.load("ur5")
    drawn = scenes.mbm_shaped_problems(12, seed)
    q = scenes.seeded_configs(spec, len(drawn), 256, seed)
    ok = fkcc_cuda.fkcc_batched(spec, mbm.build_batch(drawn, device="cpu")[0], q)
    valid, st, gl, _ = scenes.first_two_valid(q, ok)
    assert set(rows) <= set(valid)
    out = [dict(drawn[i], index=k, start=st[valid.index(i)].tolist(),
                goals=gl[valid.index(i)].tolist()) for k, i in enumerate(rows)]
    return {"problems": {"mbm_shaped": out}}


def test_run_suite_ur5_matches_jax(monkeypatch, tmp_path):
    monkeypatch.setattr(jmbm, "CACHE_DIR", tmp_path)
    data = _ur5_problems()
    plan = dict(range=1.5, max_iterations=1024, max_samples=512, max_path=96,
                samples_per_step=16, connect_segments=8, sample_window=4)
    simp = dict(pair_cap_first=512, pair_cap_rest=256, shortcut_jobs_first=8192,
                shortcut_jobs_rest=4096, bspline_jobs=2048)
    ref = jmbm.run_suite("ur5", data=data, planner="xla", batch_size=3, warmup=False,
                         settings=jrrtc.RRTCSettings(**plan),
                         simp_settings=jsimplify.SimplifySettings(**simp))
    got = mbm.run_suite("ur5", data=data, planner="xla", batch_size=3, warmup=False,
                        settings=rrtc.RRTCSettings(**plan),
                        simp_settings=simplify.SimplifySettings(**simp), device="cpu")
    rs, gs = ref.summary(), got.summary()
    for k in ("total_problems", "valid_problems", "solved_problems"):
        assert gs[k] == rs[k], k
    assert gs["solved_problems"] == 3
    assert int(np.max(got.plan.iterations)) > 0
    np.testing.assert_array_equal(got.valid, ref.valid)
    np.testing.assert_array_equal(got.plan.solved, np.asarray(ref.plan.solved))
    np.testing.assert_array_equal(got.plan.iterations, np.asarray(ref.plan.iterations))
    solved = np.asarray(ref.plan.solved)
    np.testing.assert_allclose(got.plan.cost[solved], np.asarray(ref.plan.cost)[solved],
                               rtol=1e-5)
    np.testing.assert_allclose(got.simplified.cost[solved],
                               np.asarray(ref.simplified.cost)[solved], rtol=1e-5)


def test_seeded_scenes_and_first_two_valid():
    """The seeded scenes and configurations grow by appending (a larger draw
    keeps the smaller one's rows), and first_two_valid keeps the first
    `keep` problems with two valid configurations, in order."""
    spec = registry.load("fetch")
    assert scenes.mbm_shaped_problems(3, 10) == scenes.mbm_shaped_problems(5, 10)[:3]
    q = scenes.seeded_configs(spec, 5, 4, seed=20)
    assert q.shape == (5, 4, 8) and q.dtype == torch.float32
    torch.testing.assert_close(q[:2], scenes.seeded_configs(spec, 2, 4, seed=20), rtol=0, atol=0)
    ok = torch.tensor([[1, 0, 0, 1], [1, 0, 0, 0], [0, 1, 1, 1], [1, 1, 0, 0], [1, 1, 1, 1]],
                      dtype=torch.bool)
    rows, st, gl, mk = scenes.first_two_valid(q, ok, keep=2)
    assert rows == [0, 2]
    assert torch.equal(st, torch.stack([q[0, 0], q[2, 1]]))
    assert torch.equal(gl, torch.stack([q[0, 3], q[2, 2]])[:, None])
    assert mk.shape == (2, 1) and bool(mk.all())
    assert scenes.first_two_valid(q, ok)[0] == [0, 2, 3, 4]


# Limits of the reference check, as the cell's (planbench/cells/
# fetch_prim_suite.json): a state the port calls free may read below zero
# in float64 only by float32 rounding of FK and distances near contact
# (~1e-9 m^2 on the card), far under 1e-5, which bfloat16 FK exceeds; a
# reported cost is a float32 sum of at most 96 segment lengths, relative
# error ~1e-7, far under 1e-4, which a bfloat16 sum exceeds.
VERDICT_GAP_M2 = 1e-5
COST_REL_GAP = 1e-4


@pytest.fixture(scope="module")
def fetch_suite():
    """The first 4 problems drawn as the `fetch_prim_suite` cell draws them
    (its configuration's scene box; no goal in contact), planned by
    run_suite("fetch", planner="xla") on the CPU at a cut budget (256
    samples, K = 8, C = 4: the plain FK over 8 joints, 111 spheres and
    2,586 pairs costs ~0.15 s a lockstep step a problem here) and without
    the straggler retry (32x the budget at 16,384 nodes, many minutes on
    the CPU), so a problem the first pass leaves unsolved stays unsolved
    and is judged on its validity verdict alone; the simplifier's job lists
    are cut too (a candidate past them is never taken, so the cut leaves
    fewer shortcuts, never an unchecked one)."""
    cell = harness.Cell("fetch_prim_suite")
    robot = ref_robot.load("fetch")
    pool = generator.pool(robot, dict(cell.traffic, problems=4, pool=1, invalid=0),
                          cell.config, 2**31 + 29, "cpu")[0]
    data, probs = generator.as_suite(pool, "fetch")
    s = dataclasses.replace(mbm.default_settings("fetch", "xla"), max_iterations=256,
                            samples_per_step=8, connect_segments=4)
    simp = simplify.SimplifySettings(pair_cap_first=64, pair_cap_rest=32,
                                     shortcut_jobs_first=1024, shortcut_jobs_rest=512,
                                     bspline_jobs=512)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mbm, "_lockstep_solver", lambda plan_fn, *a, **kw: plan_fn)
        res = mbm.run_suite("fetch", data=data, planner="xla", batch_size=len(probs),
                            warmup=False, settings=s, simp_settings=simp, device="cpu")
    return robot, res, probs


def _judge(robot, res, plan, probs):
    """Every validity verdict, every state of each returned path (`plan`'s
    and the simplified one, joined to the problem's endpoints) and each
    path's cost, by the plain reference in float64, as the cell's runs are
    judged (`drivers/suite.py::add_answer`)."""
    suite = harness.load_module(harness.PLANBENCH / "drivers" / "suite.py", "suite_driver")
    answer = types.SimpleNamespace(plan=plan, simplified=res.simplified)
    dec = check.Decisions(robot.dimension)
    for r, p in enumerate(probs):
        suite.add_answer(dec, r, p, answer, r, res.valid[r], res.valid[r] and plan.solved[r],
                         robot.resolution)
    return check.judge(robot, dec, ("obstacles", [geometry.obstacles(p) for p in probs]), "cpu")


@pytest.mark.parametrize("fault", [None, "altered_vertex"])
def test_run_suite_fetch_against_the_reference(fetch_suite, fault):
    """The port's Fetch suite answers pass the reference's check; with each
    planned path's first vertex replaced by a Fetch configuration in
    self-contact (the fault `faults.planted` plants where the runner
    gathers the planner's result) they fail it."""
    robot, res, probs = fetch_suite
    solved = np.asarray(res.plan.solved)
    assert bool(res.valid.all()) and solved.any()
    assert int(np.max(res.plan.iterations)) > 0 and int(np.max(res.plan.path_length)) > 2
    plan = res.plan if fault is None else faults.FAULTS[fault](robot)(res.plan)
    v = _judge(robot, res, plan, probs)
    assert v["problems_classified"] == len(probs) and v["wrong_valid"] == 0
    if fault is None:
        assert v["verdict_gap_m2"] <= VERDICT_GAP_M2, v
        assert v["cost_rel_gap"] <= COST_REL_GAP, v
    else:
        assert v["verdict_gap_m2"] > VERDICT_GAP_M2 and v["wrong_states"] >= solved.sum(), v
