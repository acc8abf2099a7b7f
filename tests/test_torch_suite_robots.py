"""Port parity: `run_suite` on the other robots (UR5, Fetch, Baxter).

`default_settings(robot, planner)` must be the settings the JAX package's
`run_suite` plans with for that robot (its range from RRT_RANGES, K = 32 and
W = 4 on Fetch); the JAX side's are captured at its planner call.  Then
`run_suite("ur5", planner="xla", device="cpu")` against the JAX package's on
three seeded MBM-shaped scenes: the same valid and solved flags and
iterations, planner costs and simplified costs within rtol 1e-5.

The JAX package memoizes robot tables and compiled planners by `id(spec)`
without keeping the spec alive, so a spec freed earlier in the same process
(a test's `sphere_spec()`) can leave an entry that a later spec allocated at
its address picks up: the reference then plans with another robot's
self-collision thresholds.  `_fresh_jax_caches` gives every test here empty
caches, so the reference result does not depend on which tests ran before
it in the worker.
"""

import dataclasses

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
