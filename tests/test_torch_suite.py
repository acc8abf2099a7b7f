"""Port parity: the whole suite runner, end to end on the CPU.

The port's `run_suite(data=..., device="cpu")` on four seeded Panda-cage
problems must give the same `summary()` solved and valid counts as the JAX
package: for planner="xla" against its `run_suite`, for planner="mega" (the
megakernels' plain versions on the CPU) against its XLA planner and
simplifier composed the way its mega branch composes them.  Every simplified
path must revalidate.  The JAX runner caches assembled batches under
`CACHE_DIR`; the test points that at a temporary directory.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from vamp_mvt_tpu.bench import mbm as jmbm
from vamp_mvt_tpu.planning import rrtc as jrrtc
from vamp_mvt_tpu.planning import simplify as jsimplify
from vamp_mvt_tpu.robots import registry as jregistry
from vamp_mvt_tpu_torch.bench import mbm
from vamp_mvt_tpu_torch.planning import rrtc, rrtc_mega, simplify, simplify_mega, validate
from vamp_mvt_tpu_torch.robots import registry

torch.set_num_threads(1)

PLAN = dict(range=1.0, max_iterations=2048, max_samples=512, max_path=96,
            samples_per_step=16, connect_segments=8, sample_window=4)
SIMP = dict(pair_cap_first=512, pair_cap_rest=256, shortcut_jobs_first=8192,
            shortcut_jobs_rest=4096, bspline_jobs=2048)
# planner="mega" at 1/32 of PLAN's budget, so that the 32x retry runs
MEGA = PLAN | dict(max_iterations=PLAN["max_iterations"] // 32)


def test_run_suite_matches_jax(monkeypatch, tmp_path):
    monkeypatch.setattr(jmbm, "CACHE_DIR", tmp_path)
    data = mbm.cage_suite(4, seed=0)
    ref = jmbm.run_suite(
        "panda", data=data, planner="xla", batch_size=4, warmup=False,
        settings=jrrtc.RRTCSettings(**PLAN), simp_settings=jsimplify.SimplifySettings(**SIMP),
    )
    timings = {}
    got = mbm.run_suite(
        "panda", data=data, planner="xla", batch_size=4, warmup=False,
        settings=rrtc.RRTCSettings(**PLAN), simp_settings=simplify.SimplifySettings(**SIMP),
        timings=timings, device="cpu",
    )
    rs, gs = ref.summary(), got.summary()
    for k in ("total_problems", "valid_problems", "solved_problems"):
        assert gs[k] == rs[k], k
    assert gs["solved_problems"] == 4
    assert {"build_batch", "validity", "plan", "retry", "simplify", "gather"} <= set(timings)
    assert "Solved 4 / Valid 4 / Total 4" in got.percentile_table()

    assert _segments_ok(registry.load("panda"), data, got.simplified)


def _segments_ok(spec, data, simplified) -> bool:
    """Every simplified path is collision-free, segment by segment."""
    envs = mbm.build_batch(data["problems"]["cage"], device="cpu")[0]
    paths = torch.as_tensor(simplified.path)
    num = validate.n_points_bound(
        spec, float(np.linalg.norm(spec.limits_high - spec.limits_low))
    )
    ok = validate.validate_motion_batch(spec, envs, paths[:, :-1], paths[:, 1:], num)
    k = torch.arange(1, paths.shape[1])
    return bool((ok | (k[None] >= torch.as_tensor(simplified.path_length)[:, None])).all())


def test_run_suite_mega_matches_jax_composition(monkeypatch, tmp_path):
    """run_suite(planner="mega") on the CPU (the megakernels' plain versions)
    against the JAX package's XLA functions composed the way its mega branch
    composes them: plan at the budget, replan at 32x the budget with the
    solved rows' goals replaced by their starts, merge on the unsolved mask,
    simplify.  The budget is 1/32 of PLAN's, so the retry runs at PLAN's
    settings (which the test above has already compiled in the JAX package).
    The planner's and the simplifier's results must match exactly in counts
    and path lengths, with costs within rtol 1e-5 and simplified paths within
    atol 1e-5."""
    data = mbm.cage_suite(4, seed=0)
    spec, jspec = registry.load("panda"), jregistry.load("panda")
    envs, starts, goals, masks = jmbm.build_batch(data["problems"]["cage"])
    pr = jrrtc.plan_batch_compact(jspec, envs, starts, goals, masks,
                                  jrrtc.RRTCSettings(**MEGA), segment_steps=64)
    unsolved = ~np.asarray(pr.solved)
    assert unsolved.any()
    rr = jrrtc.plan_batch_compact(
        jspec, envs, starts, jnp.where(unsolved[:, None, None], goals, starts[:, None]), masks,
        jrrtc.RRTCSettings(**PLAN), segment_steps=64)
    pr = jax.tree_util.tree_map(
        lambda o, n: np.where(unsolved.reshape((-1,) + (1,) * (np.ndim(o) - 1)), n, o), pr, rr)
    # the JAX lockstep simplifier with pair and job caps that cannot bind on
    # these paths (the rule of the port's cap-free plain version), since the
    # megakernel checks every candidate exactly
    pairs, jobs, bspline = simplify_mega._caps(
        spec, torch.as_tensor(np.asarray(pr.path)), torch.as_tensor(np.asarray(pr.path_length)),
        simplify.SimplifySettings(**SIMP))
    ref = jsimplify.simplify_batch_compact(
        jspec, envs, jnp.asarray(pr.path), jnp.asarray(pr.path_length),
        jsimplify.SimplifySettings(**SIMP | dict(
            pair_cap_first=pairs, pair_cap_rest=pairs, shortcut_jobs_first=jobs,
            shortcut_jobs_rest=jobs, bspline_jobs=bspline)))

    timings = {}
    got = mbm.run_suite(
        "panda", data=data, planner="mega", batch_size=4, warmup=False,
        settings=rrtc.RRTCSettings(**MEGA), simp_settings=simplify.SimplifySettings(**SIMP),
        timings=timings, device="cpu",
    )
    assert got.summary()["solved_problems"] == got.summary()["valid_problems"] == 4
    for f in ("solved", "iterations", "size_start", "size_goal", "path_length"):
        np.testing.assert_array_equal(getattr(got.plan, f), np.asarray(getattr(pr, f)), f)
    np.testing.assert_allclose(got.plan.cost, np.asarray(pr.cost), rtol=1e-5)
    np.testing.assert_array_equal(got.simplified.path_length, np.asarray(ref.path_length))
    np.testing.assert_allclose(got.simplified.cost, np.asarray(ref.cost), rtol=1e-5)
    for i in range(4):
        L = int(np.asarray(ref.path_length)[i])
        np.testing.assert_allclose(got.simplified.path[i, :L], np.asarray(ref.path)[i, :L],
                                   atol=1e-5)
    assert {"plan", "retry", "simplify"} <= set(timings)
    assert _segments_ok(spec, data, got.simplified)


def test_run_suite_without_device_needs_gpu_or_raises():
    with pytest.raises(ValueError, match="unknown planner"):
        mbm.run_suite("panda", data=mbm.cage_suite(1), planner="pallas", device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    for planner in ("auto", "mega", "xla"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mbm.run_suite("panda", data=mbm.cage_suite(1), batch_size=1, planner=planner)


def test_auto_planner_is_xla_on_the_cpu(monkeypatch):
    """planner="auto" resolves to the lockstep configuration on a CPU device
    (and to the megakernels on a CUDA one)."""
    seen = []
    monkeypatch.setattr(rrtc, "plan_batch_compact",
                        lambda *a, **k: seen.append("xla") or _stop())
    monkeypatch.setattr(rrtc_mega, "plan_batch_mega",
                        lambda *a, **k: seen.append("mega") or _stop())
    with pytest.raises(_Stop):
        mbm.run_suite("panda", data=mbm.cage_suite(1), batch_size=1, warmup=False,
                      device="cpu")
    assert seen == ["xla"]


class _Stop(Exception):
    pass


def _stop():
    raise _Stop


def test_run_suite_mega_refuses_a_retry_without_room():
    """A problem that filled the node buffer within the first budget would
    replay the same search in the 32x retry and fill it again: run_suite
    raises instead of returning that replay as a retry."""
    small = rrtc.RRTCSettings(**(PLAN | dict(max_samples=24)))
    with pytest.raises(ValueError, match="max_samples=24 cannot hold the 32x retry"):
        mbm.run_suite("panda", data=mbm.cage_suite(1), planner="mega", batch_size=1,
                      warmup=False, settings=small, device="cpu")
