"""Port parity: AORRTC (`planning/aorrtc.py`) on the CPU.

The AORRTC cases of tests/test_planners.py (the sphere robot's wall with a
gap; AOX alone in tests/test_torch_aox.py) run through both packages with
the same inputs, at budgets cut to keep the file short (one to two
refinement rounds).  Every random stream is
`jax.random`'s bit for bit (`sampling/threefry.py`), so where the arithmetic
agrees the searches agree exactly: solved flags, iterations, sample counts
and tree sizes equal, costs and cost histories within rtol 1e-5, paths
within atol 1e-5.  That holds without PHS sampling, and with it on these
cases: `phs_samples`' float32 `log` and `pow` differ from XLA's by up to
4.8e-7 here (tests/test_torch_phs.py), and no PHS sample of these runs lands
where that changes a tree.
"""

import numpy as np
import pytest
import torch

from vamp_mvt_tpu.collision import environment as jenvmod
from vamp_mvt_tpu.planning import aorrtc as jaorrtc
from vamp_mvt_tpu.planning import rrtc as jrrtc
from vamp_mvt_tpu.robots import registry as jregistry
from vamp_mvt_tpu_torch.collision import environment as envmod
from vamp_mvt_tpu_torch.planning import aorrtc, rrtc, validate
from vamp_mvt_tpu_torch.robots import registry

from test_torch_planner import sphere_problem
from test_torch_suite_robots import _JAX_ID_CACHES

torch.set_num_threads(1)

CPU = "cpu"
START, GOAL = [-2.0, 0.0, 1.0], [[2.0, 0.0, 1.0]]
WALL = dict(lows=(-3, -3, 0), highs=(3, 3, 3), radius=0.1)
BASE = dict(range=1.0, max_iterations=512, max_samples=512, max_path=64)


@pytest.fixture(autouse=True)
def _fresh_jax_caches(monkeypatch):
    """The JAX package keys compiled functions and robot tables by id(spec):
    a sphere spec freed by an earlier test may hand its entries on."""
    for mod, name in _JAX_ID_CACHES:
        monkeypatch.setattr(mod, name, {})


def _wall(mod):
    b = mod.EnvironmentBuilder()
    for y in np.linspace(-3, 3, 13):
        for z in np.linspace(0, 3, 7):
            if y > 2.0 and z > 2.0:
                continue
            b.add_sphere([0.0, y, z], 0.3)
    return b.build(device=CPU) if mod is envmod else b.build()


def _problem():
    return (registry.sphere_spec(**WALL), _wall(envmod), jregistry.sphere_spec(**WALL),
            _wall(jenvmod))


def _settings(mod, rrtc_mod, **kw):
    return mod.AORRTCSettings(rrtc=rrtc_mod.RRTCSettings(**BASE), **kw)


def _valid_segments(spec, env, path) -> bool:
    num = validate.n_points_bound(spec, float(np.linalg.norm(spec.limits_high - spec.limits_low)))
    p = torch.as_tensor(np.asarray(path, np.float32))
    return bool(validate.validate_motion_batch(
        spec, env.map(lambda t: t[None]), p[None, :-1], p[None, 1:], num).all())


def _same_simplified(got, ref):
    L = int(np.asarray(ref.path_length))
    assert int(got.path_length) == L
    np.testing.assert_allclose(float(got.cost), float(ref.cost), rtol=1e-5)
    np.testing.assert_allclose(got.path.numpy()[:L], np.asarray(ref.path)[:L], atol=1e-5)


def _same_search(got, ref):
    for f in ("solved", "iterations", "size_start", "size_goal", "sample_count",
              "path_length"):
        assert int(getattr(got, f)) == int(np.asarray(getattr(ref, f))), f
    if bool(ref.solved):
        np.testing.assert_allclose(float(got.cost), float(ref.cost), rtol=1e-5)
        L = int(ref.path_length)
        np.testing.assert_allclose(got.path.numpy()[:L], np.asarray(ref.path)[:L], atol=1e-5)


@pytest.mark.parametrize("use_phs", [False, True])
def test_aorrtc_improves_over_rrtc(use_phs):
    spec, env, jspec, jenv = _problem()
    r0 = rrtc.plan(spec, env, torch.tensor(START), torch.tensor(GOAL), torch.ones(1, dtype=torch.bool),
                   rrtc.RRTCSettings(**BASE))
    assert bool(r0.solved)
    kw = dict(max_iterations=1024, max_internal_iterations=256, use_phs=use_phs)
    res, iters = aorrtc.solve(spec, env, START, GOAL, _settings(aorrtc, rrtc, **kw), device=CPU)
    ref, jiters = jaorrtc.solve(jspec, jenv, START, GOAL, _settings(jaorrtc, jrrtc, **kw))
    assert iters == jiters
    _same_simplified(res, ref)
    assert float(res.cost) <= float(r0.cost) + 1e-5
    assert _valid_segments(spec, env, res.path.numpy()[: int(res.path_length)])


@pytest.mark.parametrize("anytime", [False, True])
def test_aorrtc_aox_mode(anytime):
    """AOX refinement (the reference default) and the anytime mode's fresh
    RRT-Connect searches over the PHS."""
    spec, env, jspec, jenv = _problem()
    kw = dict(max_iterations=1024, max_internal_iterations=256, anytime=anytime)
    res, iters = aorrtc.solve(spec, env, START, GOAL, _settings(aorrtc, rrtc, **kw), device=CPU)
    ref, jiters = jaorrtc.solve(jspec, jenv, START, GOAL, _settings(jaorrtc, jrrtc, **kw))
    assert iters == jiters
    _same_simplified(res, ref)
    assert _valid_segments(spec, env, res.path.numpy()[: int(res.path_length)])
    assert float(res.cost) < 12.0


@pytest.mark.parametrize("use_phs", [False, True])
def test_aorrtc_solve_batch_converges(use_phs):
    """Batched AORRTC: rounds of lockstep AOX searches with per-problem cost
    carries; the result, the samples and the cost history equal the JAX
    package's, the history is monotone and every final path validates."""
    jspec, spec, envs_j, envs_t, starts, goals, masks = sphere_problem(3)
    kw = dict(max_iterations=1024, max_internal_iterations=256, anytime=False, use_phs=use_phs)
    res, samples, hist = aorrtc.solve_batch(spec, envs_t, starts, goals, masks,
                                            _settings(aorrtc, rrtc, **kw), history=True,
                                            device=CPU)
    ref, jsamples, jhist = jaorrtc.solve_batch(jspec, envs_j, starts, goals, masks,
                                               _settings(jaorrtc, jrrtc, **kw), history=True)
    np.testing.assert_array_equal(samples.numpy(), np.asarray(jsamples))
    np.testing.assert_array_equal(res.path_length.numpy(), np.asarray(ref.path_length))
    assert hist.shape == jhist.shape
    np.testing.assert_allclose(hist, jhist, rtol=1e-5)
    np.testing.assert_allclose(res.cost.numpy(), np.asarray(ref.cost), rtol=1e-5)
    costs = res.cost.numpy()
    assert np.isfinite(costs).any()
    assert (np.diff(hist, axis=0) <= 1e-5).all()
    for i in range(3):
        if not np.isfinite(costs[i]):
            continue
        L = int(res.path_length[i])
        np.testing.assert_allclose(res.path.numpy()[i, :L], np.asarray(ref.path)[i, :L],
                                   atol=1e-5)
        assert _valid_segments(spec, envs_t.map(lambda t: t[i]), res.path.numpy()[i, :L])
        lb = float(np.linalg.norm(goals[i, 0] - starts[i]))
        assert costs[i] >= lb - 1e-4
