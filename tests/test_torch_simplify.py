"""Port parity: path simplification (simplify_batch, simplify_batch_compact).

The sphere-robot wall problem's planned paths (planned once by the JAX
planner, then handed to both packages as the same numpy arrays) are
simplified by the JAX package and by the port: path lengths must be equal,
costs within rtol 1e-5 and paths within atol 1e-5 (the B-spline pulls
accumulate float32 rounding that the two packages order differently).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from vamp_mvt_tpu.planning import rrtc as jrrtc
from vamp_mvt_tpu.planning import simplify as jsimplify
from vamp_mvt_tpu_torch.planning import simplify

from test_torch_planner import sphere_problem

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def planned():
    jspec, spec, envs_j, envs_t, starts, goals, masks = sphere_problem()
    settings = jrrtc.RRTCSettings(
        range=1.0, max_iterations=1024, max_samples=512, max_path=64,
        samples_per_step=4, connect_segments=2, sample_window=2,
    )
    pr = jax.jit(lambda e, s, g, m: jrrtc.plan_batch(jspec, e, s, g, m, settings))(
        envs_j, jnp.asarray(starts), jnp.asarray(goals), jnp.asarray(masks)
    )
    assert bool(np.all(np.asarray(pr.solved)))
    ss = jsimplify.SimplifySettings()
    ref = jsimplify.simplify_batch(jspec, envs_j, pr.path, pr.path_length, ss)
    return spec, envs_t, np.array(pr.path), np.array(pr.path_length), ref


def _assert_same(ref, got):
    np.testing.assert_array_equal(got.path_length.numpy(), np.asarray(ref.path_length))
    np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(ref.iterations))
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(ref.cost), rtol=1e-5)
    for i in range(len(got.cost)):
        L = int(np.asarray(ref.path_length)[i])
        np.testing.assert_allclose(got.path.numpy()[i, :L], np.asarray(ref.path)[i, :L],
                                   atol=1e-5)


def test_simplify_batch_matches_jax(planned):
    spec, envs_t, paths, lengths, ref = planned
    got = simplify.simplify_batch(
        spec, envs_t, torch.as_tensor(paths), torch.as_tensor(lengths),
        simplify.SimplifySettings(),
    )
    _assert_same(ref, got)
    assert (got.path_length.numpy() < lengths).all()
    one = simplify.simplify(
        spec, envs_t.map(lambda t: t[1]), torch.as_tensor(paths[1]), int(lengths[1]),
        simplify.SimplifySettings(),
    )
    for a, b in zip(one, got):
        assert torch.equal(a, b[1])


def test_simplify_batch_compact_matches_jax(planned):
    spec, envs_t, paths, lengths, ref = planned
    got = simplify.simplify_batch_compact(
        spec, envs_t, torch.as_tensor(paths), torch.as_tensor(lengths),
        simplify.SimplifySettings(), min_batch=1, device="cpu",
    )
    _assert_same(ref, got)


@pytest.mark.parametrize("ops", [("reduce",), ("perturb",), ("shortcut", "reduce"),
                                 ("reduce", "shortcut", "perturb", "bspline")])
def test_unported_ops_raise(planned, ops):
    """REDUCE and PERTURB, which raised before they were ported, against
    the JAX package's simplify_batch (keys split(PRNGKey(0), B), each
    problem's own): equal path lengths and iterations, paths within rtol
    1e-6 (on the wall paths the largest difference is 2.4e-7: PERTURB's
    proposals cur + (target - cur) * range round apart where XLA contracts
    them into an FMA); the compacting driver keeps each problem's key, so it
    equals simplify_batch; an unknown op raises."""
    from vamp_mvt_tpu.robots import registry as jregistry

    spec, envs_t, paths, lengths, _ = planned
    jspec, _, envs_j, _, _, _, _ = sphere_problem()
    assert jspec.dimension == spec.dimension
    ref = jax.jit(lambda e, p, n: jsimplify.simplify_batch(
        jregistry.sphere_spec(lows=(-3, -3, 0), highs=(3, 3, 3), radius=0.1), e, p, n,
        jsimplify.SimplifySettings(operations=ops)))(
        envs_j, jnp.asarray(paths), jnp.asarray(lengths))
    settings = simplify.SimplifySettings(operations=ops)
    got = simplify.simplify_batch(spec, envs_t, torch.as_tensor(paths), torch.as_tensor(lengths),
                                  settings)
    np.testing.assert_array_equal(got.path_length.numpy(), np.asarray(ref.path_length))
    np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(ref.iterations))
    np.testing.assert_allclose(got.path.numpy(), np.asarray(ref.path), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(ref.cost), rtol=1e-6)
    compact = simplify.simplify_batch_compact(
        spec, envs_t, torch.as_tensor(paths), torch.as_tensor(lengths), settings, min_batch=1,
        device="cpu")
    for a, b in zip(compact, got):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="unknown op"):
        simplify.simplify_batch(spec, envs_t, torch.as_tensor(paths), torch.as_tensor(lengths),
                                simplify.SimplifySettings(operations=("shortcut", "smooth")))


def test_bspline_checks_subdivided_halves():
    """A grazing obstacle that the whole segment's grid misses but a half's
    grid hits: the JAX package keeps the subdivided half (an invalid output
    segment), the port undoes that B-spline pass (all 700 seeded cage
    problems of chip_smoke.py showed 10 such segments in both packages)."""
    from vamp_mvt_tpu.collision import environment as jenv
    from vamp_mvt_tpu.planning import validate as jvalidate
    from vamp_mvt_tpu.robots import registry as jregistry
    from vamp_mvt_tpu_torch.collision import environment as envmod
    from vamp_mvt_tpu_torch.planning import validate
    from vamp_mvt_tpu_torch.robots import registry

    # A->B has length 1.125 (N = 40 points); its first half A->m1 has N = 24.
    # The obstacle sits beside the half's 3rd point, 0.014 from the whole
    # segment's nearest points: robot radius 0.1 + obstacle 0.05 = 0.15 > its
    # offset 0.1499 from the line, so only the half's grid sees the contact.
    path = np.zeros((8, 3), np.float32)
    path[0] = [0.0, 0.0, 1.0]
    path[1] = [1.125, 0.0, 1.0]
    path[2:] = [1.125, 1.125, 1.0]
    obstacle = ([0.0703125, 0.1499, 1.0], 0.05)
    jb, tb = jenv.EnvironmentBuilder(), envmod.EnvironmentBuilder()
    jb.add_sphere(*obstacle)
    tb.add_sphere(*obstacle)
    lows, highs = (-3, -3, 0), (3, 3, 3)
    jspec = jregistry.sphere_spec(lows=lows, highs=highs, radius=0.1)
    spec = registry.sphere_spec(lows=lows, highs=highs, radius=0.1)
    env_j, envs = jb.build(), envmod.broadcast_environment(tb.build(device="cpu"), 1)
    num = validate.n_points_bound(spec, 2.0)
    tpath = torch.as_tensor(path)[None]

    def segments_ok(p, L):
        return validate.validate_motion_batch(spec, envs, p[None, : L - 1], p[None, 1:L], num)[0]

    assert bool(segments_ok(tpath[0], 3).all())  # the planner's path is valid
    ss = jsimplify.SimplifySettings()
    jp, jl, jch = jsimplify._bspline(jspec, env_j, jnp.asarray(path), jnp.int32(3), ss)
    assert int(jl) == 5 and bool(jch)
    jok = np.asarray(jvalidate.validate_motion_batch(
        jspec, env_j, jp[: 4], jp[1:5], num))
    assert not jok[0] and jok[1:].all()  # the reference's hazard

    p, L, ch = simplify._bspline(spec, envs, tpath, torch.tensor([3]), simplify.SimplifySettings())
    assert int(L[0]) == 3 and not bool(ch[0])
    assert torch.equal(p, tpath)
