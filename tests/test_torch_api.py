"""The port's user API (`vamp_mvt_tpu_torch.api`) on the CPU.

Mirrors tests/test_api.py case by case through `vamp_mvt_tpu_torch` with
`device="cpu"`, and holds `panda.rrtc` / `panda.simplify` against the JAX
package's `rrtc.plan` / `simplify.simplify` at the same settings: solved
and iterations exact, costs within rtol 1e-5.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import vamp_mvt_tpu as jvmt
import vamp_mvt_tpu_torch as vmt
from vamp_mvt_tpu.planning import rrtc as jrrtc
from vamp_mvt_tpu.planning import simplify as jsimplify
from tests.test_rrtc import CAGE, PANDA_GOAL, PANDA_START

torch.set_num_threads(1)

CPU = "cpu"
SETTINGS = dict(max_iterations=2048, max_samples=2048)


def _cage_env(api=vmt):
    env = api.Environment()
    for c in CAGE:
        env.add_sphere(api.Sphere(c, 0.2))
    return env


def test_api_end_to_end_panda():
    env = _cage_env()
    assert vmt.panda.validate(PANDA_START, env, device=CPU)
    assert not vmt.panda.validate([0.0] * 7, env, device=CPU)
    assert not vmt.panda.validate([9.0] * 7, env, check_bounds=True, device=CPU)

    settings = vmt.panda.default_rrtc_settings(**SETTINGS)
    res = vmt.panda.rrtc(PANDA_START, PANDA_GOAL, env, settings, device=CPU)
    assert bool(res.solved)
    simple = vmt.panda.simplify(res.path, res.path_length, env, device=CPU)
    assert float(simple.cost) <= float(res.cost) + 1e-5
    path = simple.path.numpy()
    for i in range(int(simple.path_length) - 1):
        assert vmt.panda.validate_motion(path[i], path[i + 1], env, device=CPU)

    # the JAX package's planner and simplifier at the same settings
    jenv = _cage_env(jvmt).build()
    jset = jrrtc.RRTCSettings(**{f: getattr(settings, f) for f in (
        "range", "max_iterations", "max_samples", "max_path", "samples_per_step",
        "connect_segments")})
    ref = jax.jit(lambda e, s, g: jrrtc.plan(jvmt.panda.spec, e, s, g, jnp.ones(1, bool), jset))(
        jenv, jnp.asarray(PANDA_START, jnp.float32), jnp.asarray([PANDA_GOAL], jnp.float32))
    assert bool(ref.solved) == bool(res.solved)
    assert int(ref.iterations) == int(res.iterations)
    np.testing.assert_allclose(float(res.cost), float(ref.cost), rtol=1e-5)
    jsimp = jax.jit(lambda e, p, n: jsimplify.simplify(
        jvmt.panda.spec, e, p, n, jsimplify.SimplifySettings()))(jenv, ref.path, ref.path_length)
    np.testing.assert_allclose(float(simple.cost), float(jsimp.cost), rtol=1e-5)

    # info functions
    assert vmt.panda.dimension() == 7
    assert vmt.panda.n_spheres() == 59
    assert len(vmt.panda.joint_names()) == 7
    assert vmt.panda.space_measure() == pytest.approx(jvmt.panda.space_measure())
    rmin, rmax = vmt.panda.min_max_radii()
    assert 0 < rmin < rmax < 0.1

    spheres = vmt.panda.fk(PANDA_START, device=CPU)
    assert spheres.shape == (59, 4)
    np.testing.assert_allclose(spheres, jvmt.panda.fk(PANDA_START), atol=2e-5)
    R, t = vmt.panda.eefk(PANDA_START, device=CPU)
    assert R.shape == (3, 3) and t.shape == (3,)
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-5)
    jR, jt = jvmt.panda.eefk(PANDA_START)
    np.testing.assert_allclose(R, jR, atol=2e-5)
    np.testing.assert_allclose(t, jt, atol=2e-5)


def test_api_debug_reports_collisions():
    env = vmt.Environment()
    env.add_sphere(vmt.Sphere([0.088, 0, 0.926], 0.3))  # near the Panda wrist at home
    dbg = vmt.panda.debug([0.0] * 7, env, device=CPU)
    assert len(dbg["env_colliding_spheres"]) > 0
    jenv = jvmt.Environment()
    jenv.add_sphere(jvmt.Sphere([0.088, 0, 0.926], 0.3))
    assert dbg == jvmt.panda.debug([0.0] * 7, jenv)


def test_api_attachment_changes_validity():
    env = _cage_env()
    q = PANDA_START
    assert vmt.panda.validate(q, env, device=CPU)
    # a big payload ball at the EE collides with the cage from the start pose
    env.attach(vmt.Attachment(spheres=[[0.0, 0.0, 0.25, 0.4]]))
    assert not vmt.panda.validate(q, env, device=CPU)
    # a small payload is fine
    env2 = _cage_env()
    env2.attach(vmt.Attachment(spheres=[[0.0, 0.0, 0.05, 0.02]]))
    assert vmt.panda.validate(q, env2, device=CPU)


def test_api_attachment_vs_robot():
    """A payload sphere placed exactly on a checked robot sphere collides."""
    env = vmt.Environment()
    R, t = vmt.panda.eefk(PANDA_START, device=CPU)
    target = vmt.panda.fk(PANDA_START, device=CPU)[0, :3]
    local = R.T @ (target - t)
    env.attach(vmt.Attachment(spheres=[[*local, 0.1]]))
    assert not vmt.panda.validate(PANDA_START, env, device=CPU)


def test_api_sampler_skip():
    env = _cage_env()
    s1, s2 = vmt.panda.halton(), vmt.panda.halton()
    s2.skip(100)
    settings = vmt.panda.default_rrtc_settings(**SETTINGS)
    r1 = vmt.panda.rrtc(PANDA_START, PANDA_GOAL, env, settings, sampler=s1, device=CPU)
    r2 = vmt.panda.rrtc(PANDA_START, PANDA_GOAL, env, settings, sampler=s2, device=CPU)
    assert bool(r1.solved) and bool(r2.solved)
    assert int(r1.iterations) != int(r2.iterations) or float(r1.cost) != float(r2.cost)
    s2.reset()
    assert s2.offset == s1.offset == 0


def test_png_to_heightfield_matches_jax(tmp_path):
    from PIL import Image

    img = np.random.default_rng(4).integers(0, 256, (9, 12), dtype=np.uint8)
    f = tmp_path / "terrain.png"
    Image.fromarray(img).save(f)
    meta, data = vmt.png_to_heightfield(f, (0.5, -0.5, 0.0), (0.04, 0.04, 0.6))
    jmeta, jdata = jvmt.png_to_heightfield(f, (0.5, -0.5, 0.0), (0.04, 0.04, 0.6))
    np.testing.assert_array_equal(meta, jmeta)
    np.testing.assert_array_equal(data, jdata)
    # a sphere over the terrain's highest cell collides there and not above
    env = vmt.Environment()
    env.add_heightfield(meta, data)
    k = int(np.argmax(data))
    x = 0.5 - (k % 12 - 6 + 0.5) * 0.04
    y = -0.5 - (k // 12 - 4 + 0.5) * 0.04
    top = float(data.max()) * float(meta[5])  # the meta keeps 1 / sz
    assert not vmt.sphere.validate([x, y, top], env, device=CPU)
    assert vmt.sphere.validate([x, y, top + 0.25], env, device=CPU)


@pytest.mark.parametrize("planner", ["prm", "fcit", "aorrtc", "roadmap"])
def test_unported_planners_raise(planner):
    """The planners that raised before they were ported.  aorrtc: panda's
    AORRTC in the cage at small budgets (one initial RRT-Connect, two AOX
    rounds with PHS sampling) equals the JAX API's: path length, cost within
    rtol 1e-5, path within atol 1e-5, every segment valid, the cost no worse
    than the initial plan's.  prm, fcit and roadmap plan on the CPU (one
    small wave or batch here; tests/test_torch_prm.py holds them against the
    JAX package)."""
    env = _cage_env()
    if planner == "aorrtc":
        # the initial plan takes 688 samples: two AOX rounds of up to 128 follow
        rrtc_kw = dict(SETTINGS, max_samples=1024)
        budget = dict(max_iterations=944, max_internal_iterations=128)
        settings = vmt.AORRTCSettings(rrtc=vmt.panda.default_rrtc_settings(**rrtc_kw), **budget)
        res = vmt.panda.aorrtc(PANDA_START, PANDA_GOAL, env, settings, device=CPU)
        jset = jvmt.AORRTCSettings(rrtc=jvmt.panda.default_rrtc_settings(**rrtc_kw), **budget)
        ref = jvmt.panda.aorrtc(PANDA_START, PANDA_GOAL, _cage_env(jvmt), jset)
        L = int(ref.path_length)
        assert int(res.path_length) == L > 0
        np.testing.assert_allclose(float(res.cost), float(ref.cost), rtol=1e-5)
        np.testing.assert_allclose(res.path.numpy()[:L], np.asarray(ref.path)[:L], atol=1e-5)
        first = vmt.panda.rrtc(PANDA_START, PANDA_GOAL, env, settings.rrtc, device=CPU)
        assert float(res.cost) <= float(first.cost) + 1e-5
        path = res.path.numpy()
        for i in range(L - 1):
            assert vmt.panda.validate_motion(path[i], path[i + 1], env, device=CPU)
        return
    small = (vmt.FCITSettings(max_iterations=1, batch_size=8) if planner == "fcit"
             else vmt.PRMSettings(wave=8, max_iterations=8))
    out = getattr(vmt.panda, planner)(PANDA_START, PANDA_GOAL, env, small, device=CPU)
    if planner == "roadmap":
        assert out.vertices.shape[1] == 7 and out.vertices.shape[0] >= 2
    else:
        assert out.path.shape[1] == 7 and out.iterations >= 1 and not out.solved


def test_api_needs_a_device():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    env = _cage_env()
    for call in (lambda: vmt.panda.validate(PANDA_START, env),
                 lambda: vmt.panda.fk(PANDA_START),
                 lambda: vmt.panda.rrtc(PANDA_START, PANDA_GOAL, env),
                 lambda: env.build()):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
