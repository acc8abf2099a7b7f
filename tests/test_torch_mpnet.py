"""Port parity: MPNet (`planning/mpnet.py`) on the CPU.

Mirrors tests/test_mpnet.py (direct connection, validated rollouts, the RRTC
fallback on the sphere robot) and holds the port against the JAX package:

- `threefry.normal` against `jax.random.normal`: the uniforms are bit for
  bit JAX's; the erfinv follows XLA's polynomials, so a draw lies within
  4 float32 ulp of JAX's (3 measured, here and at the encoder's 35,934 x
  512 shape).
- `init_mlp`: each weight within 4 ulp of the JAX package's (4 measured),
  biases 0 and alphas 0.25 exactly.
- `load_torch_state_dict` on a reference-layout `nn.Sequential` state dict:
  weights, biases and alphas exactly the JAX function's.
- With the JAX planner's weights carried over (`convert.mpnet_params_from_
  numpy`), at the published widths: the encoder latent within 5e-5 (9.5e-6
  measured), a planner forward within 1e-4 (3.5e-6 measured), and whole
  `plan` rollouts with the same vertex count, vertices within 1e-4 (1.8e-6
  measured) and the same numpy draws (the generators end in one state).
  The products sum in another order than XLA's, and only a motion check
  within float rounding of contact could tell the two apart.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from vamp_mvt_tpu.collision import environment as jenvmod
from vamp_mvt_tpu.planning import mpnet as jmpnet
from vamp_mvt_tpu.robots import registry as jregistry
from vamp_mvt_tpu_torch import convert
from vamp_mvt_tpu_torch.collision import environment as envmod
from vamp_mvt_tpu_torch.planning import mpnet
from vamp_mvt_tpu_torch.robots import registry
from vamp_mvt_tpu_torch.sampling import threefry

from test_torch_suite_robots import _JAX_ID_CACHES

CPU = "cpu"
ULPS = 4
CAGE = [[0.55, 0, 0.25], [0.35, 0.35, 0.25], [0, 0.55, 0.25], [-0.55, 0, 0.25],
        [-0.35, -0.35, 0.25], [0, -0.55, 0.25], [0.35, -0.35, 0.25],
        [0.35, 0.35, 0.8], [0, 0.55, 0.8], [-0.35, 0.35, 0.8], [-0.55, 0, 0.8],
        [-0.35, -0.35, 0.8], [0, -0.55, 0.8], [0.35, -0.35, 0.8]]
A = [0., -0.785, 0., -2.356, 0., 1.571, 0.785]
B = [2.35, 1., 0., -0.8, 0, 2.5, 0.785]


@pytest.fixture(autouse=True)
def _fresh_jax_caches(monkeypatch):
    """The JAX package keys robot tables by id(spec): a sphere spec freed
    by an earlier test may hand its entries on."""
    for mod, name in _JAX_ID_CACHES:
        monkeypatch.setattr(mod, name, {})


def _within_ulps(got, want, n=ULPS):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return bool(np.all(np.abs(got - want) <= n * np.spacing(np.abs(want))))


def _carry(params):
    return convert.mpnet_params_from_numpy([tuple(np.asarray(t) for t in p) for p in params])


def _planners(spec_args, centers, radius, seed):
    """The JAX planner at its own init, and the port's with its weights."""
    if spec_args is None:
        jspec, spec = jregistry.load("panda"), registry.load("panda")
    else:
        jspec, spec = jregistry.sphere_spec(**spec_args), registry.sphere_spec(**spec_args)
    jb, b = jenvmod.EnvironmentBuilder(), envmod.EnvironmentBuilder()
    for c in centers:
        jb.add_sphere(c, radius)
        b.add_sphere(c, radius)
    jmp = jmpnet.MPNetPlanner(jspec, jb.build(), seed=seed)
    mp = mpnet.MPNetPlanner(spec, b.build(device=CPU), encoder_params=_carry(jmp.encoder_params),
                            planner_params=_carry(jmp.planner_params), seed=seed, device=CPU)
    return jmp, mp


# --- tests/test_mpnet.py, through the port ---------------------------------

def test_mpnet_direct_connection():
    spec = registry.sphere_spec()
    mp = mpnet.MPNetPlanner(spec, envmod.empty_environment(CPU), device=CPU)
    mp.encode_environment(np.random.default_rng(0).uniform(-1, 1, (100, 3)))
    path = mp.plan([0, 0, 1.0], [1, 1, 2.0], max_iterations=2, max_planning_steps=4)
    assert path is not None and len(path) == 2  # straight line fires


def test_mpnet_rollout_produces_valid_paths():
    """Even untrained, every accepted segment must be collision-valid."""
    spec = registry.sphere_spec(lows=(-2, -2, 0), highs=(2, 2, 2), radius=0.1)
    b = envmod.EnvironmentBuilder()
    b.add_sphere([0, 0, 1.0], 0.9)
    mp = mpnet.MPNetPlanner(spec, b.build(device=CPU), seed=3, device=CPU)
    mp.encode_environment(np.random.default_rng(1).uniform(-1, 1, (500, 3)))
    goal = np.array([1.5, 1.5, 1.5], np.float32)
    path = mp._single_attempt(np.array([-1.5, -1.5, 0.5], np.float32), goal, 8)
    assert path is not None and len(path) > 1
    for a, b_ in zip(path[:-1], path[1:]):
        assert mp._valid(a, b_)


def test_plan_with_mpnet_fallback():
    """Untrained nets won't reach the goal; the RRTC fallback must."""
    import vamp_mvt_tpu_torch as vmt

    env = vmt.Environment()
    env.add_sphere(vmt.Sphere([0, 0, 1.0], 0.4))
    pc = np.random.default_rng(2).uniform(-1, 1, (200, 3))
    start, goal = [-2.0, 0.0, 1.0], [2.0, 0.0, 1.0]
    mpnet.FORWARDS = 0
    path, method = mpnet.plan_with_mpnet("sphere", start, goal, env, pc, device=CPU)
    assert path is not None
    assert method in ("mpnet", "rrtc_fallback")
    np.testing.assert_allclose(path[-1], goal, atol=1e-5)
    assert mpnet.FORWARDS > 0


def test_entry_points_default_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mpnet.MPNetPlanner(registry.sphere_spec(), envmod.empty_environment(CPU))


def test_sphere_surface_samples_lie_on_the_sphere():
    from vamp_mvt_tpu_torch.pointcloud import sampling

    np.random.seed(0)
    pts = sampling.sphere_surface([0.5, -0.2, 1.0], 0.3, 2000)
    r = np.linalg.norm(pts - [0.5, -0.2, 1.0], axis=1)
    np.testing.assert_allclose(r, 0.3, atol=1e-12)
    assert np.abs(pts.mean(0) - [0.5, -0.2, 1.0]).max() < 0.03  # no side favoured


# --- against the JAX package -----------------------------------------------

@pytest.mark.parametrize("seed,shape", [(0, (7,)), (3, (42, 1280)), (12345, (129, 31)),
                                        (1, (mpnet.MAX_POINTCLOUD_SIZE * 3, 512))])
def test_normal_matches_jax(seed, shape):
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
    got = threefry.normal(threefry.prng_key(seed), shape)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    assert _within_ulps(got.numpy(), want)


def test_erfinv_matches_xla():
    """At the uniforms' extremes and across [-1, 1]: within 2 ulp of
    jax.lax.erf_inv, infinite at +-1 as XLA's."""
    x = np.concatenate([np.linspace(-1, 1, 20001, dtype=np.float32),
                        np.nextafter(np.float32([-1, 1]), np.float32(0))])
    got = threefry.erfinv(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    fin = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), fin) and np.array_equal(got[~fin], want[~fin])
    assert _within_ulps(got[fin], want[fin], 2)


@pytest.mark.parametrize("sizes", [(mpnet.LATENT + 14,) + mpnet.PLANNER_WIDTHS + (7,),
                                   (12, 5, 3)])
def test_init_mlp_matches_jax(sizes):
    jp = jmpnet.init_mlp(jax.random.PRNGKey(5), sizes)
    mlp = mpnet.init_mlp(threefry.prng_key(5), sizes)
    assert mlp.sizes == tuple(sizes)
    for (W, b, a), lin, act in zip(jp, mlp.linears, mlp.prelus):
        assert _within_ulps(lin.weight.detach().numpy().T, W)
        assert np.array_equal(lin.bias.detach().numpy(), np.asarray(b))
        assert act.weight.item() == float(a) == 0.25


def test_load_torch_state_dict_matches_jax(tmp_path):
    """The reference's layout: an nn.Sequential of Linear and PReLU, saved
    as a state dict; both loaders give the same parameters exactly."""
    torch.manual_seed(0)
    sizes = (9, 16, 12, 4)
    layers = []
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        layers.append(torch.nn.Linear(a, b))
        if i < len(sizes) - 2:
            layers.append(torch.nn.PReLU())

    class Planner(torch.nn.Module):  # the reference's: keys fc.<i>.weight
        def __init__(self):
            super().__init__()
            self.fc = torch.nn.Sequential(*layers)

        def forward(self, x):
            return self.fc(x)

    net = Planner()
    with torch.no_grad():
        for k, p in enumerate(m.weight for m in net.fc if isinstance(m, torch.nn.PReLU)):
            p.fill_(0.1 + 0.2 * k)
    path = tmp_path / "planner.pkl"
    torch.save(net.state_dict(), path)
    jp = jmpnet.load_torch_state_dict(str(path), None)
    mlp = mpnet.load_torch_state_dict(str(path), sizes)
    assert mlp.sizes == sizes
    for (W, b, a), lin, act in zip(jp, mlp.linears, mlp.prelus):
        assert np.array_equal(lin.weight.detach().numpy().T, np.asarray(W))
        assert np.array_equal(lin.bias.detach().numpy(), np.asarray(b))
        assert act.weight.item() == float(a)
    x = np.random.default_rng(0).standard_normal(sizes[0]).astype(np.float32)
    with torch.no_grad():
        got = mlp(torch.from_numpy(x)).numpy()
        ref = net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jmpnet.mlp_apply(jp, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="widths"):
        mpnet.load_torch_state_dict(str(path), (9, 16, 4))


def test_encoder_and_planner_forward_match_jax():
    """The Panda's networks at their published widths, the JAX planner's
    weights carried over: the latent and the next waypoint agree."""
    jmp, mp = _planners(None, CAGE, 0.2, seed=0)
    pc = np.random.default_rng(2).uniform(-1, 1, (20000, 3))
    jmp.encode_environment(pc)
    mp.encode_environment(pc)
    assert mp.latent.shape == (mpnet.LATENT,)
    np.testing.assert_allclose(mp.latent, jmp.latent, atol=5e-5)
    mp.latent = jmp.latent.copy()
    cur, goal = np.asarray(A, np.float32), np.asarray(B, np.float32)
    np.testing.assert_allclose(mp._predict_next(cur, goal), jmp._predict_next(cur, goal),
                               atol=1e-4)


@pytest.mark.parametrize("case", ["sphere", "sphere_perturbed", "panda_cage"])
def test_plan_rollouts_match_jax(case):
    """sphere_perturbed (seed 4) accepts perturbed steps: its rollouts read
    the numpy draws."""
    if case.startswith("sphere"):
        jmp, mp = _planners(dict(lows=(-2, -2, 0), highs=(2, 2, 2), radius=0.1),
                            [[0, 0, 1.0]], 0.9, seed=4 if case == "sphere_perturbed" else 3)
        pc = np.random.default_rng(1).uniform(-1, 1, (500, 3))
        start, goal, kw = [-1.5, -1.5, 0.5], [1.5, 1.5, 1.5], dict(max_iterations=3,
                                                                   max_planning_steps=16)
    else:
        jmp, mp = _planners(None, CAGE, 0.2, seed=0)
        pc = np.random.default_rng(2).uniform(-1, 1, (20000, 3))
        start, goal, kw = A, B, dict(max_iterations=2, max_planning_steps=20)
    jmp.encode_environment(pc)
    mp.encode_environment(pc)
    want = jmp.plan(start, goal, **kw)
    got = mp.plan(start, goal, **kw)
    assert want is not None and got is not None and len(got) == len(want) > 2
    np.testing.assert_allclose(np.stack(got), np.stack(want), atol=1e-4)
    assert mp._rng.bit_generator.state == jmp._rng.bit_generator.state


def test_plan_with_mpnet_falls_back_from_an_invalid_path():
    """The first seeded cage request (bench/scenes.py::cage_requests): the
    JAX planner's rollouts reach the goal through a segment that collides
    (a bridge joins bwd[-2] unchecked), and the JAX plan_with_mpnet would
    return that path as "mpnet".  The port's rollouts give the same path;
    its plan_with_mpnet checks every segment and falls back to RRTC."""
    import vamp_mvt_tpu_torch as vmt
    from vamp_mvt_tpu_torch.bench import mbm, scenes

    spec = registry.load("panda")
    start, goal = scenes.cage_requests(spec, 1, device=CPU)[0]
    cloud = scenes.cage_cloud()
    jmp, mp = _planners(None, mbm.CAGE_CENTERS, mbm.CAGE_RADIUS, seed=0)
    jmp.encode_environment(cloud)
    mp.encode_environment(cloud)
    want = jmp.plan(start, goal, max_iterations=2)
    got = mp.plan(start, goal, max_iterations=2)
    assert np.linalg.norm(want[-1] - goal) == 0.0
    assert not all(bool(jmp._valid(a, b)) for a, b in zip(want[:-1], want[1:]))
    np.testing.assert_allclose(np.stack(got), np.stack(want), atol=1e-4)
    assert not mp.path_valid(got) and mp.path_valid(got[:2])

    env = vmt.Environment()
    for c in mbm.CAGE_CENTERS:
        env.add_sphere(vmt.Sphere(c, mbm.CAGE_RADIUS))
    path, method = mpnet.plan_with_mpnet("panda", start, goal, env, cloud, device=CPU)
    assert method == "rrtc_fallback"
    np.testing.assert_allclose(path[-1], goal, atol=1e-5)
    assert mp.path_valid(path)
