"""Port parity: PRM, PRM*'s roadmap and FCIT* on the CPU.

The sphere-robot wall cases of tests/test_planners.py run through both
packages with the same inputs: solved flags, iterations and sizes must be
equal, paths and roadmap vertices within atol 1e-5 and roadmap edges equal.
The graph work is host numpy in both packages, copied line for line, so
only the device parts can differ: the Halton samples `unit * spans + lows`
(checked bit for bit below) and the validity bits.
"""

import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import vamp_mvt_tpu as jvmt
import vamp_mvt_tpu_torch as vmt
from vamp_mvt_tpu.collision import environment as jenvmod
from vamp_mvt_tpu.planning import fcit as jfcit
from vamp_mvt_tpu.planning import prm as jprm
from vamp_mvt_tpu.robots import registry as jregistry
from vamp_mvt_tpu_torch.collision import environment as envmod
from vamp_mvt_tpu_torch.planning import fcit, prm
from vamp_mvt_tpu_torch.robots import registry

torch.set_num_threads(1)

CPU = "cpu"
START, GOAL = [-2.0, 0.0, 1.0], [2.0, 0.0, 1.0]
WALL = dict(lows=(-3, -3, 0), highs=(3, 3, 3), radius=0.1)


def _wall(mod):
    """tests/test_planners.py's wall of spheres with a gap (y > 2, z > 2),
    built by `mod`'s EnvironmentBuilder."""
    b = mod.EnvironmentBuilder()
    for y in np.linspace(-3, 3, 13):
        for z in np.linspace(0, 3, 7):
            if y > 2.0 and z > 2.0:
                continue
            b.add_sphere([0.0, y, z], 0.3)
    return b.build(device=CPU) if mod is envmod else b.build()


def _specs():
    return registry.sphere_spec(**WALL), jregistry.sphere_spec(**WALL)


def _same_result(got, ref):
    assert bool(got.solved) == bool(ref.solved)
    assert got.iterations == ref.iterations
    assert got.size == ref.size
    assert got.path.shape == ref.path.shape
    np.testing.assert_allclose(got.path, ref.path, rtol=0, atol=1e-5)
    if math.isfinite(ref.cost):
        np.testing.assert_allclose(got.cost, ref.cost, rtol=1e-5)
    else:
        assert not math.isfinite(got.cost)


def test_halton_wave_samples():
    """The sample waves (offsets 1, 65, ...).  The unit samples are bit for
    bit the JAX package's, and the port's `unit * spans + lows` is a float32
    multiply, then an add, as numpy rounds them (on the card: two kernels).
    XLA on the CPU contracts some lanes of its fused loop into an FMA and not
    others: on 25-50% of the coordinates its sample differs from the port's,
    by at most one rounding of the larger term, max(|unit * spans|, |lows|)
    (found on the wall robot, Panda and Baxter)."""
    from vamp_mvt_tpu.sampling.halton import halton as jhalton
    from vamp_mvt_tpu_torch.sampling.halton import halton

    for robot in ("wall", "panda", "baxter"):
        spec, jspec = _specs() if robot == "wall" else (registry.load(robot),
                                                          jregistry.load(robot))
        fns = prm.make_device_fns(spec, envmod.empty_environment(CPU), 64, CPU)
        jfns = jprm._make_device_fns(jspec, jenvmod.empty_environment(), jprm.PRMSettings())
        spans = spec.limits_high - spec.limits_low
        for offset in (1, 65, 1 + 64 * 37, 100001):
            idx = offset + np.arange(64, dtype=np.int32)
            unit = halton(torch.as_tensor(idx), spec.dimension).numpy()
            np.testing.assert_array_equal(unit, np.asarray(jhalton(jnp.asarray(idx),
                                                                   spec.dimension)))
            q, _ = fns.sample_valid(offset)
            np.testing.assert_array_equal(q, unit * spans + spec.limits_low)
            jq = np.asarray(jfns[0](jnp.int32(offset))[0])
            one = np.spacing(np.maximum(np.abs(unit * spans), np.abs(spec.limits_low)))
            assert (np.abs(jq - q) <= one).all()


@pytest.mark.parametrize("robot", ["sphere", "panda", "baxter"])
def test_prm_star_params_match_jax(robot):
    spec, jspec = registry.load(robot), jregistry.load(robot)
    assert spec.space_measure() == jspec.space_measure()
    p = prm.PRMStarNeighborParams(spec.dimension, spec.space_measure())
    jp = jprm.PRMStarNeighborParams(jspec.dimension, jspec.space_measure())
    assert spec.dimension in (3, 7, 14)
    for n in (1, 2, 66, 1000, 4096):
        assert p.max_neighbors(n) == jp.max_neighbors(n)
        assert p.neighbor_radius(n) == jp.neighbor_radius(n)
    assert prm.unit_ball_measure(spec.dimension) == jprm.unit_ball_measure(spec.dimension)


def test_prm_sphere_wall_matches_jax():
    spec, jspec = _specs()
    got = prm.solve(spec, _wall(envmod), START, [GOAL], prm.PRMSettings(
        max_samples=1024, wave=64,
        neighbor_params=prm.PRMStarNeighborParams(3, spec.space_measure())), device=CPU)
    ref = jprm.solve(jspec, _wall(jenvmod), START, [GOAL], jprm.PRMSettings(
        max_samples=1024, wave=64,
        neighbor_params=jprm.PRMStarNeighborParams(3, jspec.space_measure())))
    assert got.solved and got.cost > 4.0  # must detour
    _same_result(got, ref)


def test_prm_direct_matches_jax():
    got = prm.solve(registry.sphere_spec(), envmod.empty_environment(CPU), [0, 0, 1.0],
                    [[1, 1, 2.0]], device=CPU)
    ref = jprm.solve(jregistry.sphere_spec(), jenvmod.empty_environment(), [0, 0, 1.0],
                     [[1, 1, 2.0]])
    assert got.solved and got.iterations == 0
    _same_result(got, ref)


def test_build_roadmap_matches_jax():
    spec, jspec = _specs()
    got = prm.build_roadmap(spec, _wall(envmod), START, GOAL, prm.PRMSettings(
        max_samples=256, wave=64,
        neighbor_params=prm.PRMStarNeighborParams(3, spec.space_measure())), device=CPU)
    ref = jprm.build_roadmap(jspec, _wall(jenvmod), START, GOAL, jprm.PRMSettings(
        max_samples=256, wave=64,
        neighbor_params=jprm.PRMStarNeighborParams(3, jspec.space_measure())))
    assert got.vertices.shape == ref.vertices.shape and got.vertices.shape[0] >= 200
    np.testing.assert_allclose(got.vertices, ref.vertices, rtol=0, atol=1e-5)
    assert got.edges == ref.edges and len(got.edges) > 100


def test_fcit_sphere_wall_matches_jax():
    spec, jspec = _specs()
    got = fcit.solve(spec, _wall(envmod), START, [GOAL],
                     fcit.FCITSettings(max_samples=256, batch_size=64), device=CPU)
    ref = jfcit.solve(jspec, _wall(jenvmod), START, [GOAL],
                      jfcit.FCITSettings(max_samples=256, batch_size=64))
    assert got.solved and got.cost < 12.0
    _same_result(got, ref)


def test_api_planners_match_jax():
    """panda-style calls through both APIs on the sphere robot: prm and fcit
    with a Halton offset, roadmap at a small sample count."""
    def env(api):
        e = api.Environment()
        for y in np.linspace(-3, 3, 13):
            for z in np.linspace(0, 3, 7):
                if not (y > 2.0 and z > 2.0):
                    e.add_sphere(api.Sphere([0.0, y, z], 0.3))
        return e

    start, goal = [-4.0, 0.0, 1.0], [4.0, 0.0, 1.0]
    h, jh = vmt.sphere.halton(), jvmt.sphere.halton()
    h.skip(7)
    jh.skip(7)
    settings = vmt.PRMSettings(max_samples=512)
    jsettings = jvmt.PRMSettings(max_samples=512)
    _same_result(vmt.sphere.prm(start, goal, env(vmt), settings, h, device=CPU),
                 jvmt.sphere.prm(start, goal, env(jvmt), jsettings, jh))
    fs, jfs = vmt.FCITSettings(max_samples=256, batch_size=64), \
        jvmt.FCITSettings(max_samples=256, batch_size=64)
    _same_result(vmt.sphere.fcit(start, [goal], env(vmt), fs, device=CPU),
                 jvmt.sphere.fcit(start, [goal], env(jvmt), jfs))
    rs = vmt.PRMSettings(max_samples=128,
                         neighbor_params=vmt.PRMNeighborParams(3, vmt.sphere.space_measure()))
    jrs = jvmt.PRMSettings(max_samples=128,
                           neighbor_params=jvmt.PRMNeighborParams(3, jvmt.sphere.space_measure()))
    rm = vmt.sphere.roadmap(start, goal, env(vmt), rs, device=CPU)
    jrm = jvmt.sphere.roadmap(start, goal, env(jvmt), jrs)
    np.testing.assert_allclose(rm.vertices, jrm.vertices, rtol=0, atol=1e-5)
    assert rm.edges == jrm.edges


def test_planners_need_a_device():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    spec = registry.sphere_spec(**WALL)
    for call in (lambda: prm.solve(spec, _wall(envmod), START, [GOAL]),
                 lambda: fcit.solve(spec, _wall(envmod), START, [GOAL]),
                 lambda: vmt.sphere.roadmap(START, GOAL, vmt.Environment())):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
