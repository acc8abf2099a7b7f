"""Port parity: collision primitives and the fused FK + collision check.

The port's signed primitive values must match the JAX package's at atol
1e-5.  Panda validity over 4096 seeded configurations, in an environment
holding all five primitive tables, must match both the JAX XLA path
(`ops.fkcc.fkcc`) and the Pallas kernel (`fkcc_pallas_batched`, interpret
mode on the CPU); a disagreement is allowed only where the JAX minimum
signed value lies within 1e-5 of 0 (float32 rounding at contact).  The CUDA
kernel itself runs only on a GPU (tests/test_torch_gpu.py); the robot tables
it walks are checked here on the CPU by replaying its FK loop in numpy.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from vamp_mvt_tpu.collision import environment as jenv
from vamp_mvt_tpu.collision import primitives as jprim
from vamp_mvt_tpu.ops import fk as jfk
from vamp_mvt_tpu.ops import fkcc as jfkcc
from vamp_mvt_tpu.ops.kernels import fkcc_pallas
from vamp_mvt_tpu.robots import registry as jregistry
from vamp_mvt_tpu_torch import convert
from vamp_mvt_tpu_torch.collision import environment as envmod
from vamp_mvt_tpu_torch.collision import primitives
from vamp_mvt_tpu_torch.ops import fk, fkcc
from vamp_mvt_tpu_torch.ops.kernels import fkcc_cuda
from vamp_mvt_tpu_torch.robots import registry

torch.set_num_threads(1)

BAND = 1e-5


def _scene(builder_mod, rng):
    """Two shapes of every primitive table around the Panda's workspace."""
    b = builder_mod.EnvironmentBuilder()
    for _ in range(2):
        b.add_sphere(rng.uniform([-0.7, -0.7, 0.0], [0.7, 0.7, 1.0]), rng.uniform(0.05, 0.2))
        b.add_capsule(builder_mod.make_capsule_center(
            rng.uniform([-0.7, -0.7, 0.0], [0.7, 0.7, 1.0]),
            rng.uniform(-np.pi, np.pi, 3), rng.uniform(0.03, 0.1), rng.uniform(0.2, 0.6)))
        b.add_capsule(builder_mod.make_capsule_center(
            rng.uniform([-0.7, -0.7, 0.0], [0.7, 0.7, 1.0]),
            [0.0, 0.0, 0.0], rng.uniform(0.03, 0.1), rng.uniform(0.2, 0.6)))
        b.add_cuboid(builder_mod.make_cuboid(
            rng.uniform([-0.7, -0.7, 0.0], [0.7, 0.7, 1.0]),
            rng.uniform(-np.pi, np.pi, 3), rng.uniform(0.05, 0.2, 3)))
        b.add_cuboid(builder_mod.make_cuboid(
            rng.uniform([-0.7, -0.7, 0.0], [0.7, 0.7, 1.0]),
            [0.0, 0.0, rng.uniform(-np.pi, np.pi)], rng.uniform(0.05, 0.2, 3)))
    return b


def _panda_case(n=4096, seed=0):
    jspec = jregistry.load("panda")
    jb = _scene(jenv, np.random.default_rng(seed))
    env_j = jb.build()
    leaves = {k: np.asarray(getattr(env_j, k)) for k in (
        "spheres", "capsules", "z_capsules", "cuboids", "z_cuboids", "hf_meta", "hf_data")}
    env_t = convert.environment_from_numpy(leaves, "cpu")
    for name in envmod.TABLES:
        assert getattr(env_t, name).shape[0] == 2, name
    q = np.random.default_rng(seed + 1).uniform(
        jspec.limits_low, jspec.limits_high, (n, 7)).astype(np.float32)
    return jspec, registry.load("panda"), env_j, env_t, q


def _jax_vmin(jspec, env, q):
    """Minimum signed value of the JAX package's checks (valid iff >= 0)."""
    c = jfk.sphere_positions(jspec, q)
    r = jnp.asarray(jspec.sphere_radius)
    vals = [
        jnp.min(jprim.sphere_sphere(env.spheres, c, r), axis=(-2, -1)),
        jnp.min(jprim.sphere_capsule(env.capsules, c, r), axis=(-2, -1)),
        jnp.min(jprim.sphere_z_capsule(env.z_capsules, c, r), axis=(-2, -1)),
        jnp.min(jprim.sphere_cuboid(env.cuboids, c, r), axis=(-2, -1)),
        jnp.min(jprim.sphere_z_cuboid(env.z_cuboids, c, r), axis=(-2, -1)),
    ]
    pairs = np.asarray(jspec.self_collision_pairs)
    d = c[..., pairs[:, 0], :] - c[..., pairs[:, 1], :]
    rr = jspec.sphere_radius
    thr = jnp.asarray((rr[pairs[:, 0]] + rr[pairs[:, 1]]) ** 2)
    vals.append(jnp.min(jnp.sum(d * d, -1) - thr, axis=-1))
    return jnp.min(jnp.stack(vals), axis=0)


@pytest.mark.parametrize("name", ["sphere", "capsule", "z_capsule", "cuboid", "z_cuboid"])
def test_primitives_match_jax(name):
    rng = np.random.default_rng(3)
    b = _scene(jenv, rng)
    env = b.build()
    table = {"sphere": env.spheres, "capsule": env.capsules, "z_capsule": env.z_capsules,
             "cuboid": env.cuboids, "z_cuboid": env.z_cuboids}[name]
    p = rng.uniform(-1.0, 1.0, (5, 40, 3)).astype(np.float32)
    r = rng.uniform(0.01, 0.1, 40).astype(np.float32)
    jf = getattr(jprim, f"sphere_{name}")
    tf = getattr(primitives, f"sphere_{name}")
    ref = np.asarray(jf(table, jnp.asarray(p), jnp.asarray(r)))
    got = tf(torch.as_tensor(np.array(table)), torch.as_tensor(p), torch.as_tensor(r)).numpy()
    assert got.shape == ref.shape == (5, 40, 2)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_fkcc_panda_matches_jax_and_pallas():
    jspec, spec, env_j, env_t, q = _panda_case()
    ref_vmin = np.asarray(jax.jit(lambda x: _jax_vmin(jspec, env_j, x))(jnp.asarray(q)))
    xla = np.asarray(jax.jit(lambda x: jfkcc.fkcc(jspec, env_j, x, use_pallas=False))(jnp.asarray(q)))
    envs_j = jax.tree_util.tree_map(lambda a: a[None], env_j)
    pallas = np.asarray(fkcc_pallas.fkcc_pallas_batched(jspec, envs_j, jnp.asarray(q)[None]))[0]
    np.testing.assert_array_equal(xla, ref_vmin >= 0)  # the oracle is consistent

    got = fkcc.fkcc(spec, env_t, torch.as_tensor(q), device="cpu").numpy()
    vmin = fkcc_cuda.fkcc_vmin(spec, env_t.map(lambda t: t[None]), torch.as_tensor(q)[None])[0]
    np.testing.assert_array_equal(got, vmin.numpy() >= 0)
    np.testing.assert_allclose(vmin.numpy(), ref_vmin, atol=1e-5, rtol=1e-6)

    for name, other in (("xla", xla), ("pallas", pallas)):
        diff = got != other
        outside = diff & (np.abs(ref_vmin) > BAND)
        print(f"panda fkcc vs {name}: {int(diff.sum())} disagreements of {len(q)}, "
              f"{int(outside.sum())} outside |vmin| <= {BAND}")
        assert not outside.any()
    # the scene must exercise both outcomes and every table
    assert 0.05 < got.mean() < 0.95


def test_fkcc_entry_points_agree_on_cpu():
    _, spec, _, env_t, q = _panda_case(n=510, seed=5)
    envs = env_t.map(lambda t: t[None].expand(3, *t.shape))
    qb = torch.as_tensor(q).reshape(3, -1, 7)[:, :170]
    a = fkcc_cuda.fkcc_batched(spec, envs, qb)
    b = fkcc_cuda.fkcc_batched_lanes(spec, envs, qb.transpose(1, 2).contiguous())
    c = fkcc_cuda.fkcc_batched(spec, envs, qb.reshape(3, 10, 17, 7)).reshape(3, 170)
    assert a.shape == (3, 170) and torch.equal(a, b) and torch.equal(a, c)
    assert fkcc_cuda.LAUNCHES == 0  # CPU tensors never reach the kernel


def _replay_kernel_fk(spec, q):
    """The FK loop of csrc/fkcc.cu, run in float32 numpy over its tables."""
    tabs = fkcc_cuda.robot_tables(spec)
    fi, ff = tabs["frame_i"], tabs["frame_f"]
    f32 = np.float32
    out = np.zeros(q.shape[:1] + (spec.n_spheres, 3), f32)
    slots = {}
    R = t = None
    for f in range(len(fi)):
        parent, jt, qi, slot, s0, s1 = fi[f]
        if parent < 0:
            R, t = ff[f, :9].reshape(3, 3).copy(), ff[f, 9:12].copy()
            R = np.broadcast_to(R, (len(q), 3, 3)).astype(f32)
            t = np.broadcast_to(t, (len(q), 3)).astype(f32)
        else:
            assert parent == f - 1 or parent in slots, "parent pose not kept"
            Rp, tp = (R, t) if parent == f - 1 else slots[parent]
            C, x = ff[f, :9].reshape(3, 3), ff[f, 9:12]
            R = np.einsum("bik,kj->bij", Rp, C).astype(f32)
            t = (np.einsum("bik,k->bi", Rp, x) + tp).astype(f32)
        if jt == 1:
            c, s = np.cos(q[:, qi])[:, None], np.sin(q[:, qi])[:, None]
            Q = (ff[f, 15:24] + ff[f, 24:33] * c + ff[f, 33:42] * s).reshape(-1, 3, 3)
            R = np.einsum("bik,bkj->bij", R, Q).astype(f32)
        elif jt == 2:
            t = (t + q[:, qi, None] * np.einsum("bik,k->bi", R, ff[f, 12:15])).astype(f32)
        if slot >= 0:
            slots[f] = (R, t)
        for k in tabs["sphere_order"][s0:s1]:
            out[:, k] = np.einsum("bik,k->bi", R, tabs["sphere_f"][k, :3]) + t
    assert sorted(tabs["sphere_order"]) == list(range(spec.n_spheres))
    return out


@pytest.mark.parametrize("robot", ["panda", "ur5", "fetch", "baxter", "sphere"])
def test_kernel_robot_tables_replay_fk(robot):
    spec = registry.load(robot)
    q = np.random.default_rng(2).uniform(
        spec.limits_low, spec.limits_high, (32, spec.dimension)).astype(np.float32)
    np.testing.assert_allclose(
        _replay_kernel_fk(spec, q), fk.sphere_positions(spec, torch.as_tensor(q)).numpy(),
        atol=1e-5, rtol=0,
    )
    tabs = fkcc_cuda.robot_tables(spec)
    np.testing.assert_array_equal(tabs["pair_thr"], fkcc.pair_thresholds(spec))


def test_fkcc_work_count():
    spec = registry.load("panda")
    live = {n: np.array([1, 0]) for n in envmod.TABLES}
    one = fkcc_cuda.op_count(spec, {n: np.array([0]) for n in envmod.TABLES}, 1)
    two = fkcc_cuda.op_count(spec, live, 1)
    per_shape = sum(fkcc_cuda.OPS_PER_ROW.values()) * spec.n_spheres
    assert two == 2 * one + per_shape
    assert one > fkcc_cuda.OPS_PER_PAIR * 690


def test_builder_rejects_live_row_after_inert_row():
    rows = np.tile(envmod._INERT["spheres"], (3, 1))
    rows[2] = [0.1, 0.2, 0.3, 0.1]
    with pytest.raises(ValueError, match="prefix"):
        envmod.check_live_prefix("spheres", rows)
    leaves = {k: np.zeros((0, f), np.float32) for k, f in (
        ("capsules", 8), ("z_capsules", 8), ("cuboids", 15), ("z_cuboids", 15),
        ("hf_meta", 10), ("hf_data", 0))}
    with pytest.raises(ValueError, match="prefix"):
        convert.environment_from_numpy({**leaves, "spheres": rows}, "cpu")
