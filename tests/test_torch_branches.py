"""Port parity: the attachment and heightfield branches of FK + collision.

Mirrors tests/test_kernel_branches.py through the port's plain versions on
the CPU.  The JAX side runs its XLA path (`use_pallas=False`) and its
Pallas kernel in interpret mode (`use_pallas=True`), as the JAX package's
own tests run it.

- Heightfields: validity equal to the XLA path except where a sphere's
  centre lies within CELL_BAND of a cell edge (floor of a value one ulp
  from an integer) or its signed value within BAND of contact; both bands
  are counted.  Past the footprint the port follows the XLA index rule
  (the flat cell index clipped to the table's width), not the Pallas
  kernel's 128-wide padded rows, on a grid whose width is not a multiple of
  128.
- Attachments: validity equal to both JAX paths outside the BAND contact
  band, a shared and a per-problem attachment; the radius-class soundness
  cases of a payload with a kernel-form cloud.
- The lockstep planner on the heightfield and attachment problems of
  tests/test_kernel_branches.py against the JAX package's `plan_batch`.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from vamp_mvt_tpu.collision import environment as jenvmod
from vamp_mvt_tpu.collision.pc_kernel import radius_classes as jradius_classes
from vamp_mvt_tpu.ops import fkcc as jfkcc
from vamp_mvt_tpu.ops.kernels import fkcc_pallas as jfp
from vamp_mvt_tpu.planning import rrtc as jrrtc
from vamp_mvt_tpu.robots import registry as jregistry
from vamp_mvt_tpu_torch import convert
from vamp_mvt_tpu_torch.collision import environment as envmod
from vamp_mvt_tpu_torch.collision import pc_kernel, primitives
from vamp_mvt_tpu_torch.ops import fkcc
from vamp_mvt_tpu_torch.ops.kernels import fkcc_cuda
from vamp_mvt_tpu_torch.planning import rrtc
from vamp_mvt_tpu_torch.robots import registry

torch.set_num_threads(1)

WMIN, WMAX = (-3.0, -3.0, 0.0), (3.0, 3.0, 6.0)
R_POINT = 0.0025
BAND = 1e-5
CELL_BAND = 1e-4


def port_env(jenv, device="cpu"):
    """The port's Environment from a JAX one (tables, heightfields, pck,
    attachment), through convert.environment_from_numpy."""
    leaves = {k: np.asarray(getattr(jenv, k)) for k in envmod.TABLES + ("hf_meta", "hf_data")}
    for k in ("pck", "attachment"):
        if getattr(jenv, k) is not None:
            leaves[k] = getattr(jenv, k)
    return convert.environment_from_numpy(leaves, device)


def port_vmin(spec, env, q):
    """The port's plain vmin of configurations q (N, d) in one environment."""
    envs = env.map(lambda t: t[None])
    return fkcc_cuda.fkcc_vmin_plain(spec, envs, torch.as_tensor(q)[None])[0].numpy()


def jax_valid(jspec, jenv, q, use_pallas):
    return np.asarray(jfkcc.fkcc(jspec, jenv, jnp.asarray(q), use_pallas=use_pallas))


def cell_band(meta, centers):
    """(N,) bool: some sphere centre (N, S, 3) lies within CELL_BAND of a
    cell edge of some field (meta (10,) or (Nh, 10))."""
    return primitives.heightfield_cell_band(
        torch.as_tensor(meta).reshape(-1, 10), torch.as_tensor(centers), CELL_BAND).numpy()


def sphere_hf_case(grid_shape, seed, n, box, radius=0.25):
    jspec = jregistry.sphere_spec(lows=WMIN, highs=WMAX, radius=radius)
    spec = registry.sphere_spec(lows=WMIN, highs=WMAX, radius=radius)
    rng = np.random.default_rng(seed)
    grid = rng.uniform(0.2, 1.8, grid_shape).astype(np.float32)
    meta, data = jenvmod.make_heightfield((0.0, 0.0, 0.0), (0.4, 0.4, 1.0), grid)
    jenv = jenvmod.EnvironmentBuilder().add_heightfield(meta, data).build()
    q = rng.uniform(box[0], box[1], (n, 3)).astype(np.float32)
    return jspec, spec, jenv, port_env(jenv), q, meta


def test_make_heightfield_and_padding_match_jax():
    rng = np.random.default_rng(1)
    grids = [rng.uniform(0.0, 1.0, s).astype(np.float32) for s in ((5, 7), (4, 4))]
    jb, tb = jenvmod.EnvironmentBuilder(), envmod.EnvironmentBuilder()
    for i, g in enumerate(grids):
        jm, jd = jenvmod.make_heightfield((0.1 * i, -0.2, 0.3), (0.05, 0.07, 0.5), g)
        tm, td = envmod.make_heightfield((0.1 * i, -0.2, 0.3), (0.05, 0.07, 0.5), g)
        np.testing.assert_array_equal(jm, tm)
        np.testing.assert_array_equal(jd, td)
        jb.add_heightfield(jm, jd)
        tb.add_heightfield(tm, td)
    for kw in ({}, {"n_heightfields": 4, "hf_cells": 50}):
        je, te = jb.build(**kw), tb.build(device="cpu", **kw)
        np.testing.assert_array_equal(np.asarray(je.hf_meta), te.hf_meta.numpy())
        np.testing.assert_array_equal(np.asarray(je.hf_data), te.hf_data.numpy())
    assert te.hf_meta.shape == (4, 10) and te.hf_data.shape == (4, 50)
    with pytest.raises(ValueError, match="hf_cells"):
        tb.build(hf_cells=10)
    assert envmod.empty_environment().hf_meta.shape == (0, 10)


def test_heightfield_matches_xla():
    jspec, spec, jenv, env, q, meta = sphere_hf_case(
        (16, 16), 7, 1024, (np.float32(WMIN), np.float32(WMAX)))
    q[:, 2] = np.random.default_rng(8).uniform(0.0, 2.5, 1024)  # straddle the surface
    vp = port_vmin(spec, env, q)
    xla = jax_valid(jspec, jenv, q, False)
    band = cell_band(meta, q[:, None]) | (np.abs(vp) <= BAND)
    print(f"heightfield: {int(band.sum())} of {len(q)} configurations in the cell or "
          f"contact band, {int(((vp >= 0) != xla).sum())} disagreements")
    assert 0 < int((vp >= 0).sum()) < len(q)
    np.testing.assert_array_equal((vp >= 0)[~band], xla[~band])
    # the dispatching entry point on the CPU takes the same plain version
    got = fkcc.fkcc(spec, env, torch.as_tensor(q), device="cpu").numpy()
    np.testing.assert_array_equal(got, vp >= 0)


def test_heightfield_edge_rule_follows_xla():
    """A 10 x 13 grid (C = 130, not a multiple of 128) and configurations
    well past its 4 x 5.2 m footprint: where the row index clips to the
    grid's height, the flat index lands in [C, C + xd]; the XLA path and the
    port read the last cell there, the Pallas kernel a padded zero."""
    jspec, spec, jenv, env, q, meta = sphere_hf_case(
        (10, 13), 21, 2048, (np.float32([-5, -5, 0]), np.float32([5, 5, 2.5])))
    vp = port_vmin(spec, env, q)
    xla = jax_valid(jspec, jenv, q, False)
    pallas = jax_valid(jspec, jenv, q, True)
    band = cell_band(meta, q[:, None]) | (np.abs(vp) <= BAND)
    print(f"edge rule: the JAX Pallas kernel disagrees with the XLA path on "
          f"{int((pallas != xla).sum())} of {len(q)} configurations; "
          f"{int(band.sum())} in the bands")
    np.testing.assert_array_equal((vp >= 0)[~band], xla[~band])
    # past the far row the row index clips to the grid's height: the two JAX
    # paths part there, and the port sides with XLA
    far = q[:, 1] < meta[1] - (meta[7] - meta[9]) / meta[4]
    assert (pallas != xla)[far].any()


def panda_attachment_case(att_spheres, tf_pos, seed=9, n=1024):
    jspec, spec = jregistry.load("panda"), registry.load("panda")
    jb = jenvmod.EnvironmentBuilder()
    jb.add_sphere([0.5, 0.0, 0.6], 0.18)
    jb.add_cuboid(jenvmod.make_cuboid([0.0, 0.55, 0.4], [0.3, 0.2, 0.1], [0.2, 0.15, 0.1]))
    jb.attach(jfkcc.make_attachment(att_spheres, tf_pos=tf_pos))
    jenv = jb.build()
    q = np.random.default_rng(seed).uniform(
        jspec.limits_low, jspec.limits_high, (n, 7)).astype(np.float32)
    return jspec, spec, jenv, q


def test_attachment_matches_jax():
    jspec, spec, jenv, q = panda_attachment_case(
        [[0.0, 0.0, 0.09, 0.06], [0.05, 0.0, 0.14, 0.04]], [0.0, 0.0, 0.02])
    env = port_env(jenv)
    vp = port_vmin(spec, env, q)
    band = np.abs(vp) <= BAND
    xla = jax_valid(jspec, jenv, q, False)
    pallas = jax_valid(jspec, jenv, q, True)
    bare = port_vmin(spec, env._replace(attachment=None), q) >= 0
    print(f"attachment: {int(band.sum())} in the contact band; the payload alone "
          f"invalidates {int((bare & (vp < 0)).sum())}")
    assert 0 < int((vp >= 0).sum()) < len(q)
    assert int((bare & (vp < 0)).sum()) > 0, "the payload must change some validities"
    np.testing.assert_array_equal((vp >= 0)[~band], xla[~band])
    np.testing.assert_array_equal((vp >= 0)[~band], pallas[~band])

    # a per-problem attachment: a batch of two payloads against each alone
    _, _, jenv2, _ = panda_attachment_case([[0.0, 0.0, 0.2, 0.1], [0.0, 0.05, 0.1, 0.03]],
                                           [0.01, 0.0, 0.0])
    env2 = port_env(jenv2)
    envs = envmod.stack_environments([env, env2])
    assert envs.attachment.spheres.shape == (2, 2, 4)
    vb = fkcc_cuda.fkcc_vmin_plain(spec, envs, torch.as_tensor(np.stack([q, q]))).numpy()
    np.testing.assert_array_equal(vb[0], vp)
    np.testing.assert_array_equal(vb[1], port_vmin(spec, env2, q))
    with pytest.raises(ValueError, match="sphere count"):
        envmod.stack_environments([env, env2._replace(attachment=env2.attachment._replace(
            spheres=env2.attachment.spheres[:1]))])
    with pytest.raises(ValueError, match="lack an attachment"):
        envmod.stack_environments([env, env2._replace(attachment=None)])


def test_attachment_radius_class_soundness():
    """tests/test_kernel_branches.py's two payload cases with a kernel-form
    cloud: a payload smaller than its class radius must not take the class's
    certain-hit bits; one larger than every class radius has no certain-free
    gate and must take the exact scan.  The port's sphere-table rows of the
    payload equal the Pallas kernel's."""
    pc = np.asarray([[0.125, 0.125, 3.125]], np.float32)
    jspec = jregistry.sphere_spec(lows=WMIN, highs=WMAX, radius=0.25)
    spec = registry.sphere_spec(lows=WMIN, highs=WMAX, radius=0.25)

    def envs_with(att_local, att_r, mvt_max_r):
        b = jenvmod.EnvironmentBuilder()
        b.add_mvt_pointcloud(pc, 0.02, mvt_max_r, WMIN, WMAX, R_POINT)
        b.add_kernel_pointcloud(pc, jradius_classes(jspec.sphere_radius), WMIN, WMAX,
                                R_POINT, 0.25)
        b.attach(jfkcc.make_attachment([[*att_local, att_r]]))
        jenv = b.build()
        return jenv, port_env(jenv)

    for local, r, mvt_r, x, want in (([0.6, 0.0, 0.0], 0.02, 0.25, 0.06, True),
                                     ([0.9, 0.0, 0.0], 0.4, 0.45, 0.38, False)):
        jenv, env = envs_with(local, r, mvt_r)
        q = np.asarray([[0.125 + x - local[0], 0.125, 3.125]], np.float32)
        got = port_vmin(spec, env, q) >= 0
        assert bool(got[0]) == want
        np.testing.assert_array_equal(got, jax_valid(jspec, jenv, q, True))
        np.testing.assert_array_equal(got, jax_valid(jspec, jenv, q, False))
        stab = np.asarray(jfp._pc_arrays(jspec, jenv)[5])[1:]
        rows = fkcc.attachment_rows(env.attachment)
        np.testing.assert_array_equal(
            pc_kernel.attachment_table(rows[..., 3], spec.sphere_radius).numpy(), stab)
        assert stab[0, 3] == (0.0 if r > 0.25 else 1.0)


def _plan_parity(jspec, spec, jenv, starts, goals, settings_kw, B=2):
    envs_j = jax.tree_util.tree_map(lambda a: jnp.broadcast_to(a[None], (B,) + a.shape), jenv)
    envs_t = envmod.broadcast_environment(port_env(jenv), B)
    masks = np.ones((B, 1), bool)
    offs = np.arange(B, dtype=np.int32) * 100
    ref = jax.jit(lambda e, s, g, m, o: jrrtc.plan_batch(
        jspec, e, s, g, m, jrrtc.RRTCSettings(**settings_kw), o
    ))(envs_j, jnp.asarray(starts), jnp.asarray(goals), jnp.asarray(masks), jnp.asarray(offs))
    got = rrtc.plan_batch(spec, envs_t, torch.as_tensor(starts), torch.as_tensor(goals),
                          torch.as_tensor(masks), rrtc.RRTCSettings(**settings_kw),
                          torch.as_tensor(offs))
    assert bool(np.asarray(ref.solved).any()), "parity run must solve something"
    for f in ("solved", "iterations", "path_length"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)), f)
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(ref.cost), rtol=1e-6)


def test_planner_heightfield_matches_jax():
    jspec = jregistry.sphere_spec(lows=WMIN, highs=WMAX, radius=0.25)
    spec = registry.sphere_spec(lows=WMIN, highs=WMAX, radius=0.25)
    grid = np.random.default_rng(11).uniform(0.2, 2.2, (16, 16)).astype(np.float32)
    meta, data = jenvmod.make_heightfield((0.0, 0.0, 0.0), (0.4, 0.4, 1.0), grid)
    jenv = jenvmod.EnvironmentBuilder().add_heightfield(meta, data).build()
    _plan_parity(jspec, spec, jenv, np.tile(np.float32([-2.5, -2.5, 3.2]), (2, 1)),
                 np.tile(np.float32([2.5, 2.5, 3.2]), (2, 1, 1)),
                 dict(range=1.2, max_iterations=256, max_samples=256, max_path=64,
                      samples_per_step=4, connect_segments=2, sample_window=2))


def test_planner_attachment_matches_jax():
    jspec = jregistry.sphere_spec(lows=WMIN, highs=WMAX, radius=0.2)
    spec = registry.sphere_spec(lows=WMIN, highs=WMAX, radius=0.2)
    b = jenvmod.EnvironmentBuilder()
    for z in np.linspace(0.4, 5.6, 9):
        for y in np.linspace(-2.6, 2.6, 9):
            if abs(y) < 1.2 and abs(z - 3.0) < 1.2:
                continue
            b.add_sphere([0.0, y, z], 0.3)
    b.attach(jfkcc.make_attachment([[0.0, 0.4, 0.0, 0.15]]))
    _plan_parity(jspec, spec, b.build(), np.tile(np.float32([-2.0, 0.0, 3.0]), (2, 1)),
                 np.tile(np.float32([2.0, 0.0, 3.0]), (2, 1, 1)),
                 dict(range=1.0, max_iterations=384, max_samples=256, max_path=64,
                      samples_per_step=4, connect_segments=2, sample_window=2))
