"""Port parity: the MBM problem loader and the public parameters the port
lacked against the JAX package.

- `bench/mbm.py::load_problems` on a synthetic MotionBenchMaker tarball
  (`bench/scenes.py::write_mbm_tarball`: MoveIt scenes of spheres, posed
  cylinders and boxes, requests with the joints in a seeded order): the
  same dict as the JAX package's parser; a cached parse loads without
  PyYAML.
- `problem_to_pointcloud_env(builder=, pad=)`: the cloud added beside a
  builder's primitives, and the MVT / CAPT / kernel-form structures padded,
  with every array equal to the JAX package's.
- `validate_motion_batch(chunk=)`: equal to the unchunked call and to the
  JAX function, with a remainder chunk.
- `mpnet.mlp_apply` and `convert.mpnet_params_to_numpy`: the functional MLP
  equals `MLP.forward` (within 1e-5: `x @ W` and `nn.Linear` sum in other
  orders) and the JAX `mlp_apply` at carried weights (within 1e-5); the
  conversion round-trips exactly.
- `RobotSpec.scale` / `descale` equal the JAX package's.
- The new command-line modules run on the GPU unless asked for the CPU.
"""

import pickle
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from vamp_mvt_tpu.bench import mbm as jmbm
from vamp_mvt_tpu.collision import environment as jenvmod
from vamp_mvt_tpu.planning import mpnet as jmpnet
from vamp_mvt_tpu.planning import validate as jvalidate
from vamp_mvt_tpu.pointcloud import pipeline as jpipeline
from vamp_mvt_tpu.robots import registry as jregistry
from vamp_mvt_tpu_torch import convert
from vamp_mvt_tpu_torch.bench import mbm, scenes
from vamp_mvt_tpu_torch.collision import environment as envmod
from vamp_mvt_tpu_torch.planning import mpnet, validate
from vamp_mvt_tpu_torch.pointcloud import pipeline
from vamp_mvt_tpu_torch.robots import registry

from test_torch_pointcloud import assert_same_struct, scene

torch.set_num_threads(2)


def test_load_problems_tarball_matches_jax(monkeypatch, tmp_path):
    scenes.write_mbm_tarball(tmp_path / "res")
    monkeypatch.setattr(mbm, "RESOURCES", tmp_path / "res")
    monkeypatch.setattr(mbm, "CACHE_DIR", tmp_path / "port_cache")
    monkeypatch.setattr(jmbm, "RESOURCES", tmp_path / "res")
    monkeypatch.setattr(jmbm, "CACHE_DIR", tmp_path / "jax_cache")
    got = mbm.load_problems("panda")
    want = jmbm.load_problems("panda")
    assert got == want
    assert set(got["problems"]) == set(scenes.TARBALL_SCENARIOS)
    for plist in got["problems"].values():
        assert [p["index"] for p in plist] == [1, 2, 3]
        for p in plist:
            assert p["start"] == pytest.approx(list(mbm.PANDA_START))
            assert p["goals"] == [pytest.approx(list(mbm.PANDA_GOAL))]
            assert (len(p["sphere"]), len(p["cylinder"]), len(p["box"])) == (14, 2, 2)
    # every obstacle lies inside a cage sphere
    cyl = got["problems"]["cage"][0]["cylinder"][0]
    assert min(np.linalg.norm(np.subtract(cyl["position"], c)) for c in mbm.CAGE_CENTERS) < 0.02
    assert (tmp_path / "port_cache" / "panda_problems.pkl").exists()
    assert mbm.load_problems("panda") == got  # the cached parse


def test_cached_parse_loads_without_yaml(monkeypatch, tmp_path):
    data = mbm.cage_suite(3)
    (tmp_path / "panda_problems.pkl").write_bytes(pickle.dumps(data))
    monkeypatch.setattr(mbm, "CACHE_DIR", tmp_path)
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError):
        import yaml  # noqa: F401
    assert mbm.load_problems("panda") == data
    monkeypatch.setattr(mbm, "RESOURCES", tmp_path / "absent")
    with pytest.raises(ImportError):  # a parse that is not cached needs PyYAML
        mbm.load_problems("panda", use_cache=False)


@pytest.mark.parametrize("pc_repr,pad", [
    ("mvt", {"pad_voxels": 900, "pad_capacity": 64, "pc_pad_chunks": 700}),
    ("capt", {"pad_leaves": 2500, "pad_capacity": 200, "pc_pad_chunks": 700}),
])
def test_pointcloud_env_builder_and_pad_match_jax(pc_repr, pad):
    p = scene(7)
    jb = jenvmod.EnvironmentBuilder().add_sphere([0.5, 0.0, 0.5], 0.1)
    tb = envmod.EnvironmentBuilder().add_sphere([0.5, 0.0, 0.5], 0.1)
    cub = [0.4, 0.2, 0.3], [0.1, 0.2, 0.3], [0.05, 0.1, 0.15]
    jb.add_cuboid(jenvmod.make_cuboid(*cub))
    tb.add_cuboid(envmod.make_cuboid(*cub))
    jout = jpipeline.problem_to_pointcloud_env("panda", p, pc_repr=pc_repr,
                                               samples_per_object=1500, builder=jb, pad=pad)
    tout = pipeline.problem_to_pointcloud_env("panda", p, pc_repr=pc_repr,
                                              samples_per_object=1500, builder=tb, pad=pad)
    assert jout[0] is jb and tout[0] is tb
    np.testing.assert_array_equal(tout[2], jout[2])
    for name in ("spheres", "cuboids", "z_cuboids"):
        np.testing.assert_array_equal(np.asarray(getattr(tb, name)),
                                      np.asarray(getattr(jb, name)), err_msg=name)
    assert_same_struct(getattr(jb, pc_repr), getattr(tb, pc_repr))
    assert_same_struct(jb.pck, tb.pck)
    # the padding took: the padded sizes, above the cloud's own
    own = pipeline.problem_to_pointcloud_env("panda", p, pc_repr=pc_repr,
                                             samples_per_object=1500)[0]
    st, st_own = getattr(tb, pc_repr), getattr(own, pc_repr)
    if pc_repr == "mvt":
        assert st.voxel_points.shape[:2] == (900, 64) != st_own.voxel_points.shape[:2]
    else:
        assert st.aff_points.shape[:2] == (2500, 200) != st_own.aff_points.shape[:2]
    assert tb.pck.chunks.shape[0] == 700 > own.pck.chunks.shape[0]
    assert tout[0].build(device="cpu").spheres.shape[0] == 1


def test_validate_motion_batch_chunk():
    spec, jspec = registry.load("panda"), jregistry.load("panda")
    data = mbm.cage_suite(2)
    envs = mbm.build_batch(data["problems"]["cage"], device="cpu")[0]
    jenvs = jmbm.build_batch(data["problems"]["cage"])[0]
    rng = np.random.default_rng(3)
    E = 7
    a = rng.uniform(spec.limits_low, spec.limits_high, (2, E, 7)).astype(np.float32)
    b = (a + rng.normal(0, 0.6, a.shape)).astype(np.float32)
    num = validate.n_points_bound(spec, float(np.linalg.norm(b - a, axis=-1).max()))
    full = validate.validate_motion_batch(spec, envs, torch.from_numpy(a), torch.from_numpy(b),
                                          num)
    assert 0 < int(full.sum()) < full.numel()  # both outcomes
    for chunk in (1, 3, 7, 9):
        got = validate.validate_motion_batch(spec, envs, torch.from_numpy(a),
                                             torch.from_numpy(b), num, chunk=chunk)
        assert torch.equal(got, full), chunk
    for i in range(2):
        env_i = jax.tree_util.tree_map(lambda t: t[i], jenvs)
        want = jvalidate.validate_motion_batch(jspec, env_i, jnp.asarray(a[i]),
                                               jnp.asarray(b[i]), num, chunk=3)
        np.testing.assert_array_equal(full[i].numpy(), np.asarray(want))


@pytest.mark.parametrize("final_linear", [True, False])
def test_mlp_apply_matches_forward_and_jax(final_linear):
    key = jax.random.PRNGKey(4)
    sizes = (18, 32, 16, 7)
    jparams = jmpnet.init_mlp(key, sizes)
    # alphas and biases other than their initial values, so each one shows
    rng = np.random.default_rng(5)
    jparams = [(W, b + rng.normal(0, 0.1, b.shape).astype(np.float32),
                jnp.float32(rng.uniform(0.05, 0.5))) for W, b, _ in jparams]
    mlp = convert.mpnet_params_from_numpy([tuple(map(np.asarray, p)) for p in jparams])
    mlp.final_linear = final_linear
    x = rng.normal(0, 1, (5, 18)).astype(np.float32)
    with torch.no_grad():
        got = mpnet.mlp_apply(mlp.params(), torch.from_numpy(x), final_linear)
        fwd = mlp(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), fwd.numpy(), rtol=1e-5, atol=1e-5)
    want = jmpnet.mlp_apply(jparams, jnp.asarray(x), final_linear)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)

    back = convert.mpnet_params_to_numpy(mlp)
    for (W, b, a), (jW, jb, ja) in zip(back, jparams):
        assert W.dtype == b.dtype == a.dtype == np.float32 and a.shape == ()
        np.testing.assert_array_equal(W, np.asarray(jW))
        np.testing.assert_array_equal(b, np.asarray(jb))
        assert a == np.float32(ja)


def test_prelu_slope_at_zero_follows_jax():
    """mlp_apply's PReLU passes the gradient at x = 0 with slope 1, as
    `jnp.where(x >= 0, x, a * x)` does (torch's prelu uses x > 0)."""
    x = torch.zeros(3, requires_grad=True)
    a = torch.tensor(0.25)
    mpnet._prelu(x, a).sum().backward()
    jg = jax.grad(lambda v: jmpnet._prelu(v, jnp.float32(0.25)).sum())(jnp.zeros(3))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(jg))


def test_robot_spec_scale_matches_jax():
    """RobotSpec.scale / descale, the last public names the port lacked."""
    u = np.random.default_rng(6).uniform(0, 1, (5, 7)).astype(np.float32)
    spec, jspec = registry.load("panda"), jregistry.load("panda")
    q = spec.scale(u)
    np.testing.assert_array_equal(q, jspec.scale(u))
    np.testing.assert_array_equal(spec.descale(q), jspec.descale(q))
    np.testing.assert_allclose(spec.descale(q), u, atol=1e-6)


def test_new_entry_points_need_a_device(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    from vamp_mvt_tpu_torch.examples import (
        evaluate_mbm, evaluate_mbm_mpnet, prepare_mpnet_dataset, prepare_query_dataset,
        visualize_mbm)
    from vamp_mvt_tpu_torch.tools import train_mpnet

    pkl = tmp_path / "cages.pkl"
    pkl.write_bytes(pickle.dumps(mbm.cage_suite(1)))
    for run in (lambda: evaluate_mbm.main(["--problems_pkl", str(pkl), "--batch_size", "1"]),
                lambda: prepare_mpnet_dataset.main(["--out", str(tmp_path / "d")]),
                lambda: train_mpnet.main(["--data", str(tmp_path / "d")]),
                lambda: evaluate_mbm_mpnet.main([]),
                lambda: prepare_query_dataset.main(["--out", str(tmp_path / "q")]),
                lambda: visualize_mbm.main([])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run()
