"""Port parity: MBM batch assembly and start/goal validity.

On synthetic problems covering every object type and the box problem's
cylinder->cuboid rule (the generator of tests/test_mbm_batch.py, copied),
the port's `_assemble_batch_np` and `build_batch` must equal the JAX
package's exactly, and `_valid_fused` must give the same flags.
"""

import numpy as np
import torch
import jax
import jax.numpy as jnp

from vamp_mvt_tpu.bench import mbm as jmbm
from vamp_mvt_tpu.robots import registry as jregistry
from vamp_mvt_tpu_torch.bench import mbm
from vamp_mvt_tpu_torch.collision import environment as envmod
from vamp_mvt_tpu_torch.robots import registry

torch.set_num_threads(1)


def _synthetic_problems(n=12, seed=0):
    rng = np.random.default_rng(seed)
    problems = []
    for i in range(n):
        kind = ("box", "cage", "table_pick")[i % 3]
        p = {"problem": kind, "sphere": [], "cylinder": [], "box": [],
             "start": rng.uniform(-1, 1, 7).tolist(),
             "goals": [rng.uniform(-1, 1, 7).tolist()
                       for _ in range(1 + i % 2)]}
        for _ in range(rng.integers(0, 3)):
            p["sphere"].append(
                {"position": rng.uniform(-1, 1, 3).tolist(),
                 "radius": float(rng.uniform(0.05, 0.3))}
            )
        for j in range(rng.integers(0, 3)):
            e = rng.uniform(-np.pi, np.pi, 3)
            if j == 0:
                e[:] = 0.0  # exercise the z-aligned routing
            p["cylinder"].append(
                {"position": rng.uniform(-1, 1, 3).tolist(),
                 "orientation_euler_xyz": e.tolist(),
                 "radius": float(rng.uniform(0.05, 0.2)),
                 "length": float(rng.uniform(0.2, 0.8))}
            )
        for j in range(rng.integers(0, 4)):
            e = rng.uniform(-np.pi, np.pi, 3)
            if j == 0:
                e[:] = 0.0
            p["box"].append(
                {"position": rng.uniform(-1, 1, 3).tolist(),
                 "orientation_euler_xyz": e.tolist(),
                 "half_extents": rng.uniform(0.05, 0.4, 3).tolist()}
            )
        problems.append(p)
    return problems


def test_assemble_batch_matches_jax():
    problems = _synthetic_problems()
    ref = jmbm._assemble_batch_np(problems)
    got = mbm._assemble_batch_np(problems)
    assert set(ref) == set(got)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_build_batch_and_validity_match_jax():
    problems = _synthetic_problems(n=24, seed=3)
    jenvs, jstarts, jgoals, jmasks = jmbm.build_batch(problems)
    envs, starts, goals, masks = mbm.build_batch(problems, device="cpu")
    for f in envmod.TABLES:
        np.testing.assert_array_equal(getattr(envs, f).numpy(), np.asarray(getattr(jenvs, f)), f)
    np.testing.assert_array_equal(starts.numpy(), np.asarray(jstarts))
    np.testing.assert_array_equal(goals.numpy(), np.asarray(jgoals))
    np.testing.assert_array_equal(masks.numpy(), np.asarray(jmasks))

    ref = np.asarray(jmbm._valid_fused(jregistry.load("panda"), jenvs, jstarts, jgoals, jmasks))
    got = mbm._valid_fused(registry.load("panda"), envs, starts, goals, masks).numpy()
    np.testing.assert_array_equal(got, ref)
    one = mbm.validate_configs(registry.load("panda"), envs, starts).numpy()
    np.testing.assert_array_equal(one, np.asarray(jmbm.validate_configs(
        jregistry.load("panda"), jenvs, jstarts)))


def test_content_key_separates_suites_of_equal_size():
    a, b = _synthetic_problems(seed=0), _synthetic_problems(seed=1)
    assert len(a) == len(b)
    assert mbm.content_key(a) != mbm.content_key(b)
    assert mbm.content_key(a) == mbm.content_key(_synthetic_problems(seed=0))


def test_builder_path_matches_vectorized_batch(tmp_path):
    import pickle

    problems = _synthetic_problems(n=9, seed=5)
    builders = [mbm.problem_to_builder(p) for p in problems]
    caps = {f"n_{n}": max(len(getattr(b, n)) for b in builders) for n in envmod.TABLES}
    ref = envmod.stack_environments([b.build(**caps) for b in builders])
    envs = mbm.build_batch(problems, device="cpu")[0]
    for f in envmod.TABLES:
        assert torch.equal(getattr(envs, f), getattr(ref, f)), f

    # the pickle layout load_problems writes, read back by load_problems_pkl
    data = {"robot": "panda", "joints": [], "problems": {"box": [
        {k: v for k, v in p.items() if k != "sphere"} for p in problems[:2]]}}
    path = tmp_path / "problems.pkl"
    path.write_bytes(pickle.dumps(data))
    back = mbm.load_problems_pkl(path)
    assert [p["sphere"] for p in back["problems"]["box"]] == [[], []]
    assert back["problems"]["box"][1]["box"] == problems[1]["box"]
