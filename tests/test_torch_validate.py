"""Port parity: motion validation (validate_motion_batch, validate_motion_jobs).

Seeded Panda segments in two scenes holding every primitive table go
through the JAX functions (vmapped over the two problems, XLA path on the
CPU) and through the port's batched counterparts; the segment verdicts must
be identical, including segments that overflow the job capacity `t_cap`
(conservatively invalid) and dead segments.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from vamp_mvt_tpu.collision import environment as jenv
from vamp_mvt_tpu.planning import validate as jvalidate
from vamp_mvt_tpu.robots import registry as jregistry
from vamp_mvt_tpu_torch import convert
from vamp_mvt_tpu_torch.planning import validate
from vamp_mvt_tpu_torch.robots import registry

from test_torch_collision import _scene

torch.set_num_threads(1)

FIELDS = ("spheres", "capsules", "z_capsules", "cuboids", "z_cuboids", "hf_meta", "hf_data")


def _case(E=48, seed=11):
    jspec = jregistry.load("panda")
    envs_j = jenv.stack_environments(
        [_scene(jenv, np.random.default_rng(seed + i)).build() for i in range(2)]
    )
    leaves = {k: np.asarray(getattr(envs_j, k)) for k in FIELDS}
    envs_t = convert.environment_from_numpy(leaves, "cpu")
    rng = np.random.default_rng(seed)
    starts = rng.uniform(jspec.limits_low, jspec.limits_high, (2, E, 7)).astype(np.float32)
    # short and long segments: 0.05 .. 1.5 rad steps from the start
    step = rng.normal(size=(2, E, 7))
    step *= rng.uniform(0.05, 1.5, (2, E, 1)) / np.linalg.norm(step, axis=-1, keepdims=True)
    goals = (starts + step).astype(np.float32)
    return jspec, registry.load("panda"), envs_j, envs_t, starts, goals


def test_validate_motion_batch_matches_jax():
    jspec, spec, envs_j, envs_t, starts, goals = _case()
    num = validate.n_points_bound(spec, 1.5)
    assert num == jvalidate.n_points_bound(jspec, 1.5)
    ref = np.asarray(jax.jit(jax.vmap(
        lambda e, s, g: jvalidate.validate_motion_batch(jspec, e, s, g, num)
    ))(envs_j, jnp.asarray(starts), jnp.asarray(goals)))
    got = validate.validate_motion_batch(
        spec, envs_t, torch.as_tensor(starts), torch.as_tensor(goals), num
    ).numpy()
    np.testing.assert_array_equal(got, ref)
    assert 0 < got.sum() < got.size
    one = validate.validate_motion(
        spec, envs_t, torch.as_tensor(starts[:, 0]), torch.as_tensor(goals[:, 0]), num
    ).numpy()
    np.testing.assert_array_equal(one, ref[:, 0])


@pytest.mark.parametrize("t_cap", [4096, 700])
def test_validate_motion_jobs_matches_jax(t_cap):
    jspec, spec, envs_j, envs_t, starts, goals = _case(seed=21)
    live = np.random.default_rng(4).uniform(size=starts.shape[:2]) < 0.8
    ref = np.asarray(jax.jit(jax.vmap(
        lambda e, s, g, l: jvalidate.validate_motion_jobs(jspec, e, s, g, l, t_cap)
    ))(envs_j, jnp.asarray(starts), jnp.asarray(goals), jnp.asarray(live)))
    got = validate.validate_motion_jobs(
        spec, envs_t, torch.as_tensor(starts), torch.as_tensor(goals),
        torch.as_tensor(live), t_cap,
    ).numpy()
    np.testing.assert_array_equal(got, ref)
    assert not got[~live].any()
    if t_cap == 700:
        # the job list overflows: the trailing segments are reported invalid
        n = np.maximum(np.ceil(np.linalg.norm(goals - starts, axis=-1) * 4.0), 1) * 8
        cum = np.cumsum(np.where(live, n, 0), axis=1)
        assert (cum > t_cap).any()
        assert not got[cum > t_cap].any()
