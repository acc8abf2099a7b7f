"""Port parity: robot specs and forward kinematics (vamp_mvt_tpu_torch vs JAX).

The port keeps a byte-for-byte copy of the robot specs; its FK must match the
reference's golden tables at the tolerance of tests/test_fk_golden.py
(atol 2e-5) and the JAX package's FK at atol 1e-5 (the two differ only by
float32 rounding: cos/sin implementations and fused multiply-adds).
"""

import dataclasses
import filecmp
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from vamp_mvt_tpu.ops import fk as jfk
from vamp_mvt_tpu.robots import registry as jregistry
from vamp_mvt_tpu_torch import convert
from vamp_mvt_tpu_torch.ops import fk
from vamp_mvt_tpu_torch.robots import registry

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "golden"
ROBOTS = ["panda", "ur5", "fetch", "baxter"]


def test_specs_json_is_identical_copy():
    assert filecmp.cmp(
        ROOT / "vamp_mvt_tpu" / "robots" / "_specs.json",
        ROOT / "vamp_mvt_tpu_torch" / "robots" / "_specs.json",
        shallow=False,
    )


@pytest.mark.parametrize("robot", ROBOTS)
def test_fk_matches_golden(robot):
    data = np.load(GOLDEN / f"{robot}_fk.npz")
    spec = registry.load(robot)
    q = torch.as_tensor(data["configs"])
    np.testing.assert_allclose(
        fk.sphere_positions(spec, q).numpy(), data["centers"], atol=2e-5, rtol=0
    )
    R, t = fk.eefk(spec, q)
    np.testing.assert_allclose(t.numpy(), data["ee_t"], atol=2e-5, rtol=0)
    np.testing.assert_allclose(R.numpy(), data["ee_r"], atol=2e-5, rtol=0)
    np.testing.assert_allclose(spec.sphere_radius, data["radii"], atol=1e-6)


@pytest.mark.parametrize("robot", ROBOTS + ["sphere"])
def test_fk_matches_jax(robot):
    spec, jspec = registry.load(robot), jregistry.load(robot)
    rng = np.random.default_rng(7)
    q = rng.uniform(spec.limits_low, spec.limits_high, (64, spec.dimension)).astype(np.float32)
    jc = np.asarray(jax.jit(lambda x: jfk.sphere_positions(jspec, x))(jnp.asarray(q)))
    np.testing.assert_allclose(
        fk.sphere_positions(spec, torch.as_tensor(q)).numpy(), jc, atol=1e-5, rtol=0
    )
    jR, jt = jax.jit(lambda x: jfk.eefk(jspec, x))(jnp.asarray(q))
    R, t = fk.eefk(spec, torch.as_tensor(q))
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), atol=1e-5, rtol=0)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), atol=1e-5, rtol=0)


def test_spec_from_numpy_round_trip():
    jspec = jregistry.load("fetch")
    fields = {f.name: getattr(jspec, f.name) for f in dataclasses.fields(jspec)}
    spec = convert.spec_from_numpy(fields)
    ref = registry.load("fetch")
    assert spec.dimension == ref.dimension and len(spec.frames) == len(ref.frames)
    q = torch.as_tensor(
        np.random.default_rng(1).uniform(ref.limits_low, ref.limits_high, (16, 8)),
        dtype=torch.float32,
    )
    assert torch.equal(fk.sphere_positions(spec, q), fk.sphere_positions(ref, q))
    np.testing.assert_array_equal(spec.self_collision_pairs, ref.self_collision_pairs)
