"""The CUDA kernel against its plain PyTorch version, on an NVIDIA GPU.

Every test here is marked `gpu` and skips without a card: a CUDA kernel has
no CPU mode.  The file imports neither JAX nor the JAX package, so it also
runs on a machine without them:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Validity may differ between the kernel and the plain version only where the
plain minimum signed value lies within 1e-5 of contact (float32 rounding of
FK: the kernel reads constants as float32 where the plain version folds them
in float64).
"""

import numpy as np
import pytest
import torch

from vamp_mvt_tpu_torch.collision import environment as envmod
from vamp_mvt_tpu_torch.ops.kernels import fkcc_cuda
from vamp_mvt_tpu_torch.robots import registry

BAND = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _scenes(n, seed):
    """`n` scenes with every primitive table, padded to common capacities so
    each problem has its own live prefix."""
    rng = np.random.default_rng(seed)
    builders = []
    for i in range(n):
        b = envmod.EnvironmentBuilder()
        for _ in range(1 + i % 3):
            b.add_sphere(rng.uniform([-0.7, -0.7, 0.0], [0.7, 0.7, 1.0]), rng.uniform(0.05, 0.2))
            b.add_capsule(envmod.make_capsule_center(
                rng.uniform([-0.7, -0.7, 0.0], [0.7, 0.7, 1.0]),
                rng.uniform(-np.pi, np.pi, 3), rng.uniform(0.03, 0.1), rng.uniform(0.2, 0.6)))
            b.add_capsule(envmod.make_capsule_center(
                rng.uniform([-0.7, -0.7, 0.0], [0.7, 0.7, 1.0]),
                [0.0, 0.0, 0.0], rng.uniform(0.03, 0.1), rng.uniform(0.2, 0.6)))
            b.add_cuboid(envmod.make_cuboid(
                rng.uniform([-0.7, -0.7, 0.0], [0.7, 0.7, 1.0]),
                rng.uniform(-np.pi, np.pi, 3), rng.uniform(0.05, 0.2, 3)))
            b.add_cuboid(envmod.make_cuboid(
                rng.uniform([-0.7, -0.7, 0.0], [0.7, 0.7, 1.0]),
                [0.0, 0.0, rng.uniform(-np.pi, np.pi)], rng.uniform(0.05, 0.2, 3)))
        builders.append(b)
    caps = dict(n_spheres=3, n_capsules=3, n_z_capsules=3, n_cuboids=3, n_z_cuboids=3)
    return envmod.stack_environments([b.build(**caps) for b in builders])


@pytest.mark.gpu
@pytest.mark.parametrize("robot", ["panda", "fetch", "baxter", "sphere"])
def test_kernel_matches_plain(cuda, robot):
    spec = registry.load(robot)
    envs = _scenes(3, seed=0).to(cuda)
    q = torch.as_tensor(np.random.default_rng(1).uniform(
        spec.limits_low, spec.limits_high, (3, 3000, spec.dimension)).astype(np.float32),
        device=cuda)
    before = fkcc_cuda.LAUNCHES
    vk = fkcc_cuda.fkcc_vmin(spec, envs, q)
    vp = fkcc_cuda.fkcc_vmin_plain(spec, envs, q)
    torch.cuda.synchronize()
    assert fkcc_cuda.LAUNCHES == before + 1
    mism = (vk >= 0) != (vp >= 0)
    print(f"{robot}: {int(mism.sum())} validity mismatches of {vk.numel()}, "
          f"max |vmin diff| {float((vk - vp).abs().max()):.3g}")
    assert not (mism & (vp.abs() > BAND)).any()
    assert float((vk - vp).abs().max()) < 1e-4
    if robot == "panda":  # the scenes sit around the Panda's workspace
        assert 0.0 < float((vk >= 0).float().mean()) < 1.0


@pytest.mark.gpu
def test_layouts_and_shared_environment(cuda):
    spec = registry.load("panda")
    envs = _scenes(4, seed=2).to(cuda)
    q = torch.as_tensor(np.random.default_rng(3).uniform(
        spec.limits_low, spec.limits_high, (4, 1500, 7)).astype(np.float32), device=cuda)
    rows = fkcc_cuda.fkcc_batched(spec, envs, q)
    lanes = fkcc_cuda.fkcc_batched_lanes(spec, envs, q.transpose(1, 2).contiguous())
    assert torch.equal(rows, lanes)
    # one environment shared by the whole batch (tables with batch 1)
    one = envs.map(lambda t: t[:1])
    shared = fkcc_cuda.fkcc_batched(spec, one, q)
    per = fkcc_cuda.fkcc_batched(spec, one.map(lambda t: t.expand(4, -1, -1)), q)
    assert torch.equal(shared, per)
    assert torch.equal(shared[0], rows[0])
    assert fkcc_cuda.fkcc_batched(spec, envs, q[:, :0]).shape == (4, 0)


@pytest.mark.gpu
def test_wrapper_rejects_bad_inputs(cuda):
    spec = registry.load("panda")
    envs = _scenes(2, seed=4).to(cuda)
    q = torch.zeros((2, 8, 7), device=cuda)
    with pytest.raises(TypeError):
        fkcc_cuda.fkcc_batched(spec, envs, q.double())
    with pytest.raises(ValueError):
        fkcc_cuda.fkcc_batched(spec, envs.to("cpu"), q)
    with pytest.raises(ValueError):
        fkcc_cuda.fkcc_batched(spec, envs, torch.zeros((3, 8, 7), device=cuda))
