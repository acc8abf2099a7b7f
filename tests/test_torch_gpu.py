"""The CUDA kernels against their plain PyTorch versions, on an NVIDIA GPU.

Every test here is marked `gpu` and skips without a card: a CUDA kernel has
no CPU mode.  The file imports neither JAX nor the JAX package, so it also
runs on a machine without them:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Validity may differ between the fkcc kernel and the plain version only where
the plain minimum signed value lies within 1e-5 of contact (float32 rounding
of FK: the kernel reads constants as float32 where the plain version folds
them in float64).  The megakernels must match their plain versions (the
lockstep planner and simplifier) on the sphere-robot wall problem exactly in
solved flags, iterations, tree sizes and path lengths, with costs within
rtol 1e-6 (planner) and 1e-5 (simplifier).
"""

import dataclasses

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


# ---------------------------------------------------------------------------
# The planner and simplifier megakernels against their plain versions
# ---------------------------------------------------------------------------


def _wall(device, B=3):
    """tests/test_mega.py's sphere-robot wall problem (a wall of spheres with
    a gap), B problems whose goals differ by 0.05 each."""
    from vamp_mvt_tpu_torch.collision import environment as envmod

    b = envmod.EnvironmentBuilder()
    for y in np.linspace(-3, 3, 13):
        for z in np.linspace(0, 3, 7):
            if not (y > 2.0 and z > 2.0):
                b.add_sphere([0.0, y, z], 0.3)
    envs = envmod.broadcast_environment(b.build(device=device), B)
    starts = torch.tensor([[-2.0, 0.0, 1.0]] * B, device=device)
    goals = (torch.tensor([[[2.0, 0.0, 1.0]]] * B, device=device)
             + torch.arange(B, device=device)[:, None, None] * 0.05)
    masks = torch.ones((B, 1), dtype=torch.bool, device=device)
    spec = registry.sphere_spec(lows=(-3, -3, 0), highs=(3, 3, 3), radius=0.1)
    return spec, envs, starts, goals, masks


def _wall_settings(k, c, w, **kw):
    from vamp_mvt_tpu_torch.planning import rrtc

    return rrtc.RRTCSettings(**dict(range=1.0, max_iterations=384, max_samples=512,
                                    max_path=64, samples_per_step=k, connect_segments=c,
                                    sample_window=w) | kw)


@pytest.mark.gpu
@pytest.mark.parametrize("k,c,w", [(1, 1, 1), (4, 2, 2)])
def test_rrtc_mega_matches_plain(cuda, k, c, w):
    from vamp_mvt_tpu_torch.ops.kernels import rrtc_mega_cuda
    from vamp_mvt_tpu_torch.planning import rrtc, rrtc_mega

    spec, envs, starts, goals, masks = _wall(cuda)
    offs = torch.arange(3, device=cuda, dtype=torch.int32) * 100
    s = _wall_settings(k, c, w)

    def both(g, budget):
        before = rrtc_mega_cuda.LAUNCHES
        got = rrtc_mega.plan_batch_mega(spec, envs, starts, g, masks, s, offs, budget=budget,
                                        device=cuda)
        torch.cuda.synchronize()
        assert rrtc_mega_cuda.LAUNCHES == before + 1
        ref = rrtc.plan_batch(spec, envs, starts, g, masks, dataclasses.replace(
            s, max_iterations=budget or s.max_iterations), offs)
        for f in ("solved", "iterations", "size_start", "size_goal", "path_length"):
            assert torch.equal(getattr(got, f).cpu(), getattr(ref, f).cpu()), (budget, f)
        torch.testing.assert_close(got.cost, ref.cost, rtol=1e-6, atol=0)
        for i in range(3):
            L = int(ref.path_length[i])
            torch.testing.assert_close(got.path[i, :L], ref.path[i, :L], rtol=0, atol=1e-6)
        return got

    got = both(goals, None)
    assert bool(got.solved.any())
    # run_suite's retry: a small budget, then 32x it with the solved rows'
    # goals replaced by their starts
    got = both(goals, 260)
    both(torch.where(got.solved[:, None, None], starts[:, None], goals), 32 * 260)


@pytest.mark.gpu
def test_simplify_mega_matches_plain(cuda):
    from vamp_mvt_tpu_torch.ops.kernels import simplify_mega_cuda
    from vamp_mvt_tpu_torch.planning import rrtc, simplify, simplify_mega

    spec, envs, starts, goals, masks = _wall(cuda)
    pr = rrtc.plan_batch(spec, envs, starts, goals, masks,
                         _wall_settings(4, 2, 2, max_iterations=1024))
    assert bool(pr.solved.all())
    ss = simplify.SimplifySettings()
    before = simplify_mega_cuda.LAUNCHES
    got = simplify_mega.simplify_batch_mega(spec, envs, pr.path, pr.path_length, ss,
                                            device=cuda)
    torch.cuda.synchronize()
    assert simplify_mega_cuda.LAUNCHES == before + 1
    ref = simplify_mega.simplify_batch_plain(spec, envs, pr.path, pr.path_length, ss)
    assert torch.equal(got.path_length.cpu(), ref.path_length.cpu())
    assert torch.equal(got.iterations.cpu(), ref.iterations.cpu())
    torch.testing.assert_close(got.cost, ref.cost, rtol=1e-5, atol=0)
    torch.testing.assert_close(got.path, ref.path, rtol=0, atol=1e-5)
    assert (got.path_length < pr.path_length).all()
    # the straight-line exit and paths of fewer than three vertices
    two = simplify_mega.simplify_batch_mega(spec, envs, pr.path, torch.full_like(
        pr.path_length, 2), ss, device=cuda)
    assert two.path_length.tolist() == [2, 2, 2] and two.iterations.tolist() == [0, 0, 0]


@pytest.mark.gpu
def test_mega_wrappers_reject_bad_inputs(cuda):
    from vamp_mvt_tpu_torch.ops.kernels import rrtc_mega_cuda, simplify_mega_cuda
    from vamp_mvt_tpu_torch.planning import rrtc_mega

    spec, envs, starts, goals, masks = _wall(cuda)
    s = _wall_settings(4, 2, 2)
    ctl, nodes0, _, _ = rrtc_mega.mega_inputs(spec, envs, starts, goals, masks, s)
    with pytest.raises(ValueError):
        rrtc_mega_cuda.plan(spec, envs, ctl.cpu(), nodes0.cpu(), s)
    with pytest.raises(TypeError):
        rrtc_mega_cuda.plan(spec, envs, ctl, nodes0.double(), s)
    with pytest.raises(ValueError):
        rrtc_mega_cuda.plan(spec, envs, ctl[:, :4].contiguous(), nodes0, s)
    with pytest.raises(ValueError):
        rrtc_mega_cuda.plan(spec, envs, ctl, nodes0[:, :, :6].contiguous(), s)
    with pytest.raises(ValueError):
        rrtc_mega_cuda.plan(spec, envs, ctl, nodes0.transpose(0, 1).contiguous().transpose(0, 1), s)
    with pytest.raises(ValueError):
        rrtc_mega_cuda.plan(spec, envs.to("cpu"), ctl, nodes0, s)
    paths = torch.zeros((3, 8, 3), device=cuda)
    lengths = torch.full((3,), 4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        simplify_mega_cuda.simplify(spec, envs, paths.cpu(), lengths.cpu(), None)
    with pytest.raises(TypeError):
        simplify_mega_cuda.simplify(spec, envs, paths, lengths.long(), None)
    with pytest.raises(ValueError):
        simplify_mega_cuda.simplify(spec, envs, paths[..., :2].contiguous(), lengths, None)
    with pytest.raises(ValueError):
        simplify_mega_cuda.simplify(spec, envs, paths.transpose(0, 1).contiguous()
                                    .transpose(0, 1), lengths, None)


@pytest.mark.gpu
def test_refused_launch_raises(cuda, monkeypatch):
    """A launch the card refuses (more shared memory than a block may have)
    raises, and leaves no error behind: the next launch matches the plain
    version."""
    from vamp_mvt_tpu_torch.ops.kernels import rrtc_mega_cuda, simplify_mega_cuda
    from vamp_mvt_tpu_torch.planning import rrtc, rrtc_mega, simplify

    spec, envs, starts, goals, masks = _wall(cuda)
    monkeypatch.setattr(fkcc_cuda, "MAX_SMEM", 1 << 20)
    big = _wall_settings(4, 2, 2, max_path=70000)
    ctl, nodes0, _, _ = rrtc_mega.mega_inputs(spec, envs, starts, goals, masks, big)
    before = rrtc_mega_cuda.LAUNCHES
    with pytest.raises(RuntimeError, match="CUDA error"):
        rrtc_mega_cuda.plan(spec, envs, ctl, nodes0, big)
    assert rrtc_mega_cuda.LAUNCHES == before
    paths = torch.zeros((3, 3000, 3), device=cuda)
    lengths = torch.full((3,), 4, dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="CUDA error"):
        simplify_mega_cuda.simplify(spec, envs, paths, lengths, simplify.SimplifySettings())
    monkeypatch.undo()
    s = _wall_settings(4, 2, 2)
    offs = torch.arange(3, device=cuda, dtype=torch.int32) * 100
    got = rrtc_mega.plan_batch_mega(spec, envs, starts, goals, masks, s, offs, device=cuda)
    torch.cuda.synchronize()
    assert rrtc_mega_cuda.LAUNCHES == before + 1
    ref = rrtc.plan_batch(spec, envs, starts, goals, masks, s, offs)
    assert bool(got.solved.any())
    for f in ("solved", "iterations", "size_start", "size_goal", "path_length"):
        assert torch.equal(getattr(got, f).cpu(), getattr(ref, f).cpu()), f
    torch.testing.assert_close(got.cost, ref.cost, rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# The pointcloud branch (env.pck) in all three kernels
# ---------------------------------------------------------------------------

PC_WMIN, PC_WMAX = (-3.0, -3.0, 0.0), (3.0, 3.0, 6.0)
R_POINT = 0.0025


def _wall_points(n_side=9):
    """tests/test_kernel_branches.py's thin wall of points at x = 0 with a
    gap around (y, z) = (0, 2.6)."""
    ys = np.linspace(-2.0, 2.0, n_side)
    zs = np.linspace(0.5, 3.0, n_side)
    return np.asarray([[0.0, y, z] for y in ys for z in zs
                       if not (abs(y) < 0.7 and z > 2.2)], np.float32)


def _pck_env(spec, pts, max_radius, device):
    from vamp_mvt_tpu_torch.collision import pc_kernel

    b = envmod.EnvironmentBuilder()
    b.add_kernel_pointcloud(pts, pc_kernel.radius_classes(spec.sphere_radius), PC_WMIN,
                            PC_WMAX, R_POINT, max_radius)
    return b.build(device=device)


def _pc_check(spec, envs, q):
    """Kernel against plain on pointcloud tables: validity equal outside the
    contact band; returns the kernel's validity and its pointcloud work
    (spheres gated, chunk bounds tested, points evaluated)."""
    before = fkcc_cuda.LAUNCHES
    vk = fkcc_cuda.fkcc_vmin(spec, envs, q)
    fkcc_cuda.PC_WORK = None
    ok = fkcc_cuda.fkcc_batched(spec, envs, q)
    work = fkcc_cuda.PC_WORK.tolist()
    vp = fkcc_cuda.fkcc_vmin_plain(spec, envs, q)
    torch.cuda.synchronize()
    assert fkcc_cuda.LAUNCHES == before + 2
    assert torch.equal(ok, vk >= 0)
    mism = (vk >= 0) != (vp >= 0)
    print(f"{spec.name}: {int(mism.sum())} validity mismatches of {vk.numel()}, work {work}")
    assert not (mism & (vp.abs() > BAND)).any()
    return ok, work


@pytest.mark.gpu
def test_pc_kernel_matches_plain(cuda):
    # the sphere-robot wall, configurations banded around the wall
    spec = registry.sphere_spec(lows=PC_WMIN, highs=PC_WMAX, radius=0.25)
    env = _pck_env(spec, _wall_points(), 0.25, cuda)
    rng = np.random.default_rng(3)
    q = rng.uniform(np.asarray(PC_WMIN) - 0.5, np.asarray(PC_WMAX) + 0.5, (2, 4096, 3))
    q[:, :1200, 0] = rng.normal(0.0, 0.3, (2, 1200))
    envs = envmod.broadcast_environment(env, 2)
    ok, work = _pc_check(spec, envs, torch.as_tensor(q.astype(np.float32), device=cuda))
    assert 0.0 < float(ok.float().mean()) < 1.0
    assert min(work) > 0
    # the Panda wall, and a batch of two clouds of different sizes (the
    # smaller padded to the larger's chunks)
    spec = registry.load("panda")
    pts = _wall_points()
    pts = pts[pts[:, 2] < 1.5] * np.float32(0.4) + np.float32([0.45, 0, 0.2])
    dense = _wall_points(40)
    dense = dense[dense[:, 2] < 1.5] * np.float32(0.4) + np.float32([0.35, 0.1, 0.2])
    envs = envmod.stack_environments([_pck_env(spec, p, spec.max_radius, "cpu")
                                      for p in (pts, dense)]).to(cuda)
    assert int(envs.pck.meta[0, 0, 6]) < envs.pck.chunks.shape[1]
    q = np.random.default_rng(5).uniform(spec.limits_low, spec.limits_high, (2, 4096, 7))
    ok, work = _pc_check(spec, envs, torch.as_tensor(q.astype(np.float32), device=cuda))
    assert 0.0 < float(ok.float().mean()) < 1.0
    assert min(work) > 0


@pytest.mark.gpu
def test_pc_radius_class_soundness(cuda):
    """A robot with more distinct radii than the bitmap has classes: the
    small sphere that shares class 0.25 must not take its certain-hit bits
    (tests/test_torch_pc_fkcc.py builds the same robot)."""
    radii = np.float32([0.01, 0.012, 0.014, 0.016, 0.018, 0.02,
                        0.25, 0.251, 0.252, 0.253, 0.254, 0.255, 0.256])
    base = registry.sphere_spec(lows=PC_WMIN, highs=PC_WMAX, radius=0.25)
    local = np.zeros((len(radii), 3), np.float32)
    local[6:, 2] = -2.0
    spec = dataclasses.replace(
        base, sphere_frame=np.full(len(radii), 3, np.int32), sphere_local=local,
        sphere_radius=radii, self_collision_pairs=np.zeros((0, 2), np.int32))
    cell = 6.0 / int(np.floor(6.0 / radii.max()))
    point = np.float32([-3.0 + 12.5 * cell, -3.0 + 12.5 * cell, 12.5 * cell])
    env = _pck_env(spec, point[None], float(radii.max()), cuda)
    rng = np.random.default_rng(13)
    q = np.concatenate([
        np.stack([point + np.float32([0.06, 0, 0]), point + np.float32([0.02, 0, 0]),
                  point + np.float32([0.25, 0, 2.0]), point + np.float32([0.262, 0, 2.0])]),
        point + rng.uniform(-0.05, 0.05, (508, 3)),
        point + np.float32([0, 0, 2.0]) + rng.uniform(-0.35, 0.35, (512, 3))])
    envs = envmod.broadcast_environment(env, 1)
    ok, _ = _pc_check(spec, envs, torch.as_tensor(q[None].astype(np.float32), device=cuda))
    assert ok[0, :4].tolist() == [True, False, False, True]


def _pc_wall_problem(device, B=2):
    """A planning problem on tests/test_kernel_branches.py's pck wall, with
    start and goal low on either side, so that no straight line joins them."""
    spec = registry.sphere_spec(lows=PC_WMIN, highs=PC_WMAX, radius=0.25)
    envs = envmod.broadcast_environment(_pck_env(spec, _wall_points(), 0.25, device), B)
    starts = torch.tensor([[-2.0, 1.5, 1.0]] * B, device=device)
    goals = (torch.tensor([[[2.0, -1.5, 1.0]]] * B, device=device)
             + torch.arange(B, device=device)[:, None, None] * 0.1)
    masks = torch.ones((B, 1), dtype=torch.bool, device=device)
    return spec, envs, starts, goals, masks


@pytest.mark.gpu
def test_rrtc_mega_pc_matches_plain(cuda):
    from vamp_mvt_tpu_torch.ops.kernels import rrtc_mega_cuda
    from vamp_mvt_tpu_torch.planning import rrtc, rrtc_mega

    spec, envs, starts, goals, masks = _pc_wall_problem(cuda)
    offs = torch.arange(2, device=cuda, dtype=torch.int32) * 100
    s = _wall_settings(4, 2, 2, max_iterations=1024, max_samples=512)
    got = rrtc_mega.plan_batch_mega(spec, envs, starts, goals, masks, s, offs, device=cuda)
    ctl, nodes0, _, _ = rrtc_mega.mega_inputs(spec, envs, starts, goals, masks, s, offs)
    _, _, work = rrtc_mega_cuda.plan(spec, envs, ctl, nodes0, s)
    ref = rrtc.plan_batch(spec, envs, starts, goals, masks, s, offs)
    torch.cuda.synchronize()
    assert bool(ref.solved.any())
    for f in ("solved", "iterations", "size_start", "size_goal", "path_length"):
        assert torch.equal(getattr(got, f).cpu(), getattr(ref, f).cpu()), f
    torch.testing.assert_close(got.cost, ref.cost, rtol=1e-6, atol=0)
    assert bool((work[:, 4] > 0).all()), "the planner scanned pointcloud points"


@pytest.mark.gpu
def test_simplify_mega_pc_matches_plain(cuda):
    from vamp_mvt_tpu_torch.ops.kernels import simplify_mega_cuda
    from vamp_mvt_tpu_torch.planning import rrtc, simplify, simplify_mega

    spec, envs, starts, goals, masks = _pc_wall_problem(cuda)
    pr = rrtc.plan_batch(spec, envs, starts, goals, masks,
                         _wall_settings(4, 2, 2, max_iterations=1024, max_samples=512))
    assert bool(pr.solved.all())
    ss = simplify.SimplifySettings()
    got = simplify_mega.simplify_batch_mega(spec, envs, pr.path, pr.path_length, ss,
                                            device=cuda)
    _, _, work = simplify_mega_cuda.simplify(spec, envs, pr.path.contiguous(),
                                             pr.path_length.to(torch.int32), ss)
    ref = simplify_mega.simplify_batch_plain(spec, envs, pr.path, pr.path_length, ss)
    torch.cuda.synchronize()
    assert torch.equal(got.path_length.cpu(), ref.path_length.cpu())
    torch.testing.assert_close(got.cost, ref.cost, rtol=1e-5, atol=0)
    assert bool((work[:, 3] > 0).all()), "the simplifier scanned pointcloud points"


@pytest.mark.gpu
def test_probe_gather_kernels_match_plain(cuda):
    from vamp_mvt_tpu_torch.probes import gather

    for name in gather.PROBES:
        table, idx, idx2 = gather.inputs(name, tiles=64, seed=11, device=cuda)
        before = gather.LAUNCHES
        got = gather.gather(name, table, idx, idx2)
        torch.cuda.synchronize()
        assert gather.LAUNCHES == before + 1
        assert torch.equal(got, gather.plain(name, table, idx, idx2)), name
