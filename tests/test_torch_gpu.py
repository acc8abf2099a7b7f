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


# Tile counts of the probe kernels' grid-stride tails: fewer tiles than one
# block's units, a partial last block and, for probe_gather.cu, more pieces
# than its persistent grid takes in one pass (4099 tiles: 1,049,344 pieces)
# and for dot_argmin more tiles than its grid's blocks on an H100 (2112).
# The other Mosaic kernels' later passes have a test of their own below.
TAIL_TILES = (1, 7, 64, 1000, 4099)


@pytest.mark.gpu
@pytest.mark.parametrize("tiles", TAIL_TILES)
def test_probe_gather_kernels_at_every_tile_count(cuda, tiles):
    from vamp_mvt_tpu_torch.probes import gather

    for name in gather.PROBES:
        table, idx, idx2 = gather.inputs(name, tiles=tiles, seed=tiles, device=cuda)
        got = gather.gather(name, table, idx, idx2)
        torch.cuda.synchronize()
        assert torch.equal(got, gather.plain(name, table, idx, idx2)), (name, tiles)


@pytest.mark.gpu
def test_probe_kernels_take_zero_tiles_and_misaligned_inputs(cuda):
    """0 tiles: empty outputs and no launch; an input 4 bytes past an
    aligned address is copied before the 128-bit loads."""
    from vamp_mvt_tpu_torch.probes import gather, mosaic

    for name in gather.PROBES:
        table, idx, idx2 = gather.inputs(name, tiles=0, seed=0, device=cuda)
        before = gather.LAUNCHES
        got = gather.gather(name, table, idx, idx2)
        assert gather.LAUNCHES == before and tuple(got.shape) == (0, 8, 128), name
    for name in mosaic.PROBES:
        ins = mosaic.inputs(name, 0, seed=0, device=cuda)
        before = mosaic.LAUNCHES
        outs = mosaic.run(name, *ins)
        assert mosaic.LAUNCHES == before and all(o.shape[0] == 0 for o in outs), name
    table, idx, _ = gather.inputs("row", tiles=3, seed=1, device=cuda)
    shifted = torch.empty(idx.numel() + 1, dtype=idx.dtype, device=cuda)
    shifted[1:] = idx.flatten()
    view = shifted[1:].view(idx.shape)
    assert view.data_ptr() % 16 != 0
    assert torch.equal(gather.gather("row", table, view), gather.plain("row", table, idx))
    mosaic.launch_empty(cuda)
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# The attachment and heightfield branches in all three kernels
# ---------------------------------------------------------------------------

CELL_BAND = 1e-4


def _terrain_env(shape, seed, device, scale=0.4):
    """One seeded heightfield of `shape` cells of `scale` m, centred at 0."""
    grid = np.random.default_rng(seed).uniform(0.2, 1.8, shape).astype(np.float32)
    meta, data = envmod.make_heightfield((0.0, 0.0, 0.0), (scale, scale, 1.0), grid)
    return envmod.EnvironmentBuilder().add_heightfield(meta, data).build(device=device)


def _cell_band(spec, envs, q):
    """(B, N) bool: a sphere centre at q (B, N, d), payload included, within
    CELL_BAND of a cell edge of its problem's fields."""
    from vamp_mvt_tpu_torch.collision import primitives
    from vamp_mvt_tpu_torch.ops import fkcc

    centers = fkcc.staged_centers(spec, envs.map(lambda t: t[:, None]), q)
    return primitives.heightfield_cell_band(envs.hf_meta[:, None], centers, CELL_BAND)


def _branch_check(spec, envs, q, band=None):
    """The fkcc kernel against its plain version: validity equal outside the
    contact band (and `band`); the vmin within 1e-4 (no pointcloud: the
    branches are value-exact).  Returns the kernel's validity."""
    before = fkcc_cuda.LAUNCHES
    vk = fkcc_cuda.fkcc_vmin(spec, envs, q)
    ok = fkcc_cuda.fkcc_batched(spec, envs, q)
    vp = fkcc_cuda.fkcc_vmin_plain(spec, envs, q)
    torch.cuda.synchronize()
    assert fkcc_cuda.LAUNCHES == before + 2
    assert torch.equal(ok, vk >= 0)
    skip = vp.abs() <= BAND if band is None else (vp.abs() <= BAND) | band
    mism = (vk >= 0) != (vp >= 0)
    print(f"{spec.name}: {int(mism.sum())} validity mismatches of {vk.numel()}, "
          f"{int(skip.sum())} in the bands, max |vmin diff| "
          f"{float((vk - vp).abs()[~skip].max()):.3g}")
    assert not (mism & ~skip).any()
    assert float((vk - vp).abs()[~skip].max()) < 1e-4
    return ok


def _panda_attach_envs(device):
    """Two Panda scenes with a sphere and a cuboid, each with its own payload
    (tests/test_kernel_branches.py's and a larger one)."""
    envs = []
    for spheres, pos in (([[0.0, 0.0, 0.09, 0.06], [0.05, 0.0, 0.14, 0.04]], [0.0, 0.0, 0.02]),
                         ([[0.0, 0.0, 0.2, 0.1], [0.0, 0.05, 0.1, 0.03]], [0.01, 0.0, 0.0])):
        b = envmod.EnvironmentBuilder()
        b.add_sphere([0.5, 0.0, 0.6], 0.18)
        b.add_cuboid(envmod.make_cuboid([0.0, 0.55, 0.4], [0.3, 0.2, 0.1], [0.2, 0.15, 0.1]))
        b.attach(envmod.make_attachment(spheres, tf_pos=pos))
        envs.append(b.build(device="cpu"))
    return envmod.stack_environments(envs).to(device)


@pytest.mark.gpu
def test_attachment_kernel_matches_plain(cuda):
    spec = registry.load("panda")
    envs = _panda_attach_envs(cuda)
    q = torch.as_tensor(np.random.default_rng(9).uniform(
        spec.limits_low, spec.limits_high, (2, 4096, 7)).astype(np.float32), device=cuda)
    ok = _branch_check(spec, envs, q)
    bare = _branch_check(spec, envs._replace(attachment=None), q)
    assert 0.0 < float(ok.float().mean()) < 1.0
    assert bool((bare & ~ok).any(1).all()), "each payload invalidates some configurations"
    # one payload shared by the batch (leaves of batch 1)
    one = envs._replace(attachment=envs.attachment._replace(
        **{f: getattr(envs.attachment, f)[:1] for f in envs.attachment._fields}))
    shared = fkcc_cuda.fkcc_batched(spec, one, q)
    assert torch.equal(shared[0], ok[0])
    # the sphere robot carrying a payload
    spec = registry.sphere_spec(lows=PC_WMIN, highs=PC_WMAX, radius=0.2)
    b = envmod.EnvironmentBuilder()
    for z in np.linspace(0.4, 5.6, 9):
        for y in np.linspace(-2.6, 2.6, 9):
            b.add_sphere([0.0, y, z], 0.3)
    b.attach(envmod.make_attachment([[0.0, 0.4, 0.0, 0.15]]))
    envs = envmod.broadcast_environment(b.build(device=cuda), 1)
    q = torch.as_tensor(np.random.default_rng(10).uniform(
        PC_WMIN, PC_WMAX, (1, 4096, 3)).astype(np.float32), device=cuda)
    assert 0.0 < float(_branch_check(spec, envs, q).float().mean()) < 1.0


@pytest.mark.gpu
def test_heightfield_kernel_matches_plain(cuda):
    # the sphere robot past the footprint of a 10 x 13 grid (C = 130): the
    # flat index clips to C - 1 (the XLA rule)
    spec = registry.sphere_spec(lows=PC_WMIN, highs=PC_WMAX, radius=0.25)
    envs = envmod.stack_environments([_terrain_env((10, 13), 21, "cpu"),
                                      _terrain_env((10, 13), 22, "cpu")]).to(cuda)
    q = torch.as_tensor(np.random.default_rng(23).uniform(
        [-5, -5, 0], [5, 5, 2.5], (2, 4096, 3)).astype(np.float32), device=cuda)
    ok = _branch_check(spec, envs, q, _cell_band(spec, envs, q))
    assert 0.0 < float(ok.float().mean()) < 1.0
    # Panda over a terrain of 250 x 250 cells of 1 cm, with a payload: every
    # sphere, payload included, against the heights (below the base within
    # 0.25 m of it, 0.2-0.6 m elsewhere; the grid off the origin by a third
    # of a cell, so that the base's spheres lie on no cell edge)
    spec = registry.load("panda")
    rng = np.random.default_rng(24)
    xy = (np.arange(250) - 125 + 0.5) * 0.01
    grid = rng.uniform(0.2, 0.6, (250, 250)).astype(np.float32)
    grid[np.hypot(*np.meshgrid(xy, xy)) < 0.25] = -0.1
    meta, data = envmod.make_heightfield((0.0033, 0.0033, 0.0), (0.01, 0.01, 1.0), grid)
    b = envmod.EnvironmentBuilder().add_heightfield(meta, data)
    b.attach(envmod.make_attachment([[0.0, 0.0, 0.12, 0.06]]))
    envs = envmod.broadcast_environment(b.build(device=cuda), 1)
    q = torch.as_tensor(rng.uniform(spec.limits_low, spec.limits_high, (1, 4096, 7))
                        .astype(np.float32), device=cuda)
    ok = _branch_check(spec, envs, q, _cell_band(spec, envs, q))
    assert 0.0 < float(ok.float().mean()) < 1.0


@pytest.mark.gpu
def test_oversized_payload_takes_exact_scan(cuda):
    """tests/test_kernel_branches.py's radius-class cases on the card: a
    payload below its class radius must not take the certain-hit bits, and
    one above every class radius (gate_ok = 0) must take the exact scan."""
    pc = np.asarray([[0.125, 0.125, 3.125]], np.float32)
    spec = registry.sphere_spec(lows=PC_WMIN, highs=PC_WMAX, radius=0.25)
    for local, r, x, want in (([0.6, 0.0, 0.0], 0.02, 0.06, True),
                              ([0.9, 0.0, 0.0], 0.4, 0.38, False)):
        att = envmod.tree_map(lambda a: torch.as_tensor(a, device=cuda),
                              envmod.make_attachment([[*local, r]]))
        envs = envmod.broadcast_environment(
            _pck_env(spec, pc, 0.25, cuda)._replace(attachment=att), 1)
        q = torch.tensor([[[0.125 + x - local[0], 0.125, 3.125]]], device=cuda)
        fkcc_cuda.PC_WORK = None
        ok = fkcc_cuda.fkcc_batched(spec, envs, q)
        work = fkcc_cuda.PC_WORK.tolist()
        plain = fkcc_cuda.fkcc_batched_plain(spec, envs, q)
        assert bool(ok[0, 0]) == bool(plain[0, 0]) == want
        if not want:
            assert work[2] > 0, "the oversized payload scanned the cloud's points"


def _branch_problems(device, B=2):
    """tests/test_kernel_branches.py's planning problems on a heightfield and
    with a payload, B copies each."""
    spec_h = registry.sphere_spec(lows=PC_WMIN, highs=PC_WMAX, radius=0.25)
    grid = np.random.default_rng(11).uniform(0.2, 2.2, (16, 16)).astype(np.float32)
    meta, data = envmod.make_heightfield((0.0, 0.0, 0.0), (0.4, 0.4, 1.0), grid)
    env_h = envmod.EnvironmentBuilder().add_heightfield(meta, data).build(device=device)
    spec_a = registry.sphere_spec(lows=PC_WMIN, highs=PC_WMAX, radius=0.2)
    b = envmod.EnvironmentBuilder()
    for z in np.linspace(0.4, 5.6, 9):
        for y in np.linspace(-2.6, 2.6, 9):
            if abs(y) < 1.2 and abs(z - 3.0) < 1.2:
                continue
            b.add_sphere([0.0, y, z], 0.3)
    b.attach(envmod.make_attachment([[0.0, 0.4, 0.0, 0.15]]))
    env_a = b.build(device=device)
    masks = torch.ones((B, 1), dtype=torch.bool, device=device)
    out = {}
    for name, spec, env, s, g, rng_ in (
            ("heightfield", spec_h, env_h, [-2.5, -2.5, 3.2], [2.5, 2.5, 3.2], 1.2),
            ("attachment", spec_a, env_a, [-2.0, 0.0, 3.0], [2.0, 0.0, 3.0], 1.0)):
        out[name] = (spec, envmod.broadcast_environment(env, B),
                     torch.tensor([s] * B, device=device), torch.tensor([[g]] * B, device=device),
                     masks, _wall_settings(4, 2, 2, range=rng_, max_iterations=384,
                                           max_samples=512))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["heightfield", "attachment"])
def test_megakernels_branches_match_plain(cuda, which):
    from vamp_mvt_tpu_torch.planning import rrtc, rrtc_mega, simplify, simplify_mega

    spec, envs, starts, goals, masks, s = _branch_problems(cuda)[which]
    offs = torch.arange(2, device=cuda, dtype=torch.int32) * 100
    got = rrtc_mega.plan_batch_mega(spec, envs, starts, goals, masks, s, offs, device=cuda)
    ref = rrtc.plan_batch(spec, envs, starts, goals, masks, s, offs)
    torch.cuda.synchronize()
    assert bool(ref.solved.any())
    for f in ("solved", "iterations", "size_start", "size_goal", "path_length"):
        assert torch.equal(getattr(got, f).cpu(), getattr(ref, f).cpu()), f
    torch.testing.assert_close(got.cost, ref.cost, rtol=1e-6, atol=0)
    ss = simplify.SimplifySettings()
    ks = simplify_mega.simplify_batch_mega(spec, envs, ref.path, ref.path_length, ss,
                                           device=cuda)
    ps = simplify_mega.simplify_batch_plain(spec, envs, ref.path, ref.path_length, ss)
    assert torch.equal(ks.path_length.cpu(), ps.path_length.cpu())
    torch.testing.assert_close(ks.cost, ps.cost, rtol=1e-5, atol=0)


# ---------------------------------------------------------------------------
# The megakernel-construct probes (P2, P3)
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_probe_mosaic_kernels_match_plain(cuda):
    from vamp_mvt_tpu_torch.probes import mosaic

    for name in mosaic.PROBES:
        ins = mosaic.inputs(name, tiles=64, seed=12, device=cuda)
        before = mosaic.LAUNCHES
        got = mosaic.run(name, *ins)
        torch.cuda.synchronize()
        assert mosaic.LAUNCHES == before + 1
        want = mosaic.plain(name, *ins)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), name
        assert mosaic.tile0_ok(name, got), name


@pytest.mark.gpu
@pytest.mark.parametrize("tiles", TAIL_TILES)
def test_probe_mosaic_kernels_at_every_tile_count(cuda, tiles):
    from vamp_mvt_tpu_torch.probes import mosaic

    for name in mosaic.PROBES:
        ins = mosaic.inputs(name, tiles=tiles, seed=tiles, device=cuda)
        got = mosaic.run(name, *ins)
        torch.cuda.synchronize()
        want = mosaic.plain(name, *ins)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), (name, tiles)
        assert mosaic.tile0_ok(name, got), (name, tiles)


# Threads a tile of the Mosaic kernels, all of which stride over their
# units (probe_mosaic.cu: `probe_units` of probe_kernel, probe_tiles_kernel's
# warp a tile or thread a 16-byte piece).  dot_argmin_kernel takes a block
# of 256 a tile in a grid of at most kArgWaves (4) times its resident
# blocks, so a tile counts 256 / 4 threads against the resident ones.
GRID_STRIDE_THREADS = {
    "while_carry": 32, "dyn_sublane": 32, "nested_loops": 32, "dyn_rows_while": 32,
    "smem_int_out": 32, "scratch_diag": 8, "halton_digits": 64, "smem_writes": 1,
    "grid_carry": 1, "static_reads": 1, "group32_sum": 32, "reduce_while": 32,
    "cumsum_first": 32, "transpose": 16, "dot_argmin": 64,
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(GRID_STRIDE_THREADS))
def test_probe_mosaic_kernels_take_a_second_grid_pass(cuda, name):
    """More units than the card holds threads at once (every SM full), so
    the grid, at most that many threads (dot_argmin: four times as many),
    strides over them at least twice, the last pass partial (7 tiles past a
    whole pass)."""
    from vamp_mvt_tpu_torch.probes import mosaic

    props = torch.cuda.get_device_properties(cuda)
    resident = props.multi_processor_count * getattr(
        props, "max_threads_per_multi_processor", 2048)
    tiles = resident // GRID_STRIDE_THREADS[name] + 7
    ins = mosaic.inputs(name, tiles=tiles, seed=5, device=cuda)
    got = mosaic.run(name, *ins)
    torch.cuda.synchronize()
    want = mosaic.plain(name, *ins)
    assert all(torch.equal(g, w) for g, w in zip(got, want)), (name, tiles)
    assert mosaic.tile0_ok(name, got), (name, tiles)


# ---------------------------------------------------------------------------
# The megakernels on the other robots, the roadmap planners on the card
# ---------------------------------------------------------------------------


def _robot_problems(spec, device, n=16, seed=30, keep=3):
    """The first `keep` of `n` MBM-shaped scenes (`bench.scenes`, placed for
    the Panda: most block every Fetch and Baxter configuration) that have
    two valid configurations among 2048 seeded ones; start and goal the
    first two the fkcc kernel finds."""
    from vamp_mvt_tpu_torch.bench import mbm, scenes

    envs = mbm.build_batch(scenes.mbm_shaped_problems(n, seed), device=device)[0]
    q = scenes.seeded_configs(spec, n, 2048, seed + 1, device)
    rows, starts, goals, masks = scenes.first_two_valid(
        q, fkcc_cuda.fkcc_batched(spec, envs, q), keep)
    return envs.map(lambda t: t[rows]), starts, goals, masks


@pytest.mark.gpu
@pytest.mark.parametrize("robot", ["fetch", "baxter"])
def test_megakernels_other_robots_match_plain(cuda, robot, monkeypatch):
    """Both megakernels against their plain versions on Fetch and Baxter at
    run_suite's mega settings (a smaller budget), the plain planner's
    nearest-neighbour dots summed in index order as the kernel sums them
    (rrtc.IndexOrderTorch), so that the two agree exactly."""
    from vamp_mvt_tpu_torch.bench import mbm
    from vamp_mvt_tpu_torch.ops.kernels import rrtc_mega_cuda, simplify_mega_cuda
    from vamp_mvt_tpu_torch.planning import rrtc, rrtc_mega, simplify, simplify_mega

    spec = registry.load(robot)
    envs, starts, goals, masks = _robot_problems(spec, cuda)
    assert len(starts) >= 2
    s = dataclasses.replace(mbm.default_settings(robot, "mega"), max_iterations=1024,
                            max_samples=4096)
    got = rrtc_mega.plan_batch_mega(spec, envs, starts, goals, masks, s, device=cuda)
    torch.cuda.synchronize()
    launch = dict(rrtc_mega_cuda.LAST_LAUNCH)
    print(f"{robot}: rrtc_mega {launch}")
    assert launch["threads"] in fkcc_cuda.MEGA_THREADS and launch["blocks_per_sm"] >= 1
    monkeypatch.setattr(rrtc, "torch", rrtc.IndexOrderTorch())
    ref = rrtc.plan_batch(spec, envs, starts, goals, masks, s)
    monkeypatch.undo()
    for f in ("solved", "iterations", "size_start", "size_goal", "path_length"):
        assert torch.equal(getattr(got, f).cpu(), getattr(ref, f).cpu()), f
    torch.testing.assert_close(got.cost, ref.cost, rtol=1e-6, atol=0)
    assert bool(ref.solved.any())
    ss = simplify.SimplifySettings(pair_chunk=64)
    ks = simplify_mega.simplify_batch_mega(spec, envs, ref.path, ref.path_length, ss,
                                           device=cuda)
    torch.cuda.synchronize()
    print(f"{robot}: simplify_mega {dict(simplify_mega_cuda.LAST_LAUNCH)}")
    ps = simplify_mega.simplify_batch_plain(spec, envs, ref.path, ref.path_length, ss)
    assert torch.equal(ks.path_length.cpu(), ps.path_length.cpu())
    torch.testing.assert_close(ks.cost, ps.cost, rtol=1e-5, atol=0)


@pytest.mark.gpu
def test_roadmap_planners_card_match_cpu(cuda):
    """PRM, FCIT and the roadmap on tests/test_planners.py's sphere-robot
    wall: on the card (the fkcc kernel) and on the CPU (its plain version)
    the same results."""
    import vamp_mvt_tpu_torch as vmt

    env = vmt.Environment()
    for y in np.linspace(-3, 3, 13):
        for z in np.linspace(0, 3, 7):
            if not (y > 2.0 and z > 2.0):
                env.add_sphere(vmt.Sphere([0.0, y, z], 0.3))
    start, goal = [-4.0, 0.0, 1.0], [4.0, 0.0, 1.0]
    for call in (lambda d: vmt.sphere.prm(start, goal, env, vmt.PRMSettings(max_samples=1024),
                                          device=d),
                 lambda d: vmt.sphere.fcit(start, goal, env, vmt.FCITSettings(
                     max_samples=256, batch_size=64), device=d)):
        before = fkcc_cuda.LAUNCHES
        card = call(cuda)
        assert fkcc_cuda.LAUNCHES > before
        cpu = call("cpu")
        assert card.solved and (card.solved, card.iterations, card.size) == \
            (cpu.solved, cpu.iterations, cpu.size)
        np.testing.assert_allclose(card.path, cpu.path, rtol=0, atol=1e-6)
    rs = vmt.PRMSettings(max_samples=256)
    card, cpu = (vmt.sphere.roadmap(start, goal, env, rs, device=d) for d in (cuda, "cpu"))
    np.testing.assert_array_equal(card.vertices, cpu.vertices)
    assert card.edges == cpu.edges


@pytest.mark.gpu
@pytest.mark.parametrize("k,c,w", [(1, 1, 1), (4, 2, 2)])
def test_rrtc_mega_interleave_matches_plain(cuda, k, c, w):
    """The interleaved cadence (grow every step, an active chain riding
    along) on the wall problem: the kernel equals its plain version, the
    lockstep planner with interleave=True, exactly."""
    from vamp_mvt_tpu_torch.ops.kernels import rrtc_mega_cuda
    from vamp_mvt_tpu_torch.planning import rrtc, rrtc_mega

    spec, envs, starts, goals, masks = _wall(cuda)
    offs = torch.arange(3, device=cuda, dtype=torch.int32) * 100
    s = _wall_settings(k, c, w, interleave=True)
    before = rrtc_mega_cuda.LAUNCHES
    got = rrtc_mega.plan_batch_mega(spec, envs, starts, goals, masks, s, offs, device=cuda)
    torch.cuda.synchronize()
    assert rrtc_mega_cuda.LAUNCHES == before + 1
    ref = rrtc.plan_batch_compact(spec, envs, starts, goals, masks, s, offs, device=cuda,
                                  interleave=True)
    assert bool(ref.solved.any())
    for f in ("solved", "iterations", "size_start", "size_goal", "path_length"):
        assert torch.equal(getattr(got, f).cpu(), getattr(ref, f).cpu()), f
    torch.testing.assert_close(got.cost, ref.cost, rtol=1e-6, atol=0)
    for i in range(3):
        L = int(ref.path_length[i])
        torch.testing.assert_close(got.path[i, :L], ref.path[i, :L], rtol=0, atol=1e-6)


@pytest.mark.gpu
def test_rrtc_mega_interleave_matches_plain_on_cages(cuda, monkeypatch):
    """The interleaved kernel on 16 Panda sphere cages at run_suite's mega
    settings against its plain version, whose nearest-neighbour dots are
    summed in index order as the kernel sums them (rrtc.IndexOrderTorch)."""
    from vamp_mvt_tpu_torch.bench import mbm
    from vamp_mvt_tpu_torch.planning import rrtc, rrtc_mega

    spec = registry.load("panda")
    envs, starts, goals, masks = mbm.build_batch(mbm.cage_suite(16)["problems"]["cage"],
                                                 device=cuda)
    s = dataclasses.replace(mbm.default_settings("panda", "mega"), interleave=True)
    got = rrtc_mega.plan_batch_mega(spec, envs, starts, goals, masks, s, device=cuda)
    torch.cuda.synchronize()
    monkeypatch.setattr(rrtc, "torch", rrtc.IndexOrderTorch())
    ref = rrtc.plan_batch_compact(spec, envs, starts, goals, masks, s, device=cuda,
                                  interleave=True)
    monkeypatch.undo()
    assert bool(ref.solved.any())
    for f in ("solved", "iterations", "size_start", "size_goal", "path_length"):
        assert torch.equal(getattr(got, f).cpu(), getattr(ref, f).cpu()), f
    torch.testing.assert_close(got.cost, ref.cost, rtol=1e-6, atol=0)


def _cloud_env(kind):
    """The sphere cage as a cloud of 150 points on each sphere, built as an
    MVT or a CAPT structure through the user API (no kernel form)."""
    import vamp_mvt_tpu_torch as vmt
    from vamp_mvt_tpu_torch.bench import mbm

    i = np.arange(150) + 0.5
    phi, th = np.arccos(1 - 2 * i / 150), np.pi * (1 + 5 ** 0.5) * i
    unit = np.stack([np.cos(th) * np.sin(phi), np.sin(th) * np.sin(phi), np.cos(phi)], 1)
    pts = np.concatenate([np.asarray(c) + mbm.CAGE_RADIUS * unit
                          for c in mbm.CAGE_CENTERS]).astype(np.float32)
    env = vmt.Environment()
    r_min, r_max = vmt.panda.min_max_radii()
    if kind == "mvt":
        env.add_mvt_pointcloud(pts, r_min, r_max, (-1.0, -1.0, -0.5), (1.0, 1.0, 1.5), R_POINT)
    else:
        env.add_capt_pointcloud(pts, r_min, r_max, R_POINT)
    return env


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["capt", "mvt"])
def test_api_with_mvt_or_capt_cloud_on_the_card(cuda, kind):
    """An MVT or CAPT cloud without its kernel form: no kernel reads it
    (fkcc_cuda.supports), so on the card validate and rrtc take the plain
    version there, as the JAX package takes its XLA path; they run without
    raising and equal their device="cpu" results."""
    import vamp_mvt_tpu_torch as vmt
    from vamp_mvt_tpu_torch.bench import profile_suite

    env = _cloud_env(kind)
    _, A, B = profile_suite.api_cage()
    assert not fkcc_cuda.supports(env.build(cuda))
    res = {}
    for d in (None, "cpu"):
        res[d] = ([vmt.panda.validate(x, env, device=d) for x in (A, B, [0.0] * 7)],
                  vmt.panda.rrtc(A, B, env, device=d))
    (v_card, r_card), (v_cpu, r_cpu) = res[None], res["cpu"]
    assert v_card == v_cpu and v_card[:2] == [True, True]
    assert bool(r_card.solved) and bool(r_cpu.solved)
    for f in ("iterations", "path_length", "size_start", "size_goal"):
        assert int(getattr(r_card, f)) == int(getattr(r_cpu, f)), f
    L = int(r_cpu.path_length)
    torch.testing.assert_close(r_card.path[:L].cpu(), r_cpu.path[:L], rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# Both megakernels at every launch shape's group size G (lanes of a warp a
# configuration): the same results as their plain versions at each
# ---------------------------------------------------------------------------


def _every_group(cuda, monkeypatch, spec, envs, starts, goals, masks, s, offs=None):
    """Both megakernels against their plain versions (the planner's
    nearest-neighbour dots in index order, rrtc.IndexOrderTorch, as the
    kernel sums them) at every G of fkcc_cuda.MEGA_GROUPS, each with the
    threads the launch shape picks for it: solved flags, iterations, tree
    sizes and path lengths equal, costs within rtol 1e-6 (planner) and 1e-5
    (simplifier).  Returns each G's launch shapes."""
    from vamp_mvt_tpu_torch.ops.kernels import rrtc_mega_cuda, simplify_mega_cuda
    from vamp_mvt_tpu_torch.planning import rrtc, rrtc_mega, simplify, simplify_mega

    monkeypatch.setattr(rrtc, "torch", rrtc.IndexOrderTorch())
    ref = rrtc.plan_batch_compact(spec, envs, starts, goals, masks, s, offs, device=cuda,
                                  interleave=s.interleave)
    monkeypatch.undo()
    assert bool(ref.solved.any())
    ss = simplify.SimplifySettings(pair_chunk=64)
    sref = simplify_mega.simplify_batch_plain(spec, envs, ref.path, ref.path_length, ss)
    shapes = {}
    for G in fkcc_cuda.MEGA_GROUPS:
        got = rrtc_mega.plan_batch_mega(spec, envs, starts, goals, masks, s, offs, device=cuda,
                                        shape=(None, G))
        torch.cuda.synchronize()
        launch = dict(rrtc_mega_cuda.LAST_LAUNCH)
        assert launch["group"] == G
        for f in ("solved", "iterations", "size_start", "size_goal", "path_length"):
            assert torch.equal(getattr(got, f).cpu(), getattr(ref, f).cpu()), (G, f)
        torch.testing.assert_close(got.cost, ref.cost, rtol=1e-6, atol=0, msg=f"G={G}")
        ks = simplify_mega.simplify_batch_mega(spec, envs, ref.path, ref.path_length, ss,
                                               device=cuda, shape=(None, G))
        torch.cuda.synchronize()
        assert simplify_mega_cuda.LAST_LAUNCH["group"] == G
        assert torch.equal(ks.path_length.cpu(), sref.path_length.cpu()), G
        torch.testing.assert_close(ks.cost, sref.cost, rtol=1e-5, atol=0, msg=f"G={G}")
        shapes[G] = (launch, dict(simplify_mega_cuda.LAST_LAUNCH))
    print(f"{spec.name}: {shapes}")
    return shapes


@pytest.mark.gpu
@pytest.mark.parametrize("interleave", [False, True])
@pytest.mark.parametrize("k,c,w", [(1, 1, 1), (4, 2, 2)])
def test_megakernels_every_group_on_the_wall(cuda, monkeypatch, k, c, w, interleave):
    spec, envs, starts, goals, masks = _wall(cuda)
    offs = torch.arange(3, device=cuda, dtype=torch.int32) * 100
    _every_group(cuda, monkeypatch, spec, envs, starts, goals, masks,
                 _wall_settings(k, c, w, interleave=interleave), offs)


@pytest.mark.gpu
def test_megakernels_every_group_on_cages(cuda, monkeypatch):
    """64 Panda sphere cages at run_suite's mega settings; the shape the
    chooser picks keeps more than four warps an SM."""
    from vamp_mvt_tpu_torch.bench import mbm
    from vamp_mvt_tpu_torch.ops.kernels import rrtc_mega_cuda, simplify_mega_cuda

    spec = registry.load("panda")
    envs, starts, goals, masks = mbm.build_batch(mbm.cage_suite(64)["problems"]["cage"],
                                                 device=cuda)
    s = mbm.default_settings("panda", "mega")
    _every_group(cuda, monkeypatch, spec, envs, starts, goals, masks, s)
    assert rrtc_mega_cuda.launch_shape(spec, envs, s)["warps_per_sm"] > 4
    assert simplify_mega_cuda.launch_shape(spec, envs, s.max_path)["warps_per_sm"] > 4


def _panda_draws(spec, envs, device, seed):
    """Start and goal of each of `envs`' problems: the first two of 2048
    seeded configurations the fkcc kernel finds valid there."""
    from vamp_mvt_tpu_torch.bench import scenes

    q = scenes.seeded_configs(spec, envs.spheres.shape[0], 2048, seed, device)
    rows, starts, goals, masks = scenes.first_two_valid(q, fkcc_cuda.fkcc_batched(spec, envs, q))
    assert rows == list(range(envs.spheres.shape[0]))
    return starts, goals, masks


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["payload", "terrain"])
def test_megakernels_every_group_on_panda_branches(cuda, monkeypatch, which):
    """The Panda with a payload (two scenes, each its own) and over a
    terrain (a 40 x 40 heightfield of 5 cm cells under a sphere and a
    cuboid)."""
    from vamp_mvt_tpu_torch.bench import mbm

    spec = registry.load("panda")
    if which == "payload":
        envs = _panda_attach_envs(cuda)
    else:
        grid = np.random.default_rng(13).uniform(0.0, 0.15, (40, 40)).astype(np.float32)
        meta, data = envmod.make_heightfield((0.0, 0.0, -0.2), (0.05, 0.05, 1.0), grid)
        b = envmod.EnvironmentBuilder().add_heightfield(meta, data)
        b.add_sphere([0.5, 0.0, 0.6], 0.18)
        b.add_cuboid(envmod.make_cuboid([0.0, 0.55, 0.4], [0.3, 0.2, 0.1], [0.2, 0.15, 0.1]))
        envs = envmod.broadcast_environment(b.build(device=cuda), 2)
    starts, goals, masks = _panda_draws(spec, envs, cuda, seed=14)
    s = dataclasses.replace(mbm.default_settings("panda", "mega"), max_iterations=1024,
                            max_samples=4096)
    _every_group(cuda, monkeypatch, spec, envs, starts, goals, masks, s)


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["heightfield", "attachment"])
def test_megakernels_every_group_on_sphere_branches(cuda, monkeypatch, which):
    spec, envs, starts, goals, masks, s = _branch_problems(cuda)[which]
    offs = torch.arange(2, device=cuda, dtype=torch.int32) * 100
    _every_group(cuda, monkeypatch, spec, envs, starts, goals, masks, s, offs)


@pytest.mark.gpu
def test_megakernels_every_group_on_clouds(cuda, monkeypatch):
    """The sphere robot through the pck wall, and four Panda problems in
    MBM-shaped clouds (run_suite_pointcloud's pipeline, 10,000 samples an
    object) at run_suite_pointcloud's settings with a smaller budget."""
    from vamp_mvt_tpu_torch.bench import mbm, scenes
    from vamp_mvt_tpu_torch.pointcloud import pipeline

    spec, envs, starts, goals, masks = _pc_wall_problem(cuda)
    offs = torch.arange(2, device=cuda, dtype=torch.int32) * 100
    _every_group(cuda, monkeypatch, spec, envs, starts, goals, masks,
                 _wall_settings(4, 2, 2, max_iterations=1024, max_samples=512), offs)
    spec = registry.load("panda")
    problems = [dict(p, sphere=[]) for p in scenes.mbm_shaped_problems(4, seed=1)]
    envs = envmod.stack_environments([envmod.EnvironmentBuilder(
        pck=pipeline.problem_to_pointcloud_env("panda", p, pc_repr="capt")[0].pck).build(
            device="cpu") for p in problems]).to(cuda)
    q = scenes.seeded_configs(spec, 4, 2048, 15, cuda)
    rows, starts, goals, masks = scenes.first_two_valid(q, fkcc_cuda.fkcc_batched(spec, envs, q))
    assert len(rows) >= 2
    envs = envs.map(lambda t: t[rows])
    s = dataclasses.replace(mbm.pointcloud_settings("panda"), max_iterations=1024)
    _every_group(cuda, monkeypatch, spec, envs, starts, goals, masks, s)


@pytest.mark.gpu
@pytest.mark.parametrize("robot", ["fetch", "baxter"])
def test_megakernels_every_group_other_robots(cuda, monkeypatch, robot):
    from vamp_mvt_tpu_torch.bench import mbm

    spec = registry.load(robot)
    envs, starts, goals, masks = _robot_problems(spec, cuda)
    s = dataclasses.replace(mbm.default_settings(robot, "mega"), max_iterations=1024,
                            max_samples=4096)
    _every_group(cuda, monkeypatch, spec, envs, starts, goals, masks, s)


# ---------------------------------------------------------------------------
# fkcc at every lane-group size and at the launch shapes of the paths
# ---------------------------------------------------------------------------

# (B, N): the bench path's start/goal validity, PRM's sample wave, one
# lockstep step of the API's planner, a block of the kernel phase, an AOX
# segment check of panda.aorrtc and of a 32-problem solve_batch round, one
# REDUCE pass over 64 paths
FKCC_PATH_SHAPES = [(700, 2), (1, 64), (1, 480), (64, 1024), (1, 40), (32, 40), (64, 440)]


def _fkcc_tables(which, B, device):
    """B problems of one branch: eight seeded scenes with every primitive
    table, the two payload scenes, a Panda terrain of 250 x 250 cells with
    a payload, or two Panda wall clouds of different sizes, repeated."""
    spec = registry.load("panda")
    if which == "primitives":
        envs = _scenes(8, seed=40)
    elif which == "attachment":
        envs = _panda_attach_envs("cpu")
    elif which == "heightfield":
        rng = np.random.default_rng(41)
        xy = (np.arange(250) - 125 + 0.5) * 0.01
        grid = rng.uniform(0.2, 0.6, (250, 250)).astype(np.float32)
        grid[np.hypot(*np.meshgrid(xy, xy)) < 0.25] = -0.1
        meta, data = envmod.make_heightfield((0.0033, 0.0033, 0.0), (0.01, 0.01, 1.0), grid)
        b = envmod.EnvironmentBuilder().add_heightfield(meta, data)
        b.attach(envmod.make_attachment([[0.0, 0.0, 0.12, 0.06]]))
        envs = envmod.broadcast_environment(b.build(device="cpu"), 1)
    else:
        pts = _wall_points()
        pts = pts[pts[:, 2] < 1.5] * np.float32(0.4) + np.float32([0.45, 0, 0.2])
        dense = _wall_points(40)
        dense = dense[dense[:, 2] < 1.5] * np.float32(0.4) + np.float32([0.35, 0.1, 0.2])
        envs = envmod.stack_environments([_pck_env(spec, p, spec.max_radius, "cpu")
                                          for p in (pts, dense)])
    idx = torch.arange(B) % envs.spheres.shape[0]
    return spec, envs.map(lambda t: t[idx].contiguous()).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("B,N", FKCC_PATH_SHAPES)
@pytest.mark.parametrize("which", ["primitives", "attachment", "heightfield", "pointcloud"])
def test_fkcc_every_group_matches_plain(cuda, which, B, N):
    """fkcc at every G (the override (None, G)), in both layouts, against
    its plain version: validity equal outside the contact band (and the
    heightfield's cell band); vmin within 1e-4 of the plain value and equal
    at every G (a min over the same values), except on a pointcloud, where
    the kernel is sign-exact."""
    spec, envs = _fkcc_tables(which, B, cuda)
    q = torch.as_tensor(np.random.default_rng(42 + N).uniform(
        spec.limits_low, spec.limits_high, (B, N, 7)).astype(np.float32), device=cuda)
    q_d = q.transpose(1, 2).contiguous()
    vp = fkcc_cuda.fkcc_vmin_plain(spec, envs, q)
    skip = vp.abs() <= BAND
    if which == "heightfield":
        skip |= _cell_band(spec, envs, q)
    first = None
    for G in fkcc_cuda.MEGA_GROUPS:
        vk = fkcc_cuda.fkcc_vmin(spec, envs, q, shape=(None, G))
        assert fkcc_cuda.LAST_LAUNCH["group"] == G
        rows = fkcc_cuda.fkcc_batched(spec, envs, q, shape=(None, G))
        lanes = fkcc_cuda.fkcc_batched_lanes(spec, envs, q_d, shape=(None, G))
        torch.cuda.synchronize()
        assert torch.equal(rows, vk >= 0) and torch.equal(lanes, rows), G
        mism = ((vk >= 0) != (vp >= 0)) & ~skip
        assert not mism.any(), f"G {G}: {int(mism.sum())} validity mismatches outside the bands"
        if which != "pointcloud":
            assert float((vk - vp).abs()[~skip].max()) < 1e-4, G
            first = vk if first is None else first
            assert torch.equal(vk, first), f"vmin at G {G} differs from G 1"
    shape = fkcc_cuda.fkcc_shape(spec, envs, B, N)
    fkcc_cuda.fkcc_batched(spec, envs, q)
    assert {k: fkcc_cuda.LAST_LAUNCH[k] for k in ("threads", "group", "smem_bytes")} == {
        k: shape[k] for k in ("threads", "group", "smem_bytes")}
    assert fkcc_cuda.LAST_LAUNCH["blocks_per_sm"] >= shape["blocks_per_sm"]


@pytest.mark.gpu
def test_fkcc_sees_tables_changed_in_place(cuda):
    """The wrapper reuses an Environment's packed table arguments: a payload
    grown in place, and a shape row moved in place, still reach the kernel,
    which keeps matching its plain version."""
    spec = registry.load("panda")
    envs = _panda_attach_envs(cuda)
    q = torch.as_tensor(np.random.default_rng(43).uniform(
        spec.limits_low, spec.limits_high, (2, 2048, 7)).astype(np.float32), device=cuda)
    before = fkcc_cuda.fkcc_batched(spec, envs, q)
    for change in (lambda: envs.attachment.spheres[..., 3].mul_(1.5),
                   lambda: envs.spheres[:, 0, 2].sub_(0.2)):
        change()
        vk = fkcc_cuda.fkcc_vmin(spec, envs, q)
        vp = fkcc_cuda.fkcc_vmin_plain(spec, envs, q)
        torch.cuda.synchronize()
        assert not (((vk >= 0) != (vp >= 0)) & (vp.abs() > BAND)).any()
    assert not torch.equal(fkcc_cuda.fkcc_batched(spec, envs, q), before)


def _wall_problem(device, B=3):
    """tests/test_planners.py's sphere-robot wall for B problems (goals
    0.05 apart), on `device`."""
    b = envmod.EnvironmentBuilder()
    for y in np.linspace(-3, 3, 13):
        for z in np.linspace(0, 3, 7):
            if not (y > 2.0 and z > 2.0):
                b.add_sphere([0.0, y, z], 0.3)
    envs = envmod.broadcast_environment(b.build(device=device), B)
    starts = torch.tensor([[-2.0, 0.0, 1.0]] * B, device=device)
    goals = torch.tensor([[[2.0, 0.0, 1.0]]] * B, device=device) \
        + torch.arange(B, device=device, dtype=torch.float32)[:, None, None] * 0.05
    return (registry.sphere_spec(lows=(-3, -3, 0), highs=(3, 3, 3), radius=0.1), envs, starts,
            goals, torch.ones((B, 1), dtype=torch.bool, device=device))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["aox_step", "aox_batch", "simplify_reduce"])
def test_fkcc_at_aorrtc_shapes_matches_plain(cuda, case):
    """fkcc at the AORRTC path's launch shapes (bench/time_fkcc.py's cases:
    an AOX segment check in the sphere cage, 1 x 40; a solve_batch round on
    32 cages, 32 x 40; a REDUCE pass over 64 cages, 64 x 440 lanes), at the
    chooser's shape: no validity mismatch outside the contact band."""
    from vamp_mvt_tpu_torch.bench import time_fkcc

    spec, envs, q, layout = time_fkcc.path_cases(cuda, (case,))[case]
    qr = q if layout == "rows" else q.transpose(1, 2).contiguous()
    before = fkcc_cuda.LAUNCHES
    ok = time_fkcc.launcher(spec, envs, q, layout)()
    torch.cuda.synchronize()
    assert fkcc_cuda.LAUNCHES == before + 1
    vp = fkcc_cuda.fkcc_vmin_plain(spec, envs, qr)
    mism = (ok != (vp >= 0)) & (vp.abs() > BAND)
    print(f"{case}: {tuple(qr.shape)} {dict(fkcc_cuda.LAST_LAUNCH)}, valid share "
          f"{float(ok.float().mean()):.3f}")
    assert not mism.any()


@pytest.mark.gpu
def test_aox_and_solve_batch_card_match_cpu(cuda):
    """AOX searches and AORRTC's solve_batch on the wall problem without PHS
    sampling: the card (the fkcc kernel) and the CPU (its plain version)
    give the same searches and results (integer Halton and threefry draws,
    the same float32 sums); with PHS every solved path of the card
    validates."""
    from vamp_mvt_tpu_torch.planning import aorrtc, aox, rrtc, validate

    base = dict(range=1.0, max_iterations=512, max_samples=512, max_path=64)
    out = []
    for dev in (cuda, torch.device("cpu")):
        spec, envs, st, gl, mk = _wall_problem(dev)
        before = fkcc_cuda.LAUNCHES
        a = aox.solve_batch(spec, envs, st, gl, mk, rrtc.RRTCSettings(**base),
                            torch.tensor([9.0, 7.5, 8.2]),
                            torch.arange(3) * 100, device=dev)
        s = aorrtc.AORRTCSettings(rrtc=rrtc.RRTCSettings(**base), max_iterations=1536,
                                  max_internal_iterations=512, use_phs=False)
        b = aorrtc.solve_batch(spec, envs, st, gl, mk, s, history=True, device=dev)
        out.append((a, b))
        if dev == cuda:
            assert fkcc_cuda.LAUNCHES > before
    (ka, kb), (pa, pb) = out
    for f in ("solved", "iterations", "size_start", "size_goal", "sample_count", "path_length"):
        assert torch.equal(getattr(ka, f).cpu(), getattr(pa, f)), f
    torch.testing.assert_close(ka.cost.cpu(), pa.cost, rtol=1e-5, atol=0)
    assert torch.equal(kb[0].path_length.cpu(), pb[0].path_length)
    assert torch.equal(kb[1].cpu(), pb[1])
    np.testing.assert_allclose(kb[2], pb[2], rtol=1e-5)
    spec, envs, st, gl, mk = _wall_problem(cuda)
    s = aorrtc.AORRTCSettings(rrtc=rrtc.RRTCSettings(**base), max_iterations=1536,
                              max_internal_iterations=512)
    res, _ = aorrtc.solve_batch(spec, envs, st, gl, mk, s, device=cuda)
    num = validate.n_points_bound(spec, float(np.linalg.norm(spec.limits_high - spec.limits_low)))
    for i in range(3):
        L = int(res.path_length[i])
        if L:
            p = res.path[i : i + 1, :L].cpu()
            assert bool(validate.validate_motion_batch(
                spec, envs.map(lambda t: t[i : i + 1]).to("cpu"), p[:, :-1], p[:, 1:], num).all())


@pytest.mark.gpu
def test_reduce_perturb_card_match_cpu(cuda):
    """REDUCE and PERTURB (with SHORTCUT and BSPLINE) on the wall problem's
    planned paths: the card and the CPU give the same lengths, iterations
    and paths."""
    from vamp_mvt_tpu_torch.planning import rrtc, simplify

    spec, envs, st, gl, mk = _wall_problem("cpu")
    plan = rrtc.plan_batch(spec, envs, st, gl, mk, rrtc.RRTCSettings(
        range=1.0, max_iterations=1024, max_samples=512, max_path=64, samples_per_step=4,
        connect_segments=2, sample_window=2))
    assert bool(plan.solved.all())
    ss = simplify.SimplifySettings(operations=("reduce", "shortcut", "perturb", "bspline"))
    cpu = simplify.simplify_batch(spec, envs, plan.path, plan.path_length, ss)
    before = fkcc_cuda.LAUNCHES
    card = simplify.simplify_batch(spec, envs.to(cuda), plan.path.to(cuda),
                                   plan.path_length.to(cuda), ss)
    torch.cuda.synchronize()
    assert fkcc_cuda.LAUNCHES > before
    assert torch.equal(card.path_length.cpu(), cpu.path_length)
    assert torch.equal(card.iterations.cpu(), cpu.iterations)
    torch.testing.assert_close(card.path.cpu(), cpu.path, rtol=1e-6, atol=1e-6)


@pytest.mark.gpu
def test_mpnet_valid_matches_plain(cuda):
    """MPNet's motion check (`MPNetPlanner._valid`: one fkcc launch of 1 x
    440 lanes for the Panda) against the plain version on the same points,
    over seeded segments in the sphere cage; segments with a point within
    BAND of contact are left out."""
    from vamp_mvt_tpu_torch.bench import mbm
    from vamp_mvt_tpu_torch.planning import mpnet, validate

    spec = registry.load("panda")
    b = envmod.EnvironmentBuilder()
    for c in mbm.CAGE_CENTERS:
        b.add_sphere(c, mbm.CAGE_RADIUS)
    mp = mpnet.MPNetPlanner(spec, b.build(device=cuda), device=cuda)
    assert mp._num == 440
    rng = np.random.default_rng(5)
    q = rng.uniform(spec.limits_low, spec.limits_high, (128, 7)).astype(np.float32)
    ends = q + 0.3 * rng.standard_normal((128, 7)).astype(np.float32)
    decided = {True: 0, False: 0}
    for a, e in zip(q, ends):
        before = fkcc_cuda.LAUNCHES
        got = mp._valid(a, e)
        assert fkcc_cuda.LAUNCHES == before + 1
        pts = validate.motion_configs(spec, torch.as_tensor(a, device=cuda)[None, None],
                                      torch.as_tensor(e, device=cuda)[None, None], mp._num)
        vmin = fkcc_cuda.fkcc_vmin_plain(spec, mp._envs, pts.transpose(1, 2).contiguous())
        if bool((vmin.abs() <= BAND).any()):
            continue
        assert got == bool((vmin >= 0).all())
        decided[got] += 1
    assert decided[True] > 10 and decided[False] > 10


@pytest.mark.gpu
def test_sharded_mega_planner_on_the_card(cuda):
    """plan_batch_mega_sharded over the local cards (no process group) on 64
    cages equals plan_batch_mega on one."""
    from vamp_mvt_tpu_torch.bench import mbm
    from vamp_mvt_tpu_torch.parallel import mesh
    from vamp_mvt_tpu_torch.planning import rrtc_mega

    spec = registry.load("panda")
    envs, st, gl, mk = mbm.build_batch(mbm.cage_suite(64)["problems"]["cage"], device=cuda)
    s = mbm.default_settings("panda", "mega")
    m = mesh.make_mesh()
    assert m.size == torch.cuda.device_count()
    sh = mesh.plan_batch_mega_sharded(spec, m, envs, st, gl, mk, s)
    lo = rrtc_mega.plan_batch_mega(spec, envs, st, gl, mk, s, device=cuda)
    assert bool(lo.solved.all())
    for f in ("solved", "iterations", "size_start", "size_goal", "path_length", "cost", "path"):
        assert torch.equal(getattr(sh, f).cpu(), getattr(lo, f).cpu()), f
