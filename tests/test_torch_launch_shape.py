"""The megakernels' launch shape, on the CPU.

`rrtc_mega_cuda.launch_shape` and `simplify_mega_cuda.launch_shape` pick
the threads a block T and the lanes of a warp that check one configuration
together G (`fkcc_cuda.choose_shape`) from the kernels' shared-memory
layouts, mirrored in Python (`smem_floats`; the launchers report the bytes
their C `Layout` takes, and the wrappers raise on the card where the two
differ).  Pinned here: the shape for the Panda, UR5, Fetch and Baxter on
sphere cages, with four payload spheres and on a pointcloud; the ranking
rule itself; the override the card tests use; and the refusal where no
shape fits.
"""

import dataclasses

import pytest
import torch

from vamp_mvt_tpu_torch.bench import mbm, scenes
from vamp_mvt_tpu_torch.collision import environment as envmod
from vamp_mvt_tpu_torch.ops.kernels import fkcc_cuda, rrtc_mega_cuda, simplify_mega_cuda
from vamp_mvt_tpu_torch.pointcloud import pipeline
from vamp_mvt_tpu_torch.robots import registry

torch.set_num_threads(1)


def _tables(which: str):
    """Two sphere cages, the same with a 4-sphere payload, or one MBM-shaped
    scene's cloud in the kernel form."""
    cages = mbm.build_batch(mbm.cage_suite(2)["problems"]["cage"], device="cpu")[0]
    if which == "cages":
        return cages
    if which == "payload":
        att = envmod.make_attachment([[0.0, 0.0, 0.05 * k, 0.04] for k in range(4)])
        return cages._replace(attachment=att._replace(
            **{f: torch.as_tensor(getattr(att, f))[None].expand(2, *getattr(att, f).shape)
               for f in att._fields}))
    p = dict(scenes.mbm_shaped_problems(1, seed=1)[0], sphere=[])
    pck = pipeline.problem_to_pointcloud_env("panda", p, pc_repr="capt",
                                             samples_per_object=2000)[0].pck
    return envmod.stack_environments([envmod.EnvironmentBuilder(pck=pck).build(device="cpu")])


# (T, G) of both kernels: on cages the most threads a block with the fewest
# lanes that fit; a payload's centres push the Panda to 8 lanes; a cloud
# takes at least MEGA_PC_MIN_GROUP lanes
SHAPES = {
    ("panda", "cages"): (512, 4), ("panda", "payload"): (512, 8), ("panda", "cloud"): (512, 8),
    ("ur5", "cages"): (512, 8), ("ur5", "payload"): (512, 8), ("ur5", "cloud"): (512, 8),
    ("fetch", "cages"): (512, 8), ("fetch", "payload"): (512, 8), ("fetch", "cloud"): (512, 8),
    ("baxter", "cages"): (512, 16), ("baxter", "payload"): (512, 16),
    ("baxter", "cloud"): (512, 16),
}


@pytest.mark.parametrize("robot,which", sorted(SHAPES))
def test_launch_shapes(robot, which):
    spec = registry.load(robot)
    envs = _tables(which)
    s = mbm.default_settings(robot, "mega")
    got = rrtc_mega_cuda.launch_shape(spec, envs, s)
    assert (got["threads"], got["group"]) == SHAPES[robot, which]
    assert got["smem_bytes"] <= fkcc_cuda.MAX_SMEM - 1024
    assert got["smem_bytes"] == 4 * rrtc_mega_cuda.smem_floats(spec, envs, s, *SHAPES[robot, which])
    assert got["blocks_per_sm"] == 1 and got["warps_per_sm"] == 16
    got = simplify_mega_cuda.launch_shape(spec, envs, s.max_path)
    assert (got["threads"], got["group"]) == SHAPES[robot, which]
    assert got["warps_per_sm"] == 16


def test_group_scratch_padding_and_growth():
    """Each group's scratch is padded to 3 G modulo 32 (conflict-free pair
    reads), and a block's layout grows by one group's scratch per group (and
    the planner's nearest-neighbour merge by 2 floats a thread)."""
    spec = registry.load("panda")
    envs = _tables("cages")
    s = mbm.default_settings("panda", "mega")
    base = 3 * spec.dimension + 12 * len(spec.frames) + 3 * spec.n_spheres
    for G in fkcc_cuda.MEGA_GROUPS:
        g = fkcc_cuda.table_floats(spec, envs, G)["group"]
        assert base <= g < base + 32 and g % 32 == (3 * G) % 32
        assert (rrtc_mega_cuda.smem_floats(spec, envs, s, 512, G)
                - rrtc_mega_cuda.smem_floats(spec, envs, s, 256, G)) == 256 // G * g + 2 * 256
        assert (simplify_mega_cuda.smem_floats(spec, envs, 96, 512, G)
                - simplify_mega_cuda.smem_floats(spec, envs, 96, 256, G)) == 256 // G * g


def test_choose_shape_ranking():
    """G at least min_group where one fits, then the most threads, then the
    fewest rounds of a pass's points, then the most lanes at that count;
    every candidate within max_smem."""
    def smem(T, G):
        return 100 * (T // G) + 1000

    pick = fkcc_cuda.choose_shape(smem, 1024, 100 * 128 + 1000, points=300)
    assert (pick["threads"], pick["group"]) == (512, 4)      # 128 groups fit, 256 do not
    pick = fkcc_cuda.choose_shape(smem, 1024, 10 ** 9, points=300)
    assert (pick["threads"], pick["group"]) == (512, 1)      # only 512 groups take one round
    pick = fkcc_cuda.choose_shape(smem, 1024, 10 ** 9, points=64)
    assert (pick["threads"], pick["group"]) == (512, 8)      # 64 groups of 8 take one round
    pick = fkcc_cuda.choose_shape(smem, 1024, 10 ** 9, points=300, min_group=8)
    assert (pick["threads"], pick["group"]) == (512, 8)
    assert pick["blocks_per_sm"] == fkcc_cuda.blocks_per_sm(512, smem(512, 8), 1024)
    assert pick["warps_per_sm"] == pick["blocks_per_sm"] * 16


def test_override_picks_each_group():
    """shape = (None, G) takes the most threads that fit G lanes; (T, G)
    takes that shape; a shape that does not fit raises."""
    spec = registry.load("panda")
    envs = _tables("cages")
    s = mbm.default_settings("panda", "mega")
    want = {1: 128, 2: 256, 4: 512, 8: 512, 16: 512, 32: 512}
    for G, T in want.items():
        got = rrtc_mega_cuda.launch_shape(spec, envs, s, shape=(None, G))
        assert (got["threads"], got["group"]) == (T, G)
    got = simplify_mega_cuda.launch_shape(spec, envs, s.max_path, shape=(128, 8))
    assert (got["threads"], got["group"]) == (128, 8)
    with pytest.raises(ValueError, match="does not fit"):
        rrtc_mega_cuda.launch_shape(spec, envs, s, shape=(512, 1))
    with pytest.raises(ValueError, match="does not fit"):
        simplify_mega_cuda.launch_shape(spec, envs, s.max_path, shape=(512, 3))


def test_nothing_fits_raises():
    """A path buffer whose copies alone pass a block's shared memory leaves
    no shape; neither does a planner path export of that size."""
    spec = registry.load("panda")
    envs = _tables("cages")
    with pytest.raises(ValueError, match="no launch shape fits"):
        simplify_mega_cuda.launch_shape(spec, envs, 3000)
    big = dataclasses.replace(mbm.default_settings("panda", "mega"), max_path=70000)
    with pytest.raises(ValueError, match="no launch shape fits"):
        rrtc_mega_cuda.launch_shape(spec, envs, big)
