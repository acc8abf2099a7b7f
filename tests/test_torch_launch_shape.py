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


# ---------------------------------------------------------------------------
# fkcc's launch shape (fkcc_cuda.fkcc_shape), sized to each path's B x N
# ---------------------------------------------------------------------------

FKCC_ROBOTS = ("panda", "ur5", "fetch", "baxter", "sphere")
# bench/time_fkcc.py's cases: the tables' kind, B, N
FKCC_CASES = {
    "bench_validity": ("cages", 700, 2), "bench_direct": ("cages", 700, 440),
    "primitives": ("mbm", 700, 1024), "api_rrtc_step": ("payload", 1, 480),
    "prm_samples": ("cages", 1, 64), "prm_edges": ("cages", 1, 92400),
    "fcit_edge": ("cages", 1, 440), "clouds64": ("cloud", 64, 1024),
    "attach700": ("payload", 700, 1024), "terrain700": ("terrain", 700, 1024),
    "sphere_api_step": ("terrain", 1, 480),
}


def _fkcc_spec(robot):
    if robot == "sphere":
        return registry.sphere_spec(lows=(-5, -5, 0), highs=(5, 5, 5), radius=0.2)
    return registry.load(robot)


def _fkcc_tables(which):
    """Tables of the sizes the cases launch on: `_tables`' kinds, two
    MBM-shaped scenes, and those with a terrain of 250 x 250 cells."""
    if which in ("cages", "payload", "cloud"):
        return _tables(which)
    envs = mbm.build_batch(scenes.mbm_shaped_problems(2, seed=1), device="cpu")[0]
    if which == "mbm":
        return envs
    hm, hd = scenes.terrain_tables(2, 8, "cpu")
    return envs._replace(hf_meta=hm, hf_data=hd)


@pytest.mark.parametrize("case", sorted(FKCC_CASES))
@pytest.mark.parametrize("robot", FKCC_ROBOTS)
def test_fkcc_shape_fits_and_sizes_to_the_batch(robot, case):
    """The shape fits a block's 227 KB as the kernel lays it out; a cloud
    takes at least MEGA_PC_MIN_GROUP lanes; at 700 x 2 at least half of a
    block's threads hold a configuration; at 1 x 64 the launch reaches at
    least 16 SMs; at 700 (or 64) x 1024 an SM holds at least 16 warps where
    the picked G's shared memory allows it (16 for the Panda)."""
    spec, (which, B, N) = _fkcc_spec(robot), FKCC_CASES[case]
    envs = _fkcc_tables(which)
    got = fkcc_cuda.fkcc_shape(spec, envs, B, N)
    T, G, per = got["threads"], got["group"], got["configs_per_block"]
    tab = fkcc_cuda.table_floats(spec, envs, G)
    assert got["smem_bytes"] == 4 * (tab["env"] + tab["robot"] + per * tab["group"])
    assert got["smem_bytes"] <= fkcc_cuda.MAX_SMEM
    assert per == T // G and got["blocks"] == B * -(-N // per)
    assert got["warps_per_sm"] == got["blocks_per_sm"] * T // 32
    if which == "cloud":
        assert G >= fkcc_cuda.MEGA_PC_MIN_GROUP
    if (B, N) == (700, 2):
        assert min(N, per) * G >= T // 2
    if (B, N) == (1, 64):
        assert got["blocks"] >= 16
    if N == 1024:  # as many warps an SM as the picked G's scratch allows, up to 16
        most, pick = 0, fkcc_cuda.FKCC_PC_MAX_PICK if which == "cloud" else fkcc_cuda.FKCC_MAX_PICK
        for T_ in (t for t in fkcc_cuda.MEGA_THREADS if t <= pick):
            try:
                most = max(most, fkcc_cuda.fkcc_shape(spec, envs, B, N, shape=(T_, G))[
                    "warps_per_sm"])
            except ValueError:
                continue
        assert got["warps_per_sm"] >= min(16, most)
        if robot == "panda":  # the per-thread design held 4 to 8
            assert got["warps_per_sm"] >= 16


@pytest.mark.parametrize("robot", FKCC_ROBOTS)
def test_fkcc_shape_override_picks_each_group(robot):
    """shape = (None, G) takes G with the best T for it, (T, G) that shape;
    a shape that does not fit, or that the kernel does not run, raises."""
    spec, envs = _fkcc_spec(robot), _fkcc_tables("mbm")
    for G in fkcc_cuda.MEGA_GROUPS:
        got = fkcc_cuda.fkcc_shape(spec, envs, 700, 1024, shape=(None, G))
        assert got["group"] == G and got["threads"] in fkcc_cuda.MEGA_THREADS
        T = got["threads"]
        got = fkcc_cuda.fkcc_shape(spec, envs, 1, 64, shape=(T, G))
        assert (got["threads"], got["group"], got["configs_per_block"]) == (T, G, T // G)
    assert fkcc_cuda.fkcc_shape(spec, envs, 1, 64, shape=(512, 32))["threads"] == 512
    for bad in ((512, 3), (96, 4), (32, 64)):
        with pytest.raises(ValueError, match="does not fit"):
            fkcc_cuda.fkcc_shape(spec, envs, 1, 64, shape=bad)


def test_fkcc_shape_refuses_what_does_not_fit():
    """1.4 KB of FK scratch a Panda configuration: 512 groups of one lane
    pass a block's 227 KB; a table whose rows alone pass it leaves no
    shape."""
    spec, envs = registry.load("panda"), _fkcc_tables("mbm")
    with pytest.raises(ValueError, match="does not fit"):
        fkcc_cuda.fkcc_shape(spec, envs, 700, 1024, shape=(512, 1))
    huge = envs._replace(spheres=torch.zeros((2, 15000, 4)))
    with pytest.raises(ValueError, match="no launch shape fits"):
        fkcc_cuda.fkcc_shape(spec, huge, 700, 1024)


def test_fkcc_table_pack_reused_until_a_table_changes():
    """The wrapper packs an Environment's table arguments once: the same
    object on the same device and batch reuses the pack; a payload changed
    in place is packed anew (its rows are derived on the host side); tables
    of another batch are checked and refused."""
    spec = registry.load("panda")
    cages = _tables("cages")
    att = envmod.make_attachment([[0.0, 0.0, 0.05 * k, 0.04] for k in range(4)])
    envs = cages._replace(attachment=att._replace(
        **{f: torch.as_tensor(getattr(att, f))[None].repeat(2, *[1] * getattr(att, f).ndim)
           for f in att._fields}))
    q = torch.zeros((2, 8, 7))
    tab, keep = fkcc_cuda._table_pack(spec, envs, q, 2)
    again, _ = fkcc_cuda._table_pack(spec, envs, q, 2)
    assert again is tab
    envs.attachment.spheres[..., 3] *= 2.0
    fresh, fresh_keep = fkcc_cuda._table_pack(spec, envs, q, 2)
    assert fresh is not tab
    rows = next(t for t in fresh_keep if t.shape[-2:] == (4, 4) and t.data_ptr() == fresh[18])
    assert torch.equal(rows[..., 3], envs.attachment.spheres[..., 3])
    with pytest.raises(ValueError, match="batch"):
        fkcc_cuda._table_pack(spec, envs, torch.zeros((3, 8, 7)), 3)
