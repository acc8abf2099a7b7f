"""The traffic generator: fixed by the seed, the port's scenes, endpoints the
reference finds free (and the asked-for goals in contact)."""

import numpy as np
import pytest
import torch

from planbench import generator
from planbench.reference import check, geometry
from planbench.reference import robot as ref_robot

ROBOT = ref_robot.load("panda")
TRAFFIC = {"problems": 6, "pool": 2, "invalid": 1}
PRIM = {"obstacles": "primitives"}


def test_scenes_are_the_ports():
    from vamp_mvt_tpu_torch.bench import scenes

    for seed in (0, 7, 2**31 + 11):
        ours = generator.mbm_shaped_problems(9, seed, ROBOT.low, ROBOT.high)
        assert ours == scenes.mbm_shaped_problems(9, seed)


def test_pool_is_fixed_by_the_seed():
    a = generator.pool(ROBOT, TRAFFIC, PRIM, 2**31 + 3, "cpu")
    b = generator.pool(ROBOT, TRAFFIC, PRIM, 2**31 + 3, "cpu")
    c = generator.pool(ROBOT, TRAFFIC, PRIM, 2**31 + 4, "cpu")
    assert a == b and a != c
    assert [len(x) for x in a] == [6, 6] and a[0] != a[1]
    fixed = dict(TRAFFIC, pool_seed=5)
    assert (generator.pool(ROBOT, fixed, PRIM, 1, "cpu")
            == generator.pool(ROBOT, fixed, PRIM, 2, "cpu"))


def test_endpoints_are_free_and_one_goal_in_contact():
    items = generator.pool(ROBOT, TRAFFIC, PRIM, 12345, "cpu")
    for probs in items:
        starts = [p["start"] for p in probs]
        goals = [p["goals"][0] for p in probs]
        scene = ("obstacles", [geometry.obstacles(p) for p in probs])
        ok = check.reference_valid(ROBOT, starts, goals, scene, "cpu")
        assert int((~ok).sum()) == 1
        q = np.asarray(starts)
        v = check.values(ROBOT, q, np.arange(len(q)), scene, torch.float64, "cpu")
        assert (v >= 0).all()
        assert all(np.all((np.asarray(s) >= ROBOT.low) & (np.asarray(s) <= ROBOT.high))
                   for s in starts + goals)


def test_cloud_endpoints_clear_the_grown_shapes():
    probs = generator.pool(ROBOT, dict(TRAFFIC, invalid=0, pool=1),
                           {"obstacles": "cloud", "pad": 0.005}, 99, "cpu")[0]
    scene = ("obstacles", [geometry.obstacles(p, pad=0.005, spheres=False) for p in probs])
    ok = check.reference_valid(ROBOT, [p["start"] for p in probs],
                               [p["goals"][0] for p in probs], scene, "cpu")
    assert ok.all()


@pytest.mark.parametrize("box", [[[0.5, 0.0, 0.0], [0.4, 0.6, 1.0]], [[0.2, -0.6], [0.9, 0.6]]])
def test_a_malformed_scene_box_is_refused(box):
    with pytest.raises(ValueError, match="scene_box"):
        generator.pool(ROBOT, TRAFFIC, dict(PRIM, scene_box=box), 1, "cpu")
