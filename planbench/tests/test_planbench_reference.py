"""The plain reference: its robot, obstacles and cloud against hand-made
contact and free cases, and against the port where both compute the same
thing (the port is imported here only, never by the reference)."""

import numpy as np
import pytest
import torch

from planbench import generator
from planbench.reference import check, cloud, geometry
from planbench.reference import robot as ref_robot

ROBOT = ref_robot.load("panda")
HOME = [0.0, -0.785, 0.0, -2.356, 0.0, 1.571, 0.785]


def _values(q, problems, dtype=torch.float64):
    q = np.atleast_2d(np.asarray(q, np.float64))
    obs = [geometry.obstacles(p) for p in problems]
    return check.values(ROBOT, q, np.zeros(len(q), np.int64), ("obstacles", obs), dtype, "cpu")


def _scene(**kinds):
    return {"problem": kinds.pop("problem", "table_pick"), "sphere": [], "cylinder": [],
            "box": [], **kinds}


def _centers(q):
    return ROBOT.spheres(torch.tensor([q], dtype=torch.float64),
                         ROBOT.tensors(torch.float64, "cpu"))[0].numpy()


def test_free_in_an_empty_scene_and_self_clear_at_home():
    v = _values(HOME, [_scene()])
    assert v[0] > 0


def test_sphere_on_a_robot_sphere_is_contact_and_far_is_free():
    c = _centers(HOME)[30]
    near = _scene(sphere=[{"position": c.tolist(), "radius": 0.01}])
    far = _scene(sphere=[{"position": [3.0, 3.0, 3.0], "radius": 0.01}])
    assert _values(HOME, [near])[0] < 0
    assert _values(HOME, [far])[0] > 0


def test_box_around_the_hand_is_contact_and_box_beside_is_free():
    c = _centers(HOME)[-1]
    around = _scene(box=[{"position": c.tolist(), "orientation_euler_xyz": [0.3, 0.2, 0.1],
                          "half_extents": [0.05, 0.05, 0.05]}])
    beside = _scene(box=[{"position": (c + [0.0, 0.0, 2.0]).tolist(),
                          "orientation_euler_xyz": [0, 0, 0], "half_extents": [0.05] * 3}])
    assert _values(HOME, [around])[0] < 0
    assert _values(HOME, [beside])[0] > 0


def test_cylinder_is_a_capsule_except_in_the_box_scenario():
    c = _centers(HOME)[-1]
    r = ROBOT.sphere_radius[-1]
    # a vertical cylinder whose end cap lies just below the hand sphere's bottom
    cyl = {"position": (c - [0, 0, r + 0.01 + 0.1]).tolist(), "orientation_euler_xyz": [0, 0, 0],
           "radius": 0.02, "length": 0.2}
    # as a capsule its rounded end (radius 0.02) reaches past the gap of 0.01
    assert _values(HOME, [_scene(cylinder=[cyl])])[0] < 0
    # as the cuboid of the "box" scenario its flat end stays 0.01 below
    assert _values(HOME, [_scene(problem="box", cylinder=[cyl])])[0] > 0


def test_fk_matches_the_port():
    from vamp_mvt_tpu_torch.ops import fk
    from vamp_mvt_tpu_torch.robots import registry

    q = np.random.default_rng(0).uniform(ROBOT.low, ROBOT.high, (64, 7))
    ours = ROBOT.spheres(torch.tensor(q), ROBOT.tensors(torch.float64, "cpu")).numpy()
    theirs = fk.sphere_positions(registry.load("panda"),
                                 torch.tensor(q, dtype=torch.float32)).numpy()
    assert np.abs(ours - theirs).max() < 2e-5


def test_fetch_fk_matches_the_port():
    """Fetch's frozen table (8 joints, the first the prismatic torso) poses
    its 111 spheres as the port does, with the torso across its 0-0.386 m."""
    from vamp_mvt_tpu_torch.ops import fk
    from vamp_mvt_tpu_torch.robots import registry

    fetch = ref_robot.load("fetch")
    assert (fetch.dimension, len(fetch.sphere_radius)) == (8, 111)
    q = np.random.default_rng(0).uniform(fetch.low, fetch.high, (64, 8))
    q[:, 0] = np.linspace(fetch.low[0], fetch.high[0], 64)
    ours = fetch.spheres(torch.tensor(q), fetch.tensors(torch.float64, "cpu")).numpy()
    theirs = fk.sphere_positions(registry.load("fetch"),
                                 torch.tensor(q, dtype=torch.float32)).numpy()
    assert np.abs(ours - theirs).max() < 2e-5
    # the torso lifts all above the base straight up by its travel, and
    # leaves the base's spheres where they are
    ends = np.repeat(q[:1], 2, 0)
    ends[:, 0] = fetch.low[0], fetch.high[0]
    lo, hi = fetch.spheres(torch.tensor(ends), fetch.tensors(torch.float64, "cpu")).numpy()
    rise = hi - lo
    assert np.allclose(rise[:, :2], 0, atol=1e-12)
    up = rise[:, 2] > 0
    assert 0 < up.sum() < len(up)
    assert np.allclose(rise[up, 2], fetch.high[0] - fetch.low[0], atol=1e-12)
    assert np.allclose(rise[~up, 2], 0, atol=1e-12)


def test_validity_matches_the_port_away_from_contact():
    from vamp_mvt_tpu_torch.bench import mbm
    from vamp_mvt_tpu_torch.planning import validate
    from vamp_mvt_tpu_torch.robots import registry

    problems = generator.mbm_shaped_problems(8, 5, ROBOT.low, ROBOT.high)
    q = np.random.default_rng(1).uniform(ROBOT.low, ROBOT.high, (8, 64, 7))
    envs = mbm.build_batch(problems, device="cpu")[0]
    theirs = validate.fkcc_valid(registry.load("panda"), envs,
                                 torch.tensor(q, dtype=torch.float32)).numpy()
    obs = [geometry.obstacles(p) for p in problems]
    v = check.values(ROBOT, q.reshape(-1, 7), np.repeat(np.arange(8), 64), ("obstacles", obs),
                     torch.float64, "cpu").reshape(8, 64)
    clear = np.abs(v) > 1e-6
    assert clear.mean() > 0.9
    assert ((v >= 0) == theirs)[clear].all()


def test_polyline_states_follow_the_motion_check_grid():
    from vamp_mvt_tpu_torch.planning import validate
    from vamp_mvt_tpu_torch.robots import registry

    a, b = np.zeros(7), np.full(7, 0.1)
    s = check.polyline_states(a, b, np.zeros((0, 7)), 32)
    dist = np.linalg.norm(b - a)
    frac = validate.interpolation_fractions(registry.load("panda"),
                                            torch.tensor([dist], dtype=torch.float32),
                                            len(s) - 1)[0].numpy()
    np.testing.assert_allclose(s[1:], a + frac[:, None] * (b - a), atol=1e-7)
    assert (s[0] == a).all() and np.allclose(s[-1], b)


def test_cloud_equals_the_ports_filtered_cloud():
    from vamp_mvt_tpu_torch.pointcloud import filters, sampling

    p = generator.mbm_shaped_problems(3, 9, ROBOT.low, ROBOT.high)[2]
    raw = sampling.problem_to_pointcloud(p, 2000)
    assert np.array_equal(cloud.sample(p, 2000), raw)
    theirs = filters.filter_scdf(raw, 0.02, 1.19, [0.0, 0.0, 0.0], [-1.19] * 3, [1.19] * 3,
                                 use_native=False)
    ours = cloud.problem_cloud(p, 2000, 0.02, 1.19, [0.0, 0.0, 0.0])
    assert np.array_equal(ours, theirs)


def test_cloud_point_on_a_sphere_is_contact():
    c = _centers(HOME)
    pts = torch.tensor(c[10:11], dtype=torch.float64)
    rt = ROBOT.tensors(torch.float64, "cpu")
    v = geometry.vmin(ROBOT, rt, torch.tensor([HOME], dtype=torch.float64), cloud=pts,
                      point_radius=0.0025)
    assert v[0] < 0
    far = geometry.vmin(ROBOT, rt, torch.tensor([HOME], dtype=torch.float64),
                        cloud=pts + 3.0, point_radius=0.0025)
    assert far[0] > 0


def test_judge_reads_the_gap_of_a_wrong_verdict():
    c = _centers(HOME)[30]
    scene = [geometry.obstacles(_scene(sphere=[{"position": c.tolist(), "radius": 0.01}]))]
    dec = check.Decisions(7)
    dec.add_path(0, np.array([HOME]))
    out = check.judge(ROBOT, dec, ("obstacles", scene), "cpu")
    assert out["verdict_gap_m2"] > 1e-3 and out["wrong_states"] == 1
    dec = check.Decisions(7)
    dec.add_endpoints(0, HOME, HOME, False)
    out = check.judge(ROBOT, dec, ("obstacles", [geometry.obstacles(_scene())]), "cpu")
    assert out["verdict_gap_m2"] > 1e-3 and out["wrong_valid"] == 1


def test_control_in_bfloat16_fails_where_float64_decides():
    """The control (the reference in bfloat16 in the program's place) on a
    size a test holds: pairs of uniform configurations in eight scenes,
    classified as problems the way float64 classifies them, and judged
    where the program is (endpoint verdicts both ways)."""
    problems = generator.mbm_shaped_problems(8, 4, ROBOT.low, ROBOT.high)
    q = np.random.default_rng(2).uniform(ROBOT.low, ROBOT.high, (8, 400, 7))
    obs = [geometry.obstacles(p) for p in problems]
    rows = np.repeat(np.arange(8), 200)
    a, b = q[:, :200].reshape(-1, 7), q[:, 200:].reshape(-1, 7)
    ok = check.reference_valid(ROBOT, a, b, ("obstacles", [obs[r] for r in rows]), "cpu")
    dec = check.Decisions(7)
    for i in range(len(a)):
        dec.add_endpoints(i, a[i], b[i], bool(ok[i]))
    scene = ("obstacles", [obs[r] for r in rows])
    exact = check.judge(ROBOT, dec, scene, "cpu")
    ctl = check.judge(ROBOT, dec, scene, "cpu", control=True)
    assert exact["verdict_gap_m2"] == 0.0
    assert ctl["verdict_gap_m2"] > 1e-5 and ctl["wrong_valid"] > 0


def test_control_is_judged_only_where_the_program_is():
    """A free path state that bfloat16 calls in contact is no error of the
    control: the program is never asked for that verdict."""
    problems = generator.mbm_shaped_problems(8, 4, ROBOT.low, ROBOT.high)
    q = np.random.default_rng(2).uniform(ROBOT.low, ROBOT.high, (8, 400, 7))
    obs = [geometry.obstacles(p) for p in problems]
    rows = np.repeat(np.arange(8), 400)
    v = check.values(ROBOT, q.reshape(-1, 7), rows, ("obstacles", obs), torch.float64, "cpu")
    vc = check.values(ROBOT, q.reshape(-1, 7), rows, ("obstacles", obs), torch.bfloat16, "cpu")
    assert ((v >= 0) & (vc < 0)).any()
    dec = check.Decisions(7)
    for i, s in enumerate(q.reshape(-1, 7)):
        if v[i] >= 0:
            dec.add_path(int(rows[i]), s[None])
    ctl = check.judge(ROBOT, dec, ("obstacles", obs), "cpu", control=True)
    assert ctl["verdict_gap_m2"] == 0.0


def test_cost_gap_separates_float32_from_bfloat16():
    """A path's cost as float32 sums it is within rounding of the float64
    sum; the control's bfloat16 sum is not."""
    rng = np.random.default_rng(3)
    dec = check.Decisions(7)
    for n in (2, 5, 12, 40):
        x = rng.uniform(ROBOT.low, ROBOT.high, (n, 7)).astype(np.float32)
        cost = torch.linalg.vector_norm(torch.diff(torch.tensor(x), dim=0), dim=1).sum()
        dec.add_cost(x, float(cost))
    out = check.judge(ROBOT, dec, ("obstacles", []), "cpu")
    ctl = check.judge(ROBOT, dec, ("obstacles", []), "cpu", control=True)
    assert out["cost_rel_gap"] < 1e-6 < 1e-4 < ctl["cost_rel_gap"]
    dec.add_cost(x, float(cost) * 1.01)
    assert check.judge(ROBOT, dec, ("obstacles", []), "cpu")["cost_rel_gap"] > 1e-3
