"""A run with the timed path broken underneath comes out not correct.

Each test drives the rest of a run on the CPU (the harness's look for a card
is the command line's, which these skip), at a size a test holds, with the
port's plain versions, and breaks the port where it produces its answer:

- an answer altered where it is produced: the planner's first path vertex
  replaced by a configuration in self-contact;
- a step that returns its state unchanged: the planner reports its initial
  state, the straight start-goal segment, as a solved path; or its trees
  never grow and nothing is solved;
- half of the batch left out (the suite, the only cell with a batch): the
  second half of the problems reported unsolved, every verdict and path
  still right.
"""

import collections
import time

import numpy as np
import pytest
import torch

from planbench import faults, harness
from planbench.reference import check, geometry
from planbench.reference import robot as ref_robot

ROBOT = ref_robot.load("panda")
SEED = 2**31 + 77
# the Panda configuration the altered-vertex fault has always planted
PANDA_SELF_CONTACT = [0.4264270438343436, -1.5491468227299636, 2.8316195305892133,
                      -2.7840273895593812, -0.04700816742091929, 0.031980318547661604,
                      -0.5588801478217778]


def _cell(name: str) -> harness.Cell:
    cell = harness.Cell(name)
    cell.traffic = dict(cell.traffic, problems=4)
    # at these budgets a sound run leaves at most one valid problem of the
    # four unsolved; the half-batch fault leaves two or more
    cell.limits = dict(cell.limits, limits=dict(cell.limits["limits"], unsolved_valid_pct=40.0))
    if name == "panda_prim_suite":
        cell.traffic["invalid"] = 1
        cell.config = dict(cell.config, settings={"max_iterations": 256, "max_samples": 2048})
        cell.limits = dict(cell.limits, check={"problems": 100})
    if name == "panda_cloud_query":
        cell.config = dict(cell.config, samples_per_object=400,
                           settings={"max_iterations": 128, "max_samples": 1024})
    return cell


def _run(name: str) -> dict:
    return harness.execute(_cell(name), SEED, 0.01, False, torch.device("cpu"),
                           time.perf_counter())


def _straight(res, starts, goals):
    path = res.path.copy()
    path[:, 0], path[:, 1] = starts, goals
    return res._replace(path=path, path_length=np.full_like(res.path_length, 2),
                        solved=np.ones_like(res.solved))


@pytest.mark.parametrize("name", ["panda_prim_suite", "panda_cloud_query"])
def test_sound_run_is_correct(name):
    res = _run(name)
    assert res["correct"], res["compared"]


@pytest.mark.parametrize("name", ["panda_prim_suite", "panda_cloud_query"])
def test_altered_answer_is_not_correct(name):
    with faults.planted(faults.altered_vertex(ref_robot.load(_cell(name).config["robot"]))):
        res = _run(name)
    assert not res["correct"], res["compared"]


def test_unchanged_state_is_not_correct(monkeypatch):
    """The straight segment of some of these problems is in contact, so the
    planner's untouched initial state is a wrong answer there."""
    from planbench import generator

    cell = _cell("panda_prim_suite")
    probs = generator.pool(ROBOT, cell.traffic, cell.config, SEED, "cpu")[0]
    dec = check.Decisions(7)
    for i, p in enumerate(probs):
        dec.add_path(i, check.polyline_states(p["start"], p["goals"][0], np.zeros((0, 7)), 32))
    scene = ("obstacles", [geometry.obstacles(p) for p in probs])
    assert check.judge(ROBOT, dec, scene, "cpu")["wrong_states"] > 0
    from vamp_mvt_tpu_torch.bench import mbm

    seen = {}
    orig_build = mbm.build_batch

    def build_batch(problems, cache_key=None, device=None):
        out = orig_build(problems, cache_key, device)
        seen["starts"], seen["goals"] = out[1].cpu().numpy(), out[2][:, 0].cpu().numpy()
        return out

    monkeypatch.setattr(mbm, "build_batch", build_batch)
    with faults.planted(lambda r: _straight(r, seen["starts"][:len(r.solved)],
                                            seen["goals"][:len(r.solved)])):
        res = _run("panda_prim_suite")
    assert not res["correct"], res["compared"]


def test_half_the_batch_left_out_is_not_correct():
    """The planner skips the second half of the batch and reports it
    unsolved; its validity verdicts and the paths it returns stay right."""
    with faults.planted(faults.half_unsolved):
        res = _run("panda_prim_suite")
    for name in ("verdict_gap_m2", "cost_rel_gap"):
        assert res["compared"][name]["value"] <= res["compared"][name]["limit"], name
    assert not res["correct"], res["compared"]


@pytest.mark.parametrize("name", ["panda_prim_suite", "panda_cloud_query"])
def test_nothing_solved_is_not_correct(name):
    """A planner step that returns its state unchanged: no tree grows, no
    problem is solved."""
    with faults.planted(faults.none_solved):
        res = _run(name)
    assert not res["correct"], res["compared"]


@pytest.mark.parametrize("name", ["panda", "fetch"])
def test_altered_vertex_plants_a_self_contact_of_the_cells_robot(name):
    """The fault made for a cell's robot plants a configuration of that
    robot's dimension that the reference finds in self-contact, in numpy and
    torch results alike; for the Panda, the one it always planted."""
    robot = ref_robot.load(name)
    Res = collections.namedtuple("Res", "path solved")
    path = np.zeros((3, 5, robot.dimension))
    change = faults.FAULTS["altered_vertex"](robot)
    got = change(Res(path, np.ones(3, bool))).path
    assert (path == 0).all() and got.shape == path.shape and (got[:, 1:] == 0).all()
    bad = got[0, 0]
    assert (got[:, 0] == bad).all()
    rt = robot.tensors(torch.float64, "cpu")
    assert robot.self_vmin(robot.spheres(torch.tensor(bad[None]), rt), rt)[0] < 0
    assert np.all((bad >= robot.low) & (bad <= robot.high))
    on_torch = change(Res(torch.zeros(3, 5, robot.dimension), np.ones(3, bool))).path
    assert torch.equal(on_torch[:, 0], torch.tensor(bad, dtype=torch.float32).expand(3, -1))
    if name == "panda":
        assert bad.tolist() == PANDA_SELF_CONTACT
