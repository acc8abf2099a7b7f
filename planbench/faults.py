"""Faults planted in the port's suite runners, for the readings that set the
limits of `correct` (`calibrate.py --fault`) and for the tests that see a
broken run come out not correct.  Each changes the planner's result where
the runner gathers it (`bench/mbm.py::_gather`); the benchmark's own runs
plant none."""

from __future__ import annotations

import contextlib

import numpy as np


def half_unsolved(res):
    """Half of the batch left out: its second half reported unsolved, every
    verdict and every path of the first half still right."""
    solved = res.solved.copy()
    solved[len(solved) // 2:] = False
    return res._replace(solved=solved)


def none_solved(res):
    """A planner step that returns its state unchanged: the trees never grow,
    so no problem is solved."""
    return res._replace(solved=res.solved & False)


def self_contact(robot) -> np.ndarray:
    """The configuration of `robot` (a reference table) deepest in
    self-contact among 4096 seeded uniform draws, by the reference."""
    import torch

    q = np.random.default_rng(0).uniform(robot.low, robot.high, (4096, robot.dimension))
    rt = robot.tensors(torch.float64, "cpu")
    v = robot.self_vmin(robot.spheres(torch.tensor(q), rt), rt).numpy()
    return q[int(np.argmin(v))]


def altered_vertex(robot):
    """An answer altered where it is produced: each path's first vertex
    replaced by a configuration of `robot`, the cell's robot, in
    self-contact."""
    import torch

    bad = self_contact(robot)

    def change(res):
        path = res.path.clone() if torch.is_tensor(res.path) else res.path.copy()
        path[..., 0, :] = (torch.as_tensor(bad, dtype=path.dtype) if torch.is_tensor(path)
                           else bad)
        return res._replace(path=path)

    return change


# each fault by name, made for the cell's robot (its reference table)
FAULTS = {"half_unsolved": lambda robot: half_unsolved,
          "none_solved": lambda robot: none_solved,
          "altered_vertex": altered_vertex}


@contextlib.contextmanager
def planted(change):
    """Apply `change` to every planner result the suite runners gather."""
    from vamp_mvt_tpu_torch.bench import mbm

    orig = mbm._gather

    def gather(parts, n_real):
        res = orig(parts, n_real)
        return change(res) if hasattr(res, "solved") else res

    mbm._gather = gather
    try:
        yield
    finally:
        mbm._gather = orig
