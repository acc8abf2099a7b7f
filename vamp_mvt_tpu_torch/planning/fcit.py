"""FCIT* — Fully Connected Informed Trees (reference planning/fcit.hh).

Port of `vamp_mvt_tpu/planning/fcit.py`.  A nearest-neighbourless
asymptotically-optimal planner: every sample is a candidate neighbour of
every node (FCITStarNeighborParams = infinity, roadmap.hh:79-107); edges are
enumerated lazily per node through a sample cursor, queued by f-hat, and
validated only when popped, with per-node invalid sets.

The graph search runs on the host, line for line as in the JAX package.
Samples are drawn and checked on the device in batches of 2 * batch_size
(one fkcc launch a batch, reference fcit.hh:322-348), and each popped edge
is validated on the device by itself (one fkcc launch an edge, as the JAX
package does: batching the pops would change the search).  The Halton
stream and the per-batch selection of valid samples match the reference's
sequential rejection sampling.

Runs on `device` (default: the GPU; "cpu" runs the kernel's plain version).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from vamp_mvt_tpu_torch.collision.environment import Environment
from vamp_mvt_tpu_torch.planning.prm import PRMResult, make_device_fns
from vamp_mvt_tpu_torch.robots.spec import RobotSpec

_INF = float("inf")
_NO_PARENT = -1


@dataclasses.dataclass(frozen=True)
class FCITSettings:
    max_iterations: int = 100
    max_samples: int = 1024
    batch_size: int = 128
    optimize: bool = False


class _Node:
    __slots__ = ("g", "sample_idx", "neighbors", "cursor", "invalid")

    def __init__(self):
        self.g = _INF
        self.sample_idx = 0
        self.neighbors = []  # list of [key, index]
        self.cursor = 0
        self.invalid = set()


def solve(
    spec: RobotSpec,
    env: Environment,
    start: np.ndarray,
    goals: np.ndarray,
    settings: FCITSettings | None = None,
    sample_offset: int = 0,
    device=None,
) -> PRMResult:
    settings = settings or FCITSettings()
    start = np.asarray(start, np.float32)
    goals = np.asarray(goals, np.float32).reshape(-1, spec.dimension)
    fns = make_device_fns(spec, env, 2 * settings.batch_size, device)

    states = [start] + list(goals)
    parents = [_NO_PARENT] * len(states)
    nodes = [_Node() for _ in states]
    nodes[0].g = 0.0
    goal_ids = list(range(1, 1 + len(goals)))

    def extend_neighbors(idx, node, goal, base_cost):
        """Enumerate unseen samples as neighbours (fcit.hh:144-167, 273-295)."""
        added = False
        me = states[idx]
        while node.sample_idx < len(states):
            j = node.sample_idx
            node.sample_idx += 1
            if j == idx:
                continue
            d = float(np.linalg.norm(states[j] - me))
            h = float(np.linalg.norm(states[j] - goal))
            if base_cost is None:
                # start node: admissible-improvement filter (fcit.hh:157-163)
                if d < nodes[j].g:
                    node.neighbors.append([d + h, j])
                    added = True
            else:
                node.neighbors.append([base_cost + d + h, j])
                added = True
        if added:
            node.neighbors.sort(key=lambda e: e[0])
            node.cursor = 0
        return added

    offset = sample_offset + 1
    iters = 0
    while len(states) < settings.max_samples and iters < settings.max_iterations:
        iters += 1
        for gi, goal in zip(goal_ids, goals):
            goal_node = nodes[gi]
            start_node = nodes[0]
            open_set = []  # QueueEdge: [cost, index, parent]

            extend_neighbors(0, start_node, goal, None)
            if start_node.cursor < len(start_node.neighbors):
                key, j = start_node.neighbors[start_node.cursor]
                start_node.cursor += 1
                open_set.append([key, j, 0])

            while open_set:
                open_set.sort(key=lambda e: -e[0])
                cost, cur, par = open_set.pop()
                cur_node = nodes[cur]
                cur_g = cur_node.g
                par_node = nodes[par]

                # enqueue the parent's next promising neighbour (fcit.hh:203-221)
                while par_node.cursor < len(par_node.neighbors):
                    nkey, nidx = par_node.neighbors[par_node.cursor]
                    par_node.cursor += 1
                    nh = float(np.linalg.norm(states[nidx] - goal))
                    if nkey < nodes[nidx].g + nh:
                        open_set.append([nkey, nidx, par])
                        break

                if parents[cur] != par:
                    dist_to_goal = float(np.linalg.norm(states[cur] - goal))
                    if cost <= goal_node.g:
                        if cost < cur_g + dist_to_goal:
                            valid = par not in cur_node.invalid
                            if valid:
                                if cur != par:
                                    valid = fns.validate_single(states[par], states[cur])
                                if valid:
                                    parents[cur] = par
                                    cur_g = par_node.g + float(
                                        np.linalg.norm(states[par] - states[cur])
                                    )
                                    cur_node.g = cur_g
                                else:
                                    par_node.invalid.add(cur)
                                    cur_node.invalid.add(par)
                                    par_node.neighbors[par_node.cursor - 1][0] = _INF
                                    continue
                    else:
                        break

                if extend_neighbors(cur, cur_node, goal, cur_g):
                    key, j = cur_node.neighbors[cur_node.cursor]
                    cur_node.cursor += 1
                    open_set.append([key, j, cur])

        if not settings.optimize and parents[1] != _NO_PARENT:
            break

        # batch sampling: device-validated, sequential-stream selection
        added = 0
        while added < settings.batch_size and len(states) < settings.max_samples:
            q, ok = fns.sample_valid(offset)
            offset += len(q)
            for wi in range(len(q)):
                if ok[wi] and added < settings.batch_size and len(states) < settings.max_samples:
                    states.append(q[wi])
                    parents.append(_NO_PARENT)
                    nodes.append(_Node())
                    added += 1

    # recover the path to the first goal (reference utils recover_path semantics)
    solved = parents[1] != _NO_PARENT
    if solved:
        path = [1]
        while parents[path[-1]] != _NO_PARENT:
            path.append(parents[path[-1]])
        path = list(reversed(path))
        arr = np.stack([states[i] for i in path])
        return PRMResult(True, arr, float(nodes[1].g), iters, len(states))
    return PRMResult(False, np.stack([start]), _INF, iters, len(states))
