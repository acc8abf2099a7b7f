"""The comparison that decides `correct`: the program's verdicts against the
plain reference's.

The program decides two things that can be checked one by one:

- whether a problem is valid (its start and its goal free of contact), and
- that every state of each path it returns is free of contact: each vertex,
  and each segment at the robot's resolution (the fractions k/N, k = 1..N,
  N = 8 * max(ceil(|b - a| * resolution / 8), 1), of the program's motion
  check; a length a hair above a step of that grid takes the smaller N, see
  STEP_SLACK), the path joined to the problem's own start and goal.

The reference recomputes each decided state's signed value in float64.  A
verdict is wrong by the reference's value on the other side of zero: a state
called free that reads v < 0 is wrong by -v; a problem called invalid whose
start and goal read v_s, v_g >= 0 is wrong by min(v_s, v_g).  The compared
number, `verdict_gap_m2`, is the largest such amount (m^2; 0 when every
verdict agrees).  The program also reports each path's cost, the sum of its
segments' lengths; `cost_rel_gap` is the largest relative gap between a
reported cost and the same sum over the same vertices in float64.

The control puts the same reference, computed in bfloat16, in the program's
place, and is judged only where the program is: on the path states, the
states it calls free (a free state it calls in contact is a verdict the
program is never asked for); on the endpoints, both ways; and the costs it
sums over the same vertices.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from planbench.reference import geometry

# seconds spent in `values`, the reference's own time, which a run keeps out
# of its set-up time
SECONDS = 0.0

RAKE = 8
# A segment whose length lies within this share above a step of the grid
# (8 / resolution) takes the smaller N: the program computes N from a float32
# length (and a grow edge's from min(distance, range)), which may fall on
# either side of the step where the float64 length lies just above it.
STEP_SLACK = 1e-4


def segment_states(a: np.ndarray, b: np.ndarray, resolution: int):
    """The states the motion checks of segments a[i] -> b[i] cover, at the
    fractions k/N, k = 1..N: states (K, d) float64 and each one's (segment,
    k, N) (K, 3)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    dist = np.linalg.norm(b - a, axis=1)
    n = RAKE * np.maximum(np.ceil(dist * resolution / RAKE * (1.0 - STEP_SLACK)),
                          1).astype(np.int64)
    seg = np.repeat(np.arange(len(a)), n)
    k = np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n) + 1
    t = (k / n[seg])[:, None]
    return a[seg] + t * (b[seg] - a[seg]), np.stack([seg, k, n[seg]], 1)


def polyline_states(start, goal, path, resolution: int, meta: bool = False):
    """The states a path's motion check covers (K, d) float64: `start`, then
    every segment of start -> path[0] -> ... -> path[-1] -> goal at the
    fractions k/N, k = 1..N.  With `meta`, also each state's (segment, k, N)
    (K, 3), the start's (-1, 0, 0)."""
    pts = np.vstack([np.asarray(start, np.float64)[None], np.asarray(path, np.float64),
                     np.asarray(goal, np.float64)[None]])
    states, m = segment_states(pts[:-1], pts[1:], resolution)
    states = np.vstack([pts[:1], states])
    if not meta:
        return states
    return states, np.vstack([[-1, 0, 0], m])


class Decisions:
    """Verdicts to judge: states the program called free (`free`, one row a
    state, with the index of its problem) and problems it classified
    (`endpoints`: start and goal of each, with the verdict 'valid')."""

    def __init__(self, d: int):
        self.free_q, self.free_rows = [np.zeros((0, d))], [np.zeros(0, np.int64)]
        self.free_meta = [np.zeros((0, 4), np.int64)]
        self.end_q, self.end_rows, self.end_valid = [], [], []
        self.paths: list = []  # (vertices, reported cost) of each returned path
        self.problems: list = []  # the problem of each row, for reports

    def add_path(self, row: int, states: np.ndarray, meta=None):
        """States of one path (of problem `row`) called free; `meta` (K, 3)
        says where each lies (polyline_states(meta=True))."""
        self.free_q.append(states)
        self.free_rows.append(np.full(len(states), row, np.int64))
        serial = len(self.free_q) - 2
        m = np.zeros((len(states), 3), np.int64) if meta is None else meta
        self.free_meta.append(np.hstack([np.full((len(states), 1), serial), m]))

    def add_cost(self, vertices, cost: float):
        """A returned path's vertices and the cost the program reports."""
        self.paths.append((np.asarray(vertices, np.float64), float(cost)))

    def add_endpoints(self, row: int, start, goal, valid: bool):
        self.end_q.append(np.stack([np.asarray(start, np.float64), np.asarray(goal, np.float64)]))
        self.end_rows.append(row)
        self.end_valid.append(bool(valid))


def values(robot, q: np.ndarray, rows: np.ndarray, scene, dtype, device) -> np.ndarray:
    """Each state's least signed value in `dtype` (returned as float64):
    scene is ("obstacles", [obstacle rows a problem]) or ("clouds", [points
    a problem], point_radius)."""
    global SECONDS
    if len(q) == 0:
        return np.zeros(0)
    t0 = time.perf_counter()
    try:
        return _values(robot, q, rows, scene, dtype, device)
    finally:
        SECONDS += time.perf_counter() - t0


def _values(robot, q, rows, scene, dtype, device) -> np.ndarray:
    rtabs = robot.tensors(dtype, device)
    qt = torch.as_tensor(q, device=device).to(dtype)
    if scene[0] == "obstacles":
        env = geometry.stack(scene[1], dtype, device)
        v = geometry.vmin(robot, rtabs, qt, env=env,
                          env_rows=torch.as_tensor(rows, device=device))
        return v.double().cpu().numpy()
    out = np.empty(len(q))
    for r in np.unique(rows):
        sel = np.flatnonzero(rows == r)
        cloud = torch.as_tensor(scene[1][r], device=device).to(dtype)
        out[sel] = geometry.vmin(robot, rtabs, qt[sel], cloud=cloud,
                                 point_radius=scene[2]).double().cpu().numpy()
    return out


def judge(robot, dec: Decisions, scene, device, control: bool = False) -> dict:
    """The verdict gap of the program's decisions (control=False), or of the
    bfloat16 reference's verdicts on the same states (control=True)."""
    fq, fr = np.vstack(dec.free_q), np.concatenate(dec.free_rows)
    v = values(robot, fq, fr, scene, torch.float64, device)
    gap_free = np.maximum(-v, 0.0)
    if control:
        vc = values(robot, fq, fr, scene, torch.bfloat16, device)
        gap_free = np.where(vc >= 0, gap_free, 0.0)
    gap_end = np.zeros(0)
    wrong_valid = 0
    if dec.end_rows:
        eq = np.vstack(dec.end_q)
        er = np.repeat(np.asarray(dec.end_rows), 2)
        ve = values(robot, eq, er, scene, torch.float64, device).reshape(-1, 2)
        said = np.asarray(dec.end_valid)
        if control:
            said = (values(robot, eq, er, scene, torch.bfloat16, device).reshape(-1, 2)
                    >= 0).all(1)
        gap_end = np.where(said, np.maximum(-ve.min(1), 0.0), np.maximum(ve.min(1), 0.0))
        wrong_valid = int(((ve.min(1) >= 0) != said).sum())
    gaps = np.concatenate([gap_free, gap_end])
    cost_gap = cost_gaps(dec.paths, torch.bfloat16 if control else None)
    worst = []
    meta = np.vstack(dec.free_meta)
    for i in np.argsort(-gap_free)[:3]:
        if gap_free[i] <= 0:
            break
        worst.append({"row": int(fr[i]), "q": fq[i].tolist(), "v64": float(v[i]),
                      "path_seg_k_n": meta[i].tolist()})
    return {
        "worst": worst,
        "verdict_gap_m2": float(gaps.max()) if len(gaps) else 0.0,
        "cost_rel_gap": float(cost_gap.max()) if len(cost_gap) else 0.0,
        "wrong_states": int((gap_free > 0).sum()),
        "wrong_valid": wrong_valid,
        "states": int(len(fq)),
        "problems_classified": len(dec.end_rows),
    }


def cost_gaps(paths, dtype=None) -> np.ndarray:
    """Each path's relative gap between its cost (the program's reported
    one, or with `dtype` the sum computed in that type) and the float64 sum
    of its segments' lengths."""
    out = np.zeros(len(paths))
    for i, (x, reported) in enumerate(paths):
        ref = float(np.linalg.norm(np.diff(x, axis=0), axis=1).sum())
        if dtype is not None:
            xt = torch.as_tensor(x).to(dtype)
            reported = float(torch.linalg.vector_norm(xt[1:] - xt[:-1], dim=1).sum())
        out[i] = abs(reported - ref) / max(ref, 1e-6)
    return out


def reference_valid(robot, starts, goals, scene, device) -> np.ndarray:
    """(n,) whether each problem's start and goal read >= 0 in float64."""
    q = np.vstack([np.asarray(starts, np.float64), np.asarray(goals, np.float64)])
    n = len(starts)
    rows = np.concatenate([np.arange(n), np.arange(n)])
    v = values(robot, q, rows, scene, torch.float64, device)
    return (v[:n] >= 0) & (v[n:] >= 0)
