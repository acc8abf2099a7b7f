"""PRM / PRM* with batched device validation and host-side graph search.

Port of `vamp_mvt_tpu/planning/prm.py` (the reference's incremental PRM,
prm.hh:22-301): sample -> configuration validity -> k/r-nearest neighbours
-> edge validation -> union-find components -> A* once the start and a goal
share a component.

Sampling and every collision check run on the device in waves: one fkcc
launch validates a wave of Halton samples (`fkcc_batched`, one problem of
`wave` configurations), one more validates every candidate edge of the wave
(`validate_motion_batch`: B = 1, E = samples x neighbours, each edge at the
full-span point count).  The graph bookkeeping stays on the host in numpy,
line for line as in the JAX package (distances, argsort, the radius cut,
union-find, A*), so the two packages part only where a device result
differs.  Within a wave, neighbour candidates are the nodes that existed
before the wave.  Neighbour schedules mirror the reference's roadmap.hh:
PRM* log-k and a measure-based radius (roadmap.hh:42-77).

Runs on `device` (default: the GPU, through the CUDA fkcc kernel; "cpu" runs
the kernel's plain version).  Results are numpy, as the JAX package's are.
"""

from __future__ import annotations

import dataclasses
import heapq
import math
from typing import NamedTuple

import numpy as np
import torch

from vamp_mvt_tpu_torch.collision.environment import Environment
from vamp_mvt_tpu_torch.device import resolve_device
from vamp_mvt_tpu_torch.planning import validate as validate_mod
from vamp_mvt_tpu_torch.robots.spec import RobotSpec
from vamp_mvt_tpu_torch.sampling.halton import halton


def unit_ball_measure(dim: int) -> float:
    return math.sqrt(math.pi) ** dim / math.gamma(dim / 2.0 + 1.0)


@dataclasses.dataclass(frozen=True)
class PRMStarNeighborParams:
    """Reference roadmap.hh:42-77."""

    dim: int
    space_measure: float
    gamma_scale: float = 2.0

    def max_neighbors(self, num_states: int) -> int:
        c = math.e + math.e / self.dim
        return int(math.ceil(c * math.log(max(num_states, 2))))

    def neighbor_radius(self, num_states: int) -> float:
        inv_d = 1.0 / self.dim
        ratio = self.space_measure / unit_ball_measure(self.dim)
        c = 2.0 * (1.0 + inv_d) ** inv_d * ratio**inv_d
        n = max(num_states, 2)
        return self.gamma_scale * c * (math.log(n) / n) ** inv_d


@dataclasses.dataclass(frozen=True)
class ConstantNeighborParams:
    k: int = 2**31
    r: float = float("inf")

    def max_neighbors(self, num_states: int) -> int:
        return self.k

    def neighbor_radius(self, num_states: int) -> float:
        return self.r


@dataclasses.dataclass(frozen=True)
class PRMSettings:
    max_iterations: int = 100000
    max_samples: int = 4096
    wave: int = 64  # samples validated per device call
    neighbor_params: object = None


class Roadmap(NamedTuple):
    """Exported roadmap (reference plan.hh:181-188 / prm.hh build_roadmap)."""

    vertices: np.ndarray  # (N, d)
    edges: list           # list of (i, j) tuples


class PRMResult(NamedTuple):
    solved: bool
    path: np.ndarray       # (L, d)
    cost: float
    iterations: int
    size: int


class _UnionFind:
    def __init__(self):
        self.parent = []
        self.size = []

    def add(self):
        self.parent.append(len(self.parent))
        self.size.append(1)
        return len(self.parent) - 1

    def find(self, i):
        while self.parent[i] != i:
            self.parent[i] = self.parent[self.parent[i]]
            i = self.parent[i]
        return i

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return
        if self.size[ra] < self.size[rb]:
            ra, rb = rb, ra
        self.parent[rb] = ra
        self.size[ra] += self.size[rb]


def _astar(nodes, adj, start_idx, goal_idx):
    """Host A* (reference planning/utils.hh:76-142)."""
    n = len(nodes)
    g = np.full(n, np.inf)
    parent = np.full(n, -1, dtype=np.int64)
    goal = nodes[goal_idx]
    h = np.linalg.norm(nodes - goal, axis=1)
    g[start_idx] = 0.0
    pq = [(h[start_idx], start_idx)]
    closed = np.zeros(n, bool)
    while pq:
        f, u = heapq.heappop(pq)
        if closed[u]:
            continue
        closed[u] = True
        if u == goal_idx:
            path = [u]
            while parent[path[-1]] >= 0:
                path.append(int(parent[path[-1]]))
            return list(reversed(path)), float(g[u])
        for v, w in adj[u]:
            if g[u] + w < g[v]:
                g[v] = g[u] + w
                parent[v] = u
                heapq.heappush(pq, (g[v] + h[v], v))
    return None, float("inf")


class DeviceFns(NamedTuple):
    """The planners' device work, numpy in and out."""

    sample_valid: object     # offset -> (q (n, d), ok (n,)) for Halton offset + 0..n-1
    validate_edges: object   # starts (E, d), goals (E, d) -> (E,) bool
    validate_single: object  # start (d,), goal (d,) -> bool


def make_device_fns(spec: RobotSpec, env: Environment, n_samples: int, device) -> DeviceFns:
    """Halton samples `unit * spans + lows` checked by one fkcc launch of
    `n_samples` configurations; edges checked at the full-span point count
    `n_points_bound(spec, |limits|)`, all of a call in one launch."""
    dev = resolve_device(device)
    envs = env.to(dev).map(lambda t: t.unsqueeze(0))
    lows = torch.as_tensor(spec.limits_low, device=dev)
    spans = torch.as_tensor(spec.limits_high - spec.limits_low, device=dev)
    span = float(np.linalg.norm(spec.limits_high - spec.limits_low))
    num_long = validate_mod.n_points_bound(spec, span)
    steps = torch.arange(n_samples, dtype=torch.int32, device=dev)

    def sample_valid(offset):
        q = halton(offset + steps, spec.dimension) * spans + lows
        ok = validate_mod.fkcc_valid(spec, envs, q[None])[0]
        return q.cpu().numpy(), ok.cpu().numpy()

    def validate_edges(starts, goals):
        s = torch.as_tensor(np.asarray(starts, np.float32), device=dev)[None]
        g = torch.as_tensor(np.asarray(goals, np.float32), device=dev)[None]
        return validate_mod.validate_motion_batch(spec, envs, s, g, num_long)[0].cpu().numpy()

    def validate_single(s, g):
        return bool(validate_edges(np.asarray(s)[None], np.asarray(g)[None])[0])

    return DeviceFns(sample_valid, validate_edges, validate_single)


def _neighbor_params(spec, settings):
    return settings.neighbor_params or PRMStarNeighborParams(
        spec.dimension, spec.space_measure()
    )


def _wave_edges(np_params, nodes, q, validate_edges):
    """Candidate neighbours of a wave's valid samples q among `nodes` (the
    nodes before the wave) and their validity: (nn_idx, nn_d, valid), each
    (len(q), k_eff).  Edges out of range are masked to no-ops (goal =
    start) before the one validation call."""
    base = np.stack(nodes)
    k = np_params.max_neighbors(len(base))
    r = np_params.neighbor_radius(len(base))
    d = np.linalg.norm(base[None, :, :] - q[:, None, :], axis=-1)  # (W, N)
    k_eff = min(k, len(base))
    nn_idx = np.argsort(d, axis=1)[:, :k_eff]
    nn_d = np.take_along_axis(d, nn_idx, axis=1)
    in_r = nn_d <= r
    starts_e = np.repeat(q, k_eff, axis=0)
    goals_e = base[nn_idx.reshape(-1)]
    mask = in_r.reshape(-1)
    goals_e = np.where(mask[:, None], goals_e, starts_e)
    valid = validate_edges(starts_e, goals_e) & mask
    return nn_idx, nn_d, valid.reshape(len(q), k_eff)


def _star_settings(spec, **kw):
    return PRMSettings(**kw, neighbor_params=PRMStarNeighborParams(
        spec.dimension, spec.space_measure()))


def solve(
    spec: RobotSpec,
    env: Environment,
    start: np.ndarray,
    goals: np.ndarray,
    settings: PRMSettings | None = None,
    sample_offset: int = 0,
    device=None,
) -> PRMResult:
    """PRM solve: grow until the start and any goal share a component."""
    settings = settings or _star_settings(spec)
    np_params = _neighbor_params(spec, settings)
    fns = make_device_fns(spec, env, settings.wave, device)

    start = np.asarray(start, np.float32)
    goals = np.asarray(goals, np.float32).reshape(-1, spec.dimension)

    # straight-line check (prm.hh:57-70)
    for g in goals:
        if fns.validate_single(start, g):
            cost = float(np.linalg.norm(g - start))
            return PRMResult(True, np.stack([start, g]), cost, 0, 2)

    nodes = [start] + [g for g in goals]
    uf = _UnionFind()
    for _ in nodes:
        uf.add()
    adj: list[list] = [[] for _ in nodes]
    goal_ids = list(range(1, 1 + len(goals)))

    offset = sample_offset + 1
    iters = 0
    while iters < settings.max_iterations and len(nodes) < settings.max_samples:
        q, ok = fns.sample_valid(offset)
        offset += settings.wave
        iters += settings.wave
        q = q[ok]
        if not len(q):
            continue

        nn_idx, nn_d, valid = _wave_edges(np_params, nodes, q, fns.validate_edges)
        for wi in range(len(q)):
            idx = len(nodes)
            nodes.append(q[wi])
            adj.append([])
            uf.add()
            for kk in range(nn_idx.shape[1]):
                if valid[wi, kk]:
                    j = int(nn_idx[wi, kk])
                    w = float(nn_d[wi, kk])
                    adj[idx].append((j, w))
                    adj[j].append((idx, w))
                    uf.union(idx, j)

        for gid in goal_ids:
            if uf.find(0) == uf.find(gid):
                arr = np.stack(nodes)
                path_idx, cost = _astar(arr, adj, 0, gid)
                if path_idx is not None:
                    return PRMResult(True, arr[path_idx], cost, iters, len(nodes))

    return PRMResult(False, np.stack([start]), float("inf"), iters, len(nodes))


def build_roadmap(
    spec: RobotSpec,
    env: Environment,
    start: np.ndarray,
    goal: np.ndarray,
    settings: PRMSettings | None = None,
    sample_offset: int = 0,
    device=None,
) -> Roadmap:
    """Full roadmap construction without early exit (prm.hh:198-299)."""
    settings = settings or _star_settings(spec, max_samples=512)
    np_params = _neighbor_params(spec, settings)
    fns = make_device_fns(spec, env, settings.wave, device)

    nodes = [np.asarray(start, np.float32), np.asarray(goal, np.float32)]
    edges: list[tuple[int, int]] = []
    offset = sample_offset + 1
    iters = 0
    while iters < settings.max_iterations and len(nodes) < settings.max_samples:
        q, ok = fns.sample_valid(offset)
        offset += settings.wave
        iters += settings.wave
        q = q[ok]
        if not len(q):
            continue
        nn_idx, _, valid = _wave_edges(np_params, nodes, q, fns.validate_edges)
        for wi in range(len(q)):
            idx = len(nodes)
            nodes.append(q[wi])
            for kk in range(nn_idx.shape[1]):
                if valid[wi, kk]:
                    edges.append((idx, int(nn_idx[wi, kk])))

    return Roadmap(vertices=np.stack(nodes), edges=edges)
