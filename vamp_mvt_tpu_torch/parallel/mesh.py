"""Multi-device problem-batch sharding.

Port of `vamp_mvt_tpu/parallel/mesh.py`: pure data parallelism over a batch
of planning problems.  Per-problem planner state stays on its device; the
only collectives are the assembly of the sharded results and the reduction
of best costs in the anytime restarts.

A `Mesh` is this process's devices.  Under an initialised `torch.distributed`
group (`init_distributed`) each rank takes its slice of the batch, plans it
over its own mesh, and `all_gather` assembles the whole batch on every rank;
without one, the batch is split over the mesh's devices alone.  Each shard is
planned by the single-device functions (`rrtc.plan_batch`,
`simplify.simplify_batch`, `rrtc_mega.plan_batch_mega`), whose per-problem
results do not depend on the other problems of a batch, so a sharded result
equals the unsharded one.  Sample offsets and simplifier keys are taken from
the whole batch before it is split.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from vamp_mvt_tpu_torch.collision.environment import Environment
from vamp_mvt_tpu_torch.planning import rrtc, rrtc_mega, simplify
from vamp_mvt_tpu_torch.planning.phs import make_phs

RESTART_STRIDE = 100003  # sample offsets between the restarts of one round


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The devices of this process, one shard of the problem batch each."""

    devices: tuple

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: int | None = None, device=None) -> Mesh:
    """The local CUDA devices (the first `n_devices`), or `n_devices` (default
    1) entries of `device` when one is named, e.g. device="cpu".  Under a
    process group of CUDA ranks each rank's mesh is its own card
    (`init_distributed` sets it current)."""
    if device is not None:
        return Mesh((torch.device(device),) * (n_devices or 1))
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' for a CPU mesh")
    if _distributed():
        devs = [torch.device("cuda", torch.cuda.current_device())]
    else:
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return Mesh(tuple(devs[:n_devices] if n_devices is not None else devs))


def _distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def _ranks() -> tuple[int, int]:
    return (dist.get_rank(), dist.get_world_size()) if _distributed() else (0, 1)


def init_distributed(device=None, **kwargs) -> int:
    """Join the process group that torchrun's environment (MASTER_ADDR,
    RANK, WORLD_SIZE) or `kwargs` (init_method, world_size, rank) describe,
    with NCCL for CUDA ranks and gloo for CPU ranks (`device`, default the
    GPU); a backend that cannot start raises.  Returns the global device
    count: one a rank, or this process's devices without a group."""
    dev = torch.device(device) if device is not None else None
    cuda = dev is None or dev.type == "cuda"
    if os.environ.get("MASTER_ADDR") or kwargs:
        if cuda:
            if not torch.cuda.is_available():
                raise RuntimeError("no CUDA device is available; pass device='cpu' for gloo")
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        if not _distributed():
            dist.init_process_group(backend="nccl" if cuda else "gloo", **kwargs)
        return dist.get_world_size()
    return make_mesh(device=None if cuda else dev).size


def _rows(x, lo: int, hi: int, B: int):
    """Rows lo:hi of a batched tensor; tables shared by the batch (leading
    dim 1, B > 1) stay whole."""
    return x[lo:hi] if x.shape[0] == B else x


def _shard_envs(envs: Environment, lo: int, hi: int, B: int, dev) -> Environment:
    return envs.map(lambda t: _rows(t, lo, hi, B).to(dev))


def _gather_list(t: torch.Tensor) -> list[torch.Tensor]:
    """`t` of every rank of the group (bool as uint8: gloo and NCCL move
    bytes)."""
    x = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x)
    return [p.to(torch.bool) for p in parts] if t.dtype == torch.bool else parts


def _shards(mesh: Mesh, B: int) -> list[tuple]:
    """(device, lo, hi): this process's rows of a batch of B problems."""
    rank, world = _ranks()
    n = world * mesh.size
    if B % n:
        raise ValueError(f"batch of {B} does not divide over {n} devices")
    per = B // n
    return [(dev, (rank * mesh.size + i) * per, (rank * mesh.size + i + 1) * per)
            for i, dev in enumerate(mesh.devices)]


def _run_sharded(mesh: Mesh, B: int, fn):
    """fn(dev, lo, hi) -> a NamedTuple result for problems lo:hi on dev, run
    for each shard of this rank; the results concatenated over the mesh and
    gathered over the group."""
    parts = [fn(dev, lo, hi) for dev, lo, hi in _shards(mesh, B)]
    home = mesh.devices[0]
    local = [torch.cat([p[f].to(home) for p in parts]) for f in range(len(parts[0]))]
    if _distributed():
        local = [torch.cat(_gather_list(t)) for t in local]
    return type(parts[0])(*local)


def shard_batch(mesh: Mesh, tree):
    """This process's shards of a problem-batched tuple of tensors and
    Environments: one tuple a device of the mesh, each on its device."""
    B = max(t.spheres.shape[0] if isinstance(t, Environment) else t.shape[0] for t in tree)
    return [tuple(_shard_envs(t, lo, hi, B, dev) if isinstance(t, Environment)
                  else _rows(t, lo, hi, B).to(dev) for t in tree)
            for dev, lo, hi in _shards(mesh, B)]


def plan_batch_sharded(spec, mesh: Mesh, envs, starts, goals, masks,
                       settings: rrtc.RRTCSettings, sample_offsets=None):
    """Lockstep planning (rrtc.plan_batch) with the problem batch sharded
    over the mesh and the group (B divisible by their device count)."""
    B = starts.shape[0]

    def shard(dev, lo, hi):
        e = _shard_envs(envs, lo, hi, B, dev)
        offs = None if sample_offsets is None else sample_offsets[lo:hi].to(dev)
        return rrtc.plan_batch(spec, e, starts[lo:hi].to(dev), goals[lo:hi].to(dev),
                               masks[lo:hi].to(dev), settings, offs)

    return _run_sharded(mesh, B, shard)


def simplify_batch_sharded(spec, mesh: Mesh, envs, paths, lengths, settings, rng_keys=None):
    """simplify.simplify_batch sharded over the mesh and the group; each
    problem keeps its key of the whole batch (default split(PRNGKey(0), B))."""
    B = paths.shape[0]
    keys = simplify.default_keys(B, paths.device) if rng_keys is None else rng_keys

    def shard(dev, lo, hi):
        return simplify.simplify_batch(spec, _shard_envs(envs, lo, hi, B, dev),
                                       paths[lo:hi].to(dev), lengths[lo:hi].to(dev), settings,
                                       keys[lo:hi].to(dev))

    return _run_sharded(mesh, B, shard)


def plan_batch_mega_sharded(spec, mesh: Mesh, envs, starts, goals, masks,
                            settings: rrtc.RRTCSettings, sample_offsets=None):
    """The planner megakernel (rrtc_mega.plan_batch_mega) on each device's
    shard; nothing crosses devices while the kernels plan."""
    B = starts.shape[0]

    def shard(dev, lo, hi):
        e = _shard_envs(envs, lo, hi, B, dev)
        offs = None if sample_offsets is None else sample_offsets[lo:hi].to(dev)
        return rrtc_mega.plan_batch_mega(spec, e, starts[lo:hi].to(dev), goals[lo:hi].to(dev),
                                         masks[lo:hi].to(dev), settings, offs, device=dev)

    return _run_sharded(mesh, B, shard)


def aorrtc_restarts_sharded(spec, mesh: Mesh, env: Environment, start, goals,
                            settings: rrtc.RRTCSettings, rounds: int = 4, base_offset: int = 0):
    """Anytime refinement with one PHS-informed restart a device and a
    best-cost collective (reference aorrtc.hh:476-484 updates
    `best_path_cost` after each search).

    Every round, each of the R devices (over the group, R = world size x
    mesh size) runs an informed RRT-Connect restart (`rrtc.plan(..., phs=)`)
    at sample offset offset + r * 100003 against the best cost so far; the
    costs are reduced with all_reduce(MIN) (the JAX package's pmin) so the
    next round's sampler takes the global bound everywhere.  Returns
    (best_path, best_length, best_cost, per-round best costs)."""
    rank, world = _ranks()
    R = world * mesh.size
    d = spec.dimension
    home = mesh.devices[0]
    goals_np = np.asarray(goals, np.float32).reshape(-1, d)
    start_np = np.asarray(start, np.float32)

    def on(dev):
        return (env.to(dev), torch.as_tensor(start_np, device=dev),
                torch.as_tensor(goals_np, device=dev),
                torch.ones(goals_np.shape[0], dtype=torch.bool, device=dev))

    # initial (uniform) solution for the first bound
    res0 = rrtc.plan(spec, *on(home), settings, base_offset)
    best_cost = float(res0.cost) if bool(res0.solved) else np.inf
    best_path = res0.path.cpu().numpy()
    best_len = int(res0.path_length)
    history = [best_cost]

    offset = base_offset + int(res0.sample_count)
    for _ in range(rounds):
        if not np.isfinite(best_cost):
            diameter = float(np.linalg.norm(np.asarray(spec.limits_high)
                                            - np.asarray(spec.limits_low)))
        else:
            diameter = best_cost
        offsets = (offset + np.arange(R) * RESTART_STRIDE).astype(np.int32)
        costs, paths, lens = [], [], []
        for i, dev in enumerate(mesh.devices):
            phs = make_phs(start_np, goals_np[0], diameter, device=dev)
            res = rrtc.plan(spec, *on(dev), settings, int(offsets[rank * mesh.size + i]), phs=phs)
            costs.append(torch.where(res.solved, res.cost, torch.inf).to(home))
            paths.append(res.path.to(home))
            lens.append(res.path_length.to(home))
        local = (torch.stack(costs), torch.stack(paths), torch.stack(lens))
        best = torch.amin(local[0])
        if _distributed():
            local = tuple(torch.cat(_gather_list(t)) for t in local)
            dist.all_reduce(best, op=dist.ReduceOp.MIN)   # <- the cross-rank collective
        costs_np = local[0].cpu().numpy()
        k = int(np.argmin(costs_np))
        if np.isfinite(costs_np[k]) and costs_np[k] < best_cost:
            best_cost = float(costs_np[k])
            best_path = local[1][k].cpu().numpy()
            best_len = int(local[2][k])
        # the collective's minimum must agree with the host reduction
        if np.isfinite(np.min(costs_np)) and not np.isclose(float(best), np.min(costs_np)):
            raise RuntimeError(f"all_reduce(MIN) gave {float(best)}, the host {np.min(costs_np)}")
        history.append(best_cost)
        offset += R * RESTART_STRIDE
    return best_path, best_len, best_cost, history

