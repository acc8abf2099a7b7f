"""Panda-in-sphere-cage benchmark (reference scripts/sphere_cage_example.py).

Port of `examples/sphere_cage_example.py`: every trial is the sphere cage
with each sphere moved by up to `variation`, all trials planned and
simplified as one batch.  On a GPU the batch runs through the planner and
simplifier megakernels; on the CPU through the lockstep planner and
simplifier, as the JAX script branches on its backend.

    python -m vamp_mvt_tpu_torch.examples.sphere_cage_example [n_trials] [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from vamp_mvt_tpu_torch.bench import mbm
from vamp_mvt_tpu_torch.collision import environment as envmod
from vamp_mvt_tpu_torch.device import resolve_device
from vamp_mvt_tpu_torch.planning import rrtc, rrtc_mega, simplify, simplify_mega
from vamp_mvt_tpu_torch.robots import registry

A = list(mbm.PANDA_START)
B = list(mbm.PANDA_GOAL)
CAGE = [list(c) for c in mbm.CAGE_CENTERS]
SETTINGS = rrtc.RRTCSettings(
    range=1.0, max_iterations=4096, max_samples=4096, max_path=96,
    samples_per_step=16, connect_segments=8,
)
SIMPLIFY = simplify.SimplifySettings(pair_chunk=64)
TIMED_OFFSET = 100  # the timed run's sample offset (the warm run's is 0)


def build_batch(n_trials: int, variation: float, radius: float, dev):
    """The trials' environments (the cage, each sphere moved by up to
    `variation`, in a shuffled order), starts, goals and goal masks."""
    rng = np.random.default_rng(0)
    envs = []
    for _ in range(n_trials):
        b = envmod.EnvironmentBuilder()
        order = rng.permutation(len(CAGE))
        for i in order:
            c = np.asarray(CAGE[i]) + rng.uniform(-variation, variation, 3)
            b.add_sphere(c, radius)
        envs.append(b.build(device=dev))
    starts = torch.tensor([A] * n_trials, dtype=torch.float32, device=dev)
    goals = torch.tensor([[B]] * n_trials, dtype=torch.float32, device=dev)
    masks = torch.ones((n_trials, 1), dtype=torch.bool, device=dev)
    return envmod.stack_environments(envs), starts, goals, masks


def main(n_trials: int = 100, variation: float = 0.01, radius: float = 0.2, device=None) -> dict:
    """The printed summary as a dict; besides, under "batch", "plan" and
    "simplified", the trials' inputs and the timed run's results."""
    dev = resolve_device(device)
    spec = registry.load("panda")
    batched, starts, goals, masks = build_batch(n_trials, variation, radius, dev)
    settings, ss = SETTINGS, SIMPLIFY

    # the card's path = the per-problem megakernels; the lockstep planner
    # stays the CPU path
    if dev.type == "cuda":
        def plan(o):
            return rrtc_mega.plan_batch_mega(spec, batched, starts, goals, masks, settings, o,
                                             device=dev)

        def simp(r):
            return simplify_mega.simplify_batch_mega(spec, batched, r.path, r.path_length, ss,
                                                     device=dev)

        def sync():
            torch.cuda.synchronize(dev)
    else:
        def plan(o):
            return rrtc.plan_batch(spec, batched, starts, goals, masks, settings, o)

        def simp(r):
            return simplify.simplify_batch(spec, batched, r.path, r.path_length, ss)

        def sync():
            pass

    offs = torch.zeros(n_trials, dtype=torch.long, device=dev)
    # warm both, then time with another sample offset
    simp(plan(offs))
    sync()
    t0 = time.perf_counter()
    r = plan(offs + TIMED_OFFSET)
    sync()
    t1 = time.perf_counter()
    s = simp(r)
    sync()
    t2 = time.perf_counter()

    solved = r.solved.cpu().numpy()
    out = {"trials": n_trials, "solved": int(solved.sum()), "plan_ms": 1e3 * (t1 - t0),
           "simplify_ms": 1e3 * (t2 - t1), "trials_per_s": n_trials / (t2 - t0),
           "initial_cost_median": float(np.median(r.cost.cpu().numpy()[solved])),
           "simplified_cost_median": float(np.median(s.cost.cpu().numpy()[solved])),
           "device": str(dev)}
    print(f"solved {out['solved']}/{n_trials}")
    print(f"plan {out['plan_ms']:.1f} ms, simplify {out['simplify_ms']:.1f} ms "
          f"-> {out['trials_per_s']:.0f} trials/s")
    print(f"initial cost median {out['initial_cost_median']:.2f}, "
          f"simplified {out['simplified_cost_median']:.2f}")
    return out | {"batch": (batched, starts, goals, masks), "plan": r, "simplified": s}


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n_trials", type=int, nargs="?", default=100)
    p.add_argument("--device", default=None)
    a = p.parse_args()
    main(a.n_trials, device=a.device)
