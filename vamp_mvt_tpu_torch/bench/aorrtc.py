"""AORRTC's anytime table on the card: cost against samples, batched.

    python -m vamp_mvt_tpu_torch.bench.aorrtc [n] [--device cuda]
                                              [--max-iterations 32768]

The counterpart of the JAX package's `tools/bench_aorrtc.py`, at its
settings: `aorrtc.solve_batch(history=True)` with RRT-Connect at the Panda's
range 1.0, a 4096-sample budget, 2048 node rows, 96 path rows, K 16, C 8,
W 4, SHORTCUT + BSPLINE with 64-pair chunks, 32768 anytime samples and
4096-sample internal searches (reference aorrtc_settings.hh:8-23).  Its
problems are `n` (default 32) of `mbm.cage_suite`'s seeded sphere cages:
the MBM problem files are absent.  `--max-iterations` cuts the anytime
budget (fewer refinement rounds).

Prints the card's name and power limit (nvidia-smi), the per-round median
cost and median cost over the straight-line bound, the final median, the
mean excess over the bound and the median samples, then one JSON line with
the same numbers, the wall and the fkcc launches.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from vamp_mvt_tpu_torch.bench import mbm
from vamp_mvt_tpu_torch.device import resolve_device
from vamp_mvt_tpu_torch.ops.kernels import fkcc_cuda
from vamp_mvt_tpu_torch.planning import aorrtc, aox, rrtc, simplify
from vamp_mvt_tpu_torch.robots import registry

PROBLEMS = 32
MAX_ITERATIONS = 32768


def settings(max_iterations: int = MAX_ITERATIONS) -> aorrtc.AORRTCSettings:
    return aorrtc.AORRTCSettings(
        rrtc=rrtc.RRTCSettings(range=registry.RRT_RANGES["panda"], max_iterations=4096,
                               max_samples=2048, max_path=96, samples_per_step=16,
                               connect_segments=8, sample_window=4),
        simplify=simplify.SimplifySettings(pair_chunk=64),
        max_iterations=max_iterations,
        max_internal_iterations=4096,
    )


def card() -> str:
    """nvidia-smi's name and power limit of the card, or "" without one."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""


def run(n: int = PROBLEMS, device=None, max_iterations: int = MAX_ITERATIONS) -> dict:
    """solve_batch on n seeded cages: the anytime table as a dict."""
    dev = resolve_device(device)
    spec = registry.load("panda")
    problems = mbm.cage_suite(n)["problems"]["cage"]
    envs, starts, goals, masks = mbm.build_batch(problems, device=dev)
    valid = mbm._valid_fused(spec, envs, starts, goals, masks).cpu().numpy()

    fkcc_cuda.LAUNCHES = 0
    aox.HOST_SYNCS = 0
    t0 = time.perf_counter()
    res, samples, hist = aorrtc.solve_batch(spec, envs, starts, goals, masks,
                                            settings(max_iterations), history=True, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0

    cost = res.cost.cpu().numpy()
    ok = (cost < 1e29) & valid
    bound = np.linalg.norm(starts.cpu().numpy() - goals[:, 0].cpu().numpy(), axis=1)
    # no valid path beats the straight line: a cost below it is a planner fault
    below = ok & (cost < bound - 1e-4)
    if below.any():
        raise AssertionError(f"solved costs below the straight-line bound: {np.flatnonzero(below)}")
    rounds = []
    for rd in range(hist.shape[0]):
        c = hist[rd][ok]
        fin = c < 1e29
        if fin.any():
            rounds.append({"round": rd, "median_cost": float(np.median(c[fin])),
                           "median_cost_over_bound": float(np.median(c[fin] / bound[ok][fin]))})
    final = cost[ok]
    return {
        "problems": n, "valid": int(valid.sum()), "solved": int(ok.sum()),
        "max_iterations": max_iterations, "rounds_run": hist.shape[0] - 1, "wall_s": wall,
        "rounds": rounds,
        "median_bound": float(np.median(bound[ok])) if ok.any() else None,
        "final_median_cost": float(np.median(final)) if ok.any() else None,
        "mean_excess_over_bound": float(np.mean(final / bound[ok] - 1)) if ok.any() else None,
        "median_samples": float(np.median(samples.cpu().numpy()[ok])) if ok.any() else None,
        "fkcc_launches": fkcc_cuda.LAUNCHES, "aox_host_syncs": aox.HOST_SYNCS,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n", nargs="?", type=int, default=PROBLEMS)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--max-iterations", type=int, default=MAX_ITERATIONS)
    args = ap.parse_args(argv)
    smi = card()
    if smi:
        print(smi, flush=True)
    line = run(args.n, args.device, args.max_iterations)
    print(f"{line['problems']} cage problems ({line['valid']} valid, {line['solved']} solved) "
          f"in {line['wall_s']:.1f} s wall")
    print("| round | median cost | median cost/bound |")
    print("|---|---|---|")
    for r in line["rounds"]:
        print(f"| {r['round']} | {r['median_cost']:.3f} | {r['median_cost_over_bound']:.4f} |")
    if line["solved"]:
        print(f"final: median {line['final_median_cost']:.3f} (straight line "
              f"{line['median_bound']:.3f}), mean excess over the bound "
              f"{line['mean_excess_over_bound'] * 100:.2f}%, median samples "
              f"{line['median_samples']:.0f}")
    print(json.dumps(line | {"nvidia_smi": smi}), flush=True)
    return line


if __name__ == "__main__":
    main()
