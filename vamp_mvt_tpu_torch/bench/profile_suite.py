"""Where the suite runner's, or the user API's, time goes on the GPU.

    python -m vamp_mvt_tpu_torch.bench.profile_suite [--problems 700] [--planner mega]
    python -m vamp_mvt_tpu_torch.bench.profile_suite --entry api

Runs `run_suite("panda", planner=...)` ("mega" or "xla") on the seeded
sphere-cage suite (or, with `--entry api`, one `panda.rrtc` call of the user
API on examples/attachments.py's payload in the cage) once to warm up, then
once under `torch.profiler`, and prints one JSON line: the wall time under the profiler, the device's busy
time (the summed duration of every CUDA kernel and copy), its idle share,
each of the port's kernels' device time and launches, and the kernels that
took the most device time.  The profiler adds
host overhead to every launch, so the wall time here is longer than an
unprofiled run's; the device times are not affected.
"""

from __future__ import annotations

import argparse
import functools
import json
import time
from collections import defaultdict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from vamp_mvt_tpu_torch.bench import mbm


def api_cage():
    """examples/attachments.py's scenario through the user API: the sphere
    cage with the payload [[0, 0, 0.12, 0.06]], VAMP's start A and goal B."""
    import vamp_mvt_tpu_torch as vmt

    env = vmt.Environment()
    for c in mbm.CAGE_CENTERS:
        env.add_sphere(vmt.Sphere(c, mbm.CAGE_RADIUS))
    env.attach(vmt.Attachment(spheres=[[0.0, 0.0, 0.12, 0.06]]))
    return env, mbm.PANDA_START, mbm.PANDA_GOAL


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--entry", choices=("suite", "api"), default="suite")
    ap.add_argument("--problems", type=int, default=700)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--planner", choices=("mega", "xla"), default="mega")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_suite needs a CUDA device")

    if args.entry == "api":
        import vamp_mvt_tpu_torch as vmt

        env, start, goal = api_cage()
        run = functools.partial(vmt.panda.rrtc, start, goal, env)
        problems, planner = 1, "lockstep"
    else:
        data = mbm.cage_suite(args.problems, seed=args.seed)
        run = functools.partial(mbm.run_suite, "panda", data=data, batch_size=args.problems,
                                planner=args.planner)
        problems, planner = args.problems, args.planner
    run()  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    per_name = defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            per_name[e.name][0] += e.time_range.elapsed_us()
            per_name[e.name][1] += 1
    busy_us = sum(v[0] for v in per_name.values())
    ours = {
        name: [v for k, v in per_name.items() if f"{name}_kernel" in k]
        for name in ("fkcc", "rrtc_mega", "simplify_mega")
    }
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:10]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "entry": args.entry,
        "problems": problems,
        "planner": planner,
        "solved": int(res.solved) if args.entry == "api" else res.summary()["solved_problems"],
        "wall_s_profiled": wall,
        "device_busy_s": busy_us / 1e6,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall,
        "device_launches": sum(v[1] for v in per_name.values()),
        "kernels": {
            name: {"device_s": sum(v[0] for v in vs) / 1e6, "launches": sum(v[1] for v in vs)}
            for name, vs in ours.items()
        },
        "top_kernels": [
            {"name": k[:80], "device_s": v[0] / 1e6, "launches": v[1]} for k, v in top
        ],
    }))


if __name__ == "__main__":
    main()
