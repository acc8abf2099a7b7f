#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (vamp_mvt_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as one JSON line (no failure is caught: a failed check
or an exception exits non-zero):

  card    nvidia-smi's name and power limit, torch and CUDA versions
  build   the fused FK + collision kernel (csrc/fkcc.cu) built with nvcc
          into build/ (or loaded from there), and what ptxas reported
  kernel  700 seeded MBM-shaped Panda scenes (every primitive table) x 1024
          seeded configurations: the CUDA kernel against its plain PyTorch
          version on the card (validity may differ only where the plain
          minimum signed value is within 1e-5 of contact), with the kernel's
          time, the plain version's time and the bound of the card
  suite   the port's main path: run_suite("panda", planner="xla") on 700
          seeded sphere-cage problems (VAMP's sphere_cage_example with every
          sphere moved by up to 0.01): all must be valid and solved, every
          simplified path must revalidate on the card, and the run must have
          gone through the kernel (its launch count > 0)

then the kernels line and, last, {"ok": true, "device": {...}}.  The script
imports nothing of JAX or of the JAX package.  Without a GPU it exits 1.
"""

import json
import os
import subprocess
import sys
import time

KERNEL_PROBLEMS = 700
KERNEL_CONFIGS = 1024
SUITE_PROBLEMS = 700
CONTACT_BAND = 1e-5
# H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor cores, HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok, what: str) -> None:
    """A failed check ends the run (a check, not an assert: -O keeps it)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def mbm_shaped_problems(n: int, seed: int) -> list[dict]:
    """Seeded scenes with MotionBenchMaker's object counts and kinds: a few
    spheres, cylinders (some z-aligned; the 'box' scenario turns them into
    cuboids) and boxes (some rotated only about z) in front of the Panda."""
    import numpy as np

    from vamp_mvt_tpu_torch.bench.mbm import STANDARD_SCENARIOS
    from vamp_mvt_tpu_torch.robots import registry

    spec = registry.load("panda")
    rng = np.random.default_rng(seed)
    lo, hi = np.array([0.2, -0.6, 0.0]), np.array([0.9, 0.6, 1.2])
    problems = []
    for i in range(n):
        p = {"problem": STANDARD_SCENARIOS[i % len(STANDARD_SCENARIOS)], "index": i,
             "sphere": [], "cylinder": [], "box": [],
             "start": rng.uniform(spec.limits_low, spec.limits_high).tolist(),
             "goals": [rng.uniform(spec.limits_low, spec.limits_high).tolist()]}
        for _ in range(rng.integers(1, 4)):
            p["sphere"].append({"position": rng.uniform(lo, hi).tolist(),
                                "radius": float(rng.uniform(0.03, 0.12))})
        for j in range(rng.integers(2, 7)):
            e = rng.uniform(-np.pi, np.pi, 3) if j % 2 else np.zeros(3)
            p["cylinder"].append({"position": rng.uniform(lo, hi).tolist(),
                                  "orientation_euler_xyz": e.tolist(),
                                  "radius": float(rng.uniform(0.02, 0.06)),
                                  "length": float(rng.uniform(0.1, 0.4))})
        for j in range(rng.integers(4, 17)):
            e = (rng.uniform(-np.pi, np.pi, 3) if j % 3
                 else np.array([0.0, 0.0, rng.uniform(-np.pi, np.pi)]))
            p["box"].append({"position": rng.uniform(lo, hi).tolist(),
                             "orientation_euler_xyz": e.tolist(),
                             "half_extents": rng.uniform(0.02, 0.3, 3).tolist()})
        problems.append(p)
    return problems


def time_cuda(fn, warmup: int, reps: int) -> float:
    """Median milliseconds of `fn` over `reps` CUDA-event-timed calls."""
    import numpy as np
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from vamp_mvt_tpu_torch.bench import mbm
    from vamp_mvt_tpu_torch.collision.environment import LIVE_LIMIT, TABLES
    from vamp_mvt_tpu_torch.ops.kernels import fkcc_cuda
    from vamp_mvt_tpu_torch.planning import validate
    from vamp_mvt_tpu_torch.robots import registry

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)

    # --- card --------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    emit({"phase": "card", "nvidia_smi": smi, "device": name,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # --- build -------------------------------------------------------------
    fkcc_cuda.library()
    info = fkcc_cuda.BUILD_INFO
    emit({"phase": "build", "seconds": info["seconds"], "cached": info["cached"],
          "library": os.path.relpath(info["path"]),
          "ptxas": [l.strip() for l in info["log"].splitlines()
                    if "registers" in l or "spill" in l]})

    # --- kernel vs plain ---------------------------------------------------
    spec = registry.load("panda")
    problems = mbm_shaped_problems(KERNEL_PROBLEMS, seed=1)
    envs, _, _, _ = mbm.build_batch(problems, device=dev)
    rng = np.random.default_rng(2)
    q = torch.as_tensor(rng.uniform(
        spec.limits_low, spec.limits_high,
        (KERNEL_PROBLEMS, KERNEL_CONFIGS, spec.dimension)).astype(np.float32), device=dev)
    q_d = q.transpose(1, 2).contiguous()  # the lanes layout the main path uses
    live = {n: (getattr(envs, n)[..., 0].abs() < LIVE_LIMIT).sum(-1).cpu().numpy()
            for n in TABLES}
    check(all(int(live[n].sum()) > 0 for n in TABLES), "every primitive table has live rows")

    vk = fkcc_cuda.fkcc_vmin(spec, envs, q)
    ok_k = fkcc_cuda.fkcc_batched_lanes(spec, envs, q_d)
    vp = fkcc_cuda.fkcc_vmin_plain(spec, envs, q)
    torch.cuda.synchronize()
    check(vk.shape == vp.shape == ok_k.shape == (KERNEL_PROBLEMS, KERNEL_CONFIGS), "shapes")
    check(bool(torch.isfinite(vk).all()) and bool(torch.isfinite(vp).all()), "finite vmin")
    check(torch.equal(ok_k, vk >= 0), "kernel validity agrees with its own vmin")
    mism = (vk >= 0) != (vp >= 0)
    outside = mism & (vp.abs() > CONTACT_BAND)
    max_abs_err = float((vk - vp).abs().max())

    kernel_ms = time_cuda(lambda: fkcc_cuda.fkcc_batched_lanes(spec, envs, q_d), 3, 30)
    plain_ms = time_cuda(lambda: fkcc_cuda.fkcc_batched_plain(spec, envs, q), 1, 5)
    n_cfg = KERNEL_PROBLEMS * KERNEL_CONFIGS
    ops = fkcc_cuda.op_count(spec, live, KERNEL_CONFIGS)
    tabs = fkcc_cuda.robot_tables(spec)
    n_bytes = (q.numel() * 4 + sum(getattr(envs, n).numel() * 4 for n in TABLES)
               + sum(v.nbytes for v in tabs.values() if isinstance(v, np.ndarray))
               + n_cfg)  # one validity byte out per configuration
    ops_ms = ops / PEAK_FP32_FLOPS * 1e3
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    kernel = {
        "phase": "kernel", "problems": KERNEL_PROBLEMS, "configs_per_problem": KERNEL_CONFIGS,
        "live_rows_mean": {n: float(live[n].mean()) for n in TABLES},
        "valid_share": float((vk >= 0).float().mean()),
        "mismatches": int(mism.sum()), "mismatches_outside_band": int(outside.sum()),
        "band": CONTACT_BAND, "max_abs_err": max_abs_err,
        "kernel_ms": kernel_ms, "plain_ms": plain_ms,
        "fp32_ops": ops, "bytes": n_bytes, "ops_bound_ms": ops_ms, "bytes_bound_ms": bytes_ms,
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None,
    }
    emit(kernel)
    check(int(outside.sum()) == 0, "kernel and plain agree outside the contact band")

    # --- suite: the main path ---------------------------------------------
    data = mbm.cage_suite(SUITE_PROBLEMS, seed=0)
    timings = {}
    fkcc_cuda.LAUNCHES = 0
    t0 = time.perf_counter()
    res = mbm.run_suite("panda", data=data, planner="xla", timings=timings)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fkcc_cuda.LAUNCHES

    summary = res.summary()
    cage_envs = mbm.build_batch(data["problems"]["cage"], device=dev)[0]
    paths = torch.as_tensor(res.simplified.path, device=dev)
    lengths = torch.as_tensor(res.simplified.path_length, device=dev)
    num = validate.n_points_bound(spec, float(np.linalg.norm(spec.limits_high - spec.limits_low)))
    seg_ok = validate.validate_motion_batch(spec, cage_envs, paths[:, :-1], paths[:, 1:], num)
    k = torch.arange(1, paths.shape[1], device=dev)
    seg_ok = seg_ok | (k[None] >= lengths[:, None])
    paths_ok = int(seg_ok.all(1).sum())
    emit({"phase": "suite", "problems": SUITE_PROBLEMS, "wall_s": wall, "summary": summary,
          "timings": timings, "fkcc_launches": launches,
          "simplified_paths_revalidated": paths_ok})
    print(res.percentile_table(), flush=True)
    check(launches > 0, "the main path launched the fkcc kernel")
    check(summary["valid_problems"] == summary["solved_problems"] == SUITE_PROBLEMS,
          "every problem valid and solved")
    check(paths_ok == SUITE_PROBLEMS, "every simplified path revalidates")
    check(np.isfinite(res.simplified.cost).all(), "finite simplified costs")

    emit({"kernels": [{
        "name": "fkcc", "route": "cuda", "source": "vamp_mvt_tpu_torch/csrc/fkcc.cu",
        "replaces": "vamp_mvt_tpu/ops/kernels/fkcc_pallas.py:568",
        "replaces_function": "vamp_mvt_tpu/ops/kernels/fkcc_pallas.py::_run",
        "launches": launches, "max_abs_err": max_abs_err, "ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": kernel["bound_ms"],
        "bound_by": kernel["bound_by"], "library_ms": None,
        "checked_against_plain": True,
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
