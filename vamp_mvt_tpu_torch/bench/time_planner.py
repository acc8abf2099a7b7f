"""Time the two megakernels of one source tree on the card.

    python vamp_mvt_tpu_torch/bench/time_planner.py [--tree DIR] [--label NAME]
        [--shape T,G ...]

Imports `vamp_mvt_tpu_torch` from `--tree` (default: the checkout holding
this file), so that an older tree unpacked beside it (`git archive`) can be
timed by the same script; run parent, change, change, parent in one call to
compare two versions on one card.  Each time is the median of CUDA-event
timed launches after one warm-up, on these inputs:

  cages_alternating / cages_interleaved
      `rrtc_mega_cuda.plan` on the 700 seeded sphere cages at run_suite's
      Panda mega settings, in each cadence the tree runs (5 launches);
  cages_simplify
      `simplify_mega_cuda.simplify` on the plain planner's 700 cage paths
      (5 launches);
  fetch64_alternating
      `rrtc_mega_cuda.plan` on 64 Fetch problems: the first 64 of 2048
      MBM-shaped scenes (seed 10) with two of 1024 seeded configurations
      (seed 21) valid, `chip_smoke.py`'s suite_robots draw (3 launches);
  clouds64_alternating
      `rrtc_mega_cuda.plan` on 64 seeded pointcloud scenes at
      run_suite_pointcloud's settings: the first 64 of the MBM-shaped scenes
      (seed 1, spheres left out) with two of 1024 seeded configurations
      (seed 2) valid, their clouds built as run_suite_pointcloud builds them,
      `chip_smoke.py`'s rrtc_mega_pc draw (3 launches).

Each entry carries the launch's occupancy (`LAST_LAUNCH`) and, where the
tree's kernels export them, the phase clocks of one launch
(`fkcc_cuda.phase_split`).  `--shape T,G` also times every case at that
launch shape (threads a block, lanes a configuration), where the tree's
wrappers take one.  Prints one JSON line with the card's name and power
limit.
"""

import argparse
import dataclasses
import inspect
import json
import subprocess
import sys
from pathlib import Path


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--label", default="")
    ap.add_argument("--shape", action="append", default=[],
                    help="T,G: also time every case at this launch shape")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.tree).resolve()))
    import numpy as np
    import torch

    from vamp_mvt_tpu_torch.bench import mbm, scenes
    from vamp_mvt_tpu_torch.collision import environment as envmod
    from vamp_mvt_tpu_torch.ops.kernels import build, fkcc_cuda, rrtc_mega_cuda
    from vamp_mvt_tpu_torch.ops.kernels import simplify_mega_cuda
    from vamp_mvt_tpu_torch.planning import rrtc, rrtc_mega, simplify
    from vamp_mvt_tpu_torch.pointcloud import pipeline
    from vamp_mvt_tpu_torch.robots import registry

    dev = torch.device("cuda")
    takes_shape = "shape" in inspect.signature(rrtc_mega_cuda.plan).parameters
    shapes = [None] + ([tuple(int(x) for x in s.split(",")) for s in args.shape]
                       if takes_shape else [])

    def timed(mod, fn, reps):
        _, scal, work = fn()
        torch.cuda.synchronize()
        out = {"occupancy": dict(mod.LAST_LAUNCH)}
        if hasattr(mod, "PHASES"):
            out["phases"] = fkcc_cuda.phase_split(work, mod.WORK, mod.PHASES)
            # the blocks' cycles: the slowest block against the kernel's time
            cyc = work[:, mod.WORK:mod.WORK + len(mod.PHASES)].sum(1).double().cpu()
            slow = int(cyc.argmax())
            out["blocks"] = {"cycles_max": float(cyc.max()), "cycles_p50": float(cyc.median()),
                             "cycles_mean": float(cyc.mean()), "configs_of_slowest":
                             int(work[slow, 0]), "fkcc_cycles_of_slowest":
                             int(work[slow, mod.WORK + mod.PHASES.index("fkcc")])
                             if "fkcc" in mod.PHASES else None,
                             "steps_of_slowest": int(scal[slow, 9] + scal[slow, 10])
                             if scal.shape[1] > 10 else None}
        times = []
        for _ in range(reps):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return {"ms": float(np.median(times)), "each_ms": times, **out}

    def each_shape(name, mod, call, reps):
        for shape in shapes:
            key = name if shape is None else f"{name}@{shape[0]},{shape[1]}"
            kw = {} if shape is None else {"shape": shape}
            try:
                out[key] = timed(mod, lambda: call(**kw), reps)
            except ValueError as e:  # a shape that does not fit this case
                out[key] = {"refused": str(e)}

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                             "--format=csv,noheader"], capture_output=True, text=True,
                            check=True, timeout=60).stdout.strip()
    out = {"label": args.label, "tree": args.tree, "device": torch.cuda.get_device_name(0),
           "nvidia_smi": smi, "clocks_sm_idle_and_max": clocks}
    spec = registry.load("panda")
    envs, st, gl, mk = mbm.build_batch(mbm.cage_suite(700)["problems"]["cage"], device=dev)
    s = mbm.default_settings("panda", "mega")
    ctl, nodes0, _, _ = rrtc_mega.mega_inputs(spec, envs, st, gl, mk, s)
    each_shape("cages_alternating", rrtc_mega_cuda,
               lambda **kw: rrtc_mega_cuda.plan(spec, envs, ctl, nodes0, s, **kw), 5)
    si = dataclasses.replace(s, interleave=True)
    try:
        rrtc_mega._check_settings(si)
    except NotImplementedError:
        out["cages_interleaved"] = None
    else:
        each_shape("cages_interleaved", rrtc_mega_cuda,
                   lambda **kw: rrtc_mega_cuda.plan(spec, envs, ctl, nodes0, si, **kw), 5)

    pres = rrtc.plan_batch_compact(spec, envs, st, gl, mk, s, device=dev)
    sp, sl = pres.path.contiguous(), pres.path_length.to(torch.int32)
    ss = simplify.SimplifySettings(pair_chunk=64)
    each_shape("cages_simplify", simplify_mega_cuda,
               lambda **kw: simplify_mega_cuda.simplify(spec, envs, sp, sl, ss, **kw), 5)

    fspec = registry.load("fetch")
    fenvs = mbm.build_batch(scenes.mbm_shaped_problems(2048, seed=10), device=dev)[0]
    q = scenes.seeded_configs(fspec, 2048, 1024, 21, dev)
    rows, fst, fgl, fmk = scenes.first_two_valid(q, fkcc_cuda.fkcc_batched(fspec, fenvs, q),
                                                 keep=64)
    fenvs = fenvs.map(lambda t: t[rows])
    fs = mbm.default_settings("fetch", "mega")
    fctl, fnodes0, _, _ = rrtc_mega.mega_inputs(fspec, fenvs, fst, fgl, fmk, fs)
    each_shape("fetch64_alternating", rrtc_mega_cuda,
               lambda **kw: rrtc_mega_cuda.plan(fspec, fenvs, fctl, fnodes0, fs, **kw), 3)

    pc_scenes = scenes.mbm_shaped_problems(128, seed=1)
    cb = mbm.build_batch([dict(p, sphere=[]) for p in pc_scenes], device=dev)[0]
    q = scenes.seeded_configs(spec, 128, 1024, 2, dev)
    rows, pst, pgl, pmk = scenes.first_two_valid(q, fkcc_cuda.fkcc_batched(spec, cb, q), keep=64)
    penvs = envmod.stack_environments([envmod.EnvironmentBuilder(pck=pipeline.problem_to_pointcloud_env(
        "panda", dict(pc_scenes[r], start=pst[i].tolist(), goals=[pgl[i, 0].tolist()]),
        pc_repr="capt", samples_per_object=10000)[0].pck).build(device="cpu")
        for i, r in enumerate(rows)]).to(dev)
    ps = mbm.pointcloud_settings("panda")
    pctl, pnodes0, _, _ = rrtc_mega.mega_inputs(spec, penvs, pst, pgl, pmk, ps)
    each_shape("clouds64_alternating", rrtc_mega_cuda,
               lambda **kw: rrtc_mega_cuda.plan(spec, penvs, pctl, pnodes0, ps, **kw), 3)
    out["ptxas"] = {n: build.ptxas_lines(n) for n in ("rrtc_mega", "simplify_mega")}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
