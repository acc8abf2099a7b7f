"""Time the planner megakernel of one source tree on the card.

    python vamp_mvt_tpu_torch/bench/time_planner.py [--tree DIR] [--label NAME]

Imports `vamp_mvt_tpu_torch` from `--tree` (default: the checkout holding
this file), so that an older tree unpacked beside it (`git archive`) can be
timed by the same script; run parent, change, change, parent in one call to
compare two versions on one card.  Times `rrtc_mega_cuda.plan` (CUDA events,
the median of 5 launches after one warm-up) on the 700 seeded sphere cages
at run_suite's Panda mega settings in the alternating cadence and, where the
tree runs it, the interleaved one, and on 64 Fetch problems (the first 64
of 2048 MBM-shaped scenes, seed 10, with two of 1024 seeded configurations,
seed 21, valid: `chip_smoke.py`'s suite_robots draw) in the alternating
cadence (3 launches).  Prints one JSON line with the card's name and each
median and its launches.
"""

import argparse
import dataclasses
import json
import sys
from pathlib import Path


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.tree).resolve()))
    import numpy as np
    import torch

    from vamp_mvt_tpu_torch.bench import mbm, scenes
    from vamp_mvt_tpu_torch.ops.kernels import build, fkcc_cuda, rrtc_mega_cuda
    from vamp_mvt_tpu_torch.planning import rrtc_mega
    from vamp_mvt_tpu_torch.robots import registry

    dev = torch.device("cuda")

    def timed(fn, reps):
        fn()
        times = []
        for _ in range(reps):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return {"ms": float(np.median(times)), "each_ms": times}

    out = {"label": args.label, "tree": args.tree, "device": torch.cuda.get_device_name(0)}
    spec = registry.load("panda")
    envs, st, gl, mk = mbm.build_batch(mbm.cage_suite(700)["problems"]["cage"], device=dev)
    s = mbm.default_settings("panda", "mega")
    ctl, nodes0, _, _ = rrtc_mega.mega_inputs(spec, envs, st, gl, mk, s)
    out["cages_alternating"] = timed(lambda: rrtc_mega_cuda.plan(spec, envs, ctl, nodes0, s), 5)
    si = dataclasses.replace(s, interleave=True)
    try:
        rrtc_mega._check_settings(si)
    except NotImplementedError:
        out["cages_interleaved"] = None
    else:
        out["cages_interleaved"] = timed(
            lambda: rrtc_mega_cuda.plan(spec, envs, ctl, nodes0, si), 5)

    fspec = registry.load("fetch")
    fenvs = mbm.build_batch(scenes.mbm_shaped_problems(2048, seed=10), device=dev)[0]
    q = scenes.seeded_configs(fspec, 2048, 1024, 21, dev)
    rows, fst, fgl, fmk = scenes.first_two_valid(q, fkcc_cuda.fkcc_batched(fspec, fenvs, q),
                                                 keep=64)
    fenvs = fenvs.map(lambda t: t[rows])
    fs = mbm.default_settings("fetch", "mega")
    fctl, fnodes0, _, _ = rrtc_mega.mega_inputs(fspec, fenvs, fst, fgl, fmk, fs)
    out["fetch64_alternating"] = timed(
        lambda: rrtc_mega_cuda.plan(fspec, fenvs, fctl, fnodes0, fs), 3)
    out["ptxas"] = build.ptxas_lines("rrtc_mega")
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
