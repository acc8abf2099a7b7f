"""Readings that the limits of `correct` are set from, for one cell.

    python3 planbench/calibrate.py --workload <cell> --seeds 1,2,3 [--seconds 4] [--fault F]

In one process, for each seed: a run of the cell (set-up, a short window at
the cell's own load, the same check sample as a run), then the compared
numbers of the program and of its control, the plain reference computed in
bfloat16 in the program's place on the same decisions, and each one's
`correct` by the harness's own comparison with the cell's limits.  One JSON
line a seed on standard output.  The benchmark's own runs never run the
control.  With `--fault` (`faults.FAULTS`), the program runs with that fault
planted, for the fault's readings.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)

    import contextlib

    import torch

    from planbench import faults, harness
    from planbench.reference import robot as ref_robot

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.Cell(args.workload)
    device = torch.device("cuda", 0)
    robot = ref_robot.load(cell.config["robot"])
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        fault = (faults.planted(faults.FAULTS[args.fault](robot)) if args.fault
                 else contextlib.nullcontext())
        with fault:
            res = harness.execute(cell, seed, args.seconds, False, device, t0, control=True)
        v = res.pop("_verdict")
        run = res.pop("_run")
        v["worst"] = [dict(w, **port_view(run, w)) for w in v["worst"]]
        control = v.pop("control")
        print(json.dumps({
            "workload": args.workload, "fault": args.fault, "seed": seed,
            "correct": res["correct"], "program": v,
            "control_correct": harness.compare(control, cell.limits["limits"])[1],
            "control": control, "attempted": res["attempted"], "failed": res["failed"],
            "metrics": {k: m["value"] for k, m in res["metrics"].items()},
            "seconds": time.perf_counter() - t0}), flush=True)
    return 0


def port_view(run, w) -> dict:
    """For a state the program called free and the reference did not: the
    reference's value in float32, and, for primitives, the port's own check
    of that state on the card (the port is asked here only, never in a
    benchmark run)."""
    import numpy as np
    import torch

    from planbench.reference import check

    dec, scene = run.decisions
    q = np.asarray([w["q"]])
    out = {"v32": float(check.values(run.robot, q, np.array([0]),
                                     (scene[0], [scene[1][w["row"]]], *scene[2:]),
                                     torch.float32, run.device)[0])}
    if scene[0] == "obstacles":
        from vamp_mvt_tpu_torch.bench import mbm
        from vamp_mvt_tpu_torch.planning import validate
        from vamp_mvt_tpu_torch.robots import registry

        envs = mbm.build_batch([dec.problems[w["row"]]], device=run.device)[0]
        qt = torch.tensor(q[None], dtype=torch.float32, device=run.device)
        out["port_free"] = bool(validate.fkcc_valid(registry.load(run.robot.name), envs,
                                                    qt)[0, 0])
        out["port_free_plain"] = bool(validate.fkcc_valid(
            registry.load(run.robot.name), envs.to("cpu"), qt.cpu())[0, 0])
    return out


if __name__ == "__main__":
    sys.exit(main())
