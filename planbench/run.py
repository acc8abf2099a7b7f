"""Run one cell of the benchmark once.

    python3 planbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks for.
Set-up (the seeded pool, the runner's warm-up; the first run in a checkout
also builds the CUDA kernels into `build/`), a closed-loop window of at
least `--seconds`, with `--trace 1` a profiled slice after it, then the
plain reference's check of the window's answers.  Progress and the compared
numbers go to standard error; the last line of standard output is one JSON
object: correct, attempted, failed, metrics, device (and breakdown when
traced), with the compared numbers and their limits last.  Without a card,
or with fewer than the cell asks for, it prints no result and exits 2.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
# a library of the port that could load JAX by itself is kept from it
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from planbench import harness

    cell = harness.Cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"planbench: the cell needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    try:
        result = harness.execute(cell, args.seed, args.seconds, bool(args.trace), device,
                                 T_PROCESS)
    except harness.HarnessError as e:
        print(f"planbench: {e}", file=sys.stderr)
        return 1
    verdict = result.pop("_verdict")
    run = result.pop("_run")
    print("planbench: set-up " + json.dumps(run.setup_parts), file=sys.stderr)
    print("planbench: item seconds " + json.dumps([round(it["t1"] - it["t0"], 4)
                                                   for it in run.items]), file=sys.stderr)
    print("planbench: " + json.dumps({k: v for k, v in verdict.items()}), file=sys.stderr)
    for name, c in result["compared"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
