"""The port's benchmark entry points on the CPU, at a small size.

`python -m vamp_mvt_tpu_torch.bench` (the counterpart of bench.py) with
planner="xla", device="cpu" and 3 sphere cages (the MBM problem files are
absent, so it takes the seeded stand-in and says so): it prints one
parseable JSON line that names its problem source and device.  On the card
it runs with `planner="mega"` (chip_smoke.py's `bench` phase).  The
interleave A/B entry is tested in tests/test_torch_bench_interleave.py (a
file of its own, so that the two run side by side).
"""

import json

import torch

from vamp_mvt_tpu_torch.bench import __main__ as bench_main

torch.set_num_threads(1)

ARGS = ["--device", "cpu", "--planner", "xla", "--max-problems", "3"]


def _last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def test_bench_entry_prints_its_line(capsys):
    ret = bench_main.main(ARGS)
    line = _last_json(capsys.readouterr().out)
    assert line == ret
    assert line["metric"] == "mbm_panda_problems_per_sec" and line["unit"] == "problems/s"
    assert line["source"] == "cage_suite(3, seed=0)" and line["vs_baseline"] is None
    assert line["device"] == "cpu" and line["problems"] == 3 and line["value"] > 0
