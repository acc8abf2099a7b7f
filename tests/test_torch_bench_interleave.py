"""The port's interleave A/B entry on the CPU, at a small size.

`python -m vamp_mvt_tpu_torch.bench.interleave` (the counterpart of
tools/bench_interleave.py) with planner="xla", device="cpu" and 3 sphere
cages (the MBM problem files are absent, so it takes the seeded stand-in and
says so): it prints both cadences' rows and one parseable JSON line that
names its problem source and device, with every problem solved.  On the card
it runs with `planner="mega"` (chip_smoke.py's `mega_interleave` phase).
"""

import json

import torch

from vamp_mvt_tpu_torch.bench import interleave

torch.set_num_threads(1)

ARGS = ["--device", "cpu", "--planner", "xla", "--max-problems", "3"]


def _last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def test_interleave_entry_prints_both_cadences(capsys):
    ret = interleave.main(["panda", "3", *ARGS])
    out = capsys.readouterr().out
    line = _last_json(out)
    assert line == ret
    assert "interleave=False:" in out and "interleave=True:" in out and "speedup:" in out
    assert line["source"] == "cage_suite(3, seed=0)" and line["device"] == "cpu"
    for k in ("alternating", "interleaved"):
        assert line[k]["solved_problems"] == line[k]["valid_problems"] == 3
    # the lockstep planner ignores interleave: both runs plan alike
    assert line["cost_delta"] == 0.0
