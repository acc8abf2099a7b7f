"""The port's MBM command line (`vamp_mvt_tpu_torch/examples/evaluate_mbm.py`)
against the JAX script (`examples/evaluate_mbm.py`) on the CPU.

Both `main`s get the same arguments (--planner xla: the lockstep planner and
simplifier, what "auto" means on the CPU), the port's with device="cpu";
the JAX script prints its summary (and with --table the percentile table),
which the tests parse.  Here the first four problems of `cage_suite(8)`
through --problems_pkl, with the table; the rest of the cages, an
`mbm_shaped_suite` slice, the synthetic MBM tarball and --pointcloud are in
the other test_torch_evaluate_mbm_*.py files, so that xdist runs them side
by side.  Total, valid and solved counts and the median iterations must be
equal, the median costs within rtol 1e-5; a number the table prints with
"%.2f" within 0.005 (its rounding) + rtol 1e-5.  Both packages' parse and
batch caches point at tmp_path.
"""

import importlib
import json
import pickle
import re
import sys
from pathlib import Path

import numpy as np
import torch

from vamp_mvt_tpu.bench import mbm as jmbm
from vamp_mvt_tpu_torch.bench import mbm
from vamp_mvt_tpu_torch.examples import evaluate_mbm
from vamp_mvt_tpu_torch.planning import validate
from vamp_mvt_tpu_torch.robots import registry

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parent.parent
RTOL = 1e-5
ROUNDED = 0.005  # a number the table prints with "%.2f"
COUNTS = ("total_problems", "valid_problems", "solved_problems", "median_iterations")
COSTS = ("median_initial_cost", "median_simplified_cost")


def jax_script(name: str, folder: str = "examples"):
    """The repository's JAX script <folder>/<name>.py as a module."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    return importlib.import_module(f"{folder}.{name}")


def run_jax_script(monkeypatch, capsys, name: str, args: list[str],
                   folder: str = "examples") -> str:
    """The JAX script's main() with sys.argv set to `args`; its stdout."""
    script = jax_script(name, folder)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *args])
    capsys.readouterr()
    script.main()
    return capsys.readouterr().out


def point_caches(monkeypatch, tmp_path, resources=None):
    """Both packages' caches (and tarball roots, when given) in tmp_path."""
    for m, tag in ((mbm, "port"), (jmbm, "jax")):
        monkeypatch.setattr(m, "CACHE_DIR", tmp_path / f"{tag}_cache")
        if resources is not None:
            monkeypatch.setattr(m, "RESOURCES", resources)


def table_numbers(table: str) -> list[float]:
    return [float(x) for x in re.findall(r"-?\d+\.\d+", table)]


def assert_same_run(got: dict, jax_out: str, table: bool = False) -> dict:
    """The port's result against the JAX script's printed summary (and
    table); returns the JAX summary."""
    text = jax_out[jax_out.index("{"):]
    want, end = json.JSONDecoder().raw_decode(text)
    out = got["summary"]
    for k in COUNTS:
        assert out[k] == want[k], k
    for k in COSTS:
        assert (out[k] is None) == (want[k] is None), k
        if want[k] is not None:
            assert abs(out[k] - want[k]) <= RTOL * abs(want[k]), (k, out[k], want[k])
    assert set(want) <= set(out), set(want) - set(out)
    if table:
        jtable = text[end:].strip()
        assert got["table"].splitlines()[-1] == jtable.splitlines()[-1]  # Solved / Valid / Total
        a, b = table_numbers(got["table"]), table_numbers(jtable)
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            assert abs(x - y) <= ROUNDED + RTOL * abs(y), (x, y)
    return want


def paths_valid(problems, simplified) -> bool:
    """Every simplified path collision-free, segment by segment (plain)."""
    spec = registry.load("panda")
    envs = mbm.build_batch(problems, device="cpu")[0]
    paths = torch.as_tensor(simplified.path)
    num = validate.n_points_bound(spec, float(np.linalg.norm(spec.limits_high - spec.limits_low)))
    ok = validate.validate_motion_batch(spec, envs, paths[:, :-1], paths[:, 1:], num)
    k = torch.arange(1, paths.shape[1])
    return bool((ok | (k[None] >= torch.as_tensor(simplified.path_length)[:, None])).all())


def cage_pickle(tmp_path, half: int) -> tuple[str, list[dict]]:
    """Half `half` (problems 4 half .. 4 half + 3) of cage_suite(8) as a
    problem pickle."""
    data = mbm.cage_suite(8)
    data["problems"]["cage"] = data["problems"]["cage"][4 * half : 4 * half + 4]
    path = tmp_path / f"cages_{half}.pkl"
    path.write_bytes(pickle.dumps(data))
    return str(path), data["problems"]["cage"]


def check_cages(monkeypatch, capsys, tmp_path, half: int, table: bool):
    point_caches(monkeypatch, tmp_path)
    pkl, problems = cage_pickle(tmp_path, half)
    args = ["--problems_pkl", pkl, "--planner", "xla", "--batch_size", "4"]
    args += ["--table"] if table else []
    got = evaluate_mbm.main(args, device="cpu")
    assert got["summary"]["solved_problems"] == got["summary"]["valid_problems"] == 4
    assert paths_valid(problems, got["suite"].simplified)
    assert_same_run(got, run_jax_script(monkeypatch, capsys, "evaluate_mbm", args), table)


def test_evaluate_mbm_cages_matches_jax(monkeypatch, capsys, tmp_path):
    check_cages(monkeypatch, capsys, tmp_path, 0, table=True)
