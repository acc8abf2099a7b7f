"""The port's examples (`vamp_mvt_tpu_torch/examples/`) on the CPU, against
the JAX package's scripts (`examples/`).

Each example's `main` with device="cpu" and the JAX script's `main` with the
same arguments, on the same seeded inputs.  Here the sphere cage batch
through the lockstep planner and simplifier (the JAX script's CPU branch);
the API examples are in test_torch_examples_api.py (two files, so that
xdist runs them side by side).  The JAX scripts print their results; the
tests read them from stdout.  Solved flags, vertex and
node counts and roadmap sizes must be equal; a cost the JAX script prints to
two decimals must agree within 0.005 (its rounding) + 1e-5, a cost printed
in full within rtol 1e-5.  Every returned path is checked by the plain
collision check.
"""

import importlib
import re
import sys
from pathlib import Path

import torch

import vamp_mvt_tpu_torch as vmt
from vamp_mvt_tpu_torch.examples import sphere_cage_example

torch.set_num_threads(2)
CPU = "cpu"
ROOT = Path(__file__).resolve().parent.parent
ROUNDED = 0.005 + 1e-5  # a cost the JAX script prints with "%.2f"
RTOL = 1e-5


def _jax_stdout(capsys, name, *args) -> str:
    """Run the JAX script examples/<name>.py's main(*args); its stdout."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    script = importlib.import_module(f"examples.{name}")
    capsys.readouterr()
    script.main(*args)
    return capsys.readouterr().out


def _floats(text):
    return [float(x) for x in re.findall(r"-?\d+\.\d+(?:e-?\d+)?", text)]


def test_sphere_cage_example(capsys):
    out = sphere_cage_example.main(2, device=CPU)
    assert out["trials"] == 2 and out["solved"] == 2
    assert out["simplified_cost_median"] <= out["initial_cost_median"] + 1e-6
    assert out["device"] == CPU
    envs, _, _, _ = out["batch"]
    simp = out["simplified"]
    for b in range(2):
        path = simp.path[b, : int(simp.path_length[b])]
        env = envs.map(lambda t, b=b: t[b])
        assert all(bool(vmt.panda.validate_motion(p, q, env, device=CPU))
                   for p, q in zip(path[:-1], path[1:]))

    text = _jax_stdout(capsys, "sphere_cage_example", 2)
    solved, trials = map(int, re.search(r"solved (\d+)/(\d+)", text).groups())
    assert (solved, trials) == (out["solved"], 2)
    initial, simplified = _floats(re.search(r"initial cost median .*", text).group(0))
    assert abs(out["initial_cost_median"] - initial) <= ROUNDED
    assert abs(out["simplified_cost_median"] - simplified) <= ROUNDED

