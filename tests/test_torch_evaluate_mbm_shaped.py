"""The port's MBM command line against the JAX script on the CPU, on the
first three problems of `bench/scenes.py::mbm_shaped_suite` (MBM-shaped
scenes: spheres, capsules, cuboids, and the "box" scenario's cylinders as
cuboids) through --problems_pkl, with the table (how the two runs are
compared: test_torch_evaluate_mbm.py).  These three are solved within the
first budget, so that neither package runs its 32x straggler retry, which
takes many minutes on the CPU."""

import pickle

from vamp_mvt_tpu_torch.bench import scenes
from vamp_mvt_tpu_torch.examples import evaluate_mbm

from test_torch_evaluate_mbm import assert_same_run, paths_valid, point_caches, run_jax_script

N = 3


def test_evaluate_mbm_mbm_shaped_matches_jax(monkeypatch, capsys, tmp_path):
    point_caches(monkeypatch, tmp_path)
    suite = scenes.mbm_shaped_suite("panda", N, device="cpu")
    problems = suite["problems"]["mbm_shaped"]
    assert {p["problem"] for p in problems} >= {"bookshelf_small", "bookshelf_thin"}
    pkl = tmp_path / "mbm_shaped.pkl"
    pkl.write_bytes(pickle.dumps(suite))
    args = ["--problems_pkl", str(pkl), "--planner", "xla", "--batch_size", str(N), "--table"]
    got = evaluate_mbm.main(args, device="cpu")
    assert got["summary"]["solved_problems"] == got["summary"]["valid_problems"] == N
    assert paths_valid(problems, got["suite"].simplified)
    assert_same_run(got, run_jax_script(monkeypatch, capsys, "evaluate_mbm", args), table=True)
