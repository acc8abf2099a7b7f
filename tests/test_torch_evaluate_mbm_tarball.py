"""The port's MBM command line against the JAX script on the CPU, reading
problems the way the real MBM runs will: no --problems_pkl, so each script
parses `<robot>/problems.tar.bz2` under its package's RESOURCES (here the
synthetic tarball of `bench/scenes.py::write_mbm_tarball`, both packages
pointed at it) and takes the standard scenarios.  --max_problems 4 keeps
bookshelf_small's three problems and the first of "box", whose cylinders
become cuboids.  How the two runs are compared: test_torch_evaluate_mbm.py."""

from vamp_mvt_tpu_torch.bench import mbm, scenes
from vamp_mvt_tpu_torch.examples import evaluate_mbm

from test_torch_evaluate_mbm import assert_same_run, paths_valid, point_caches, run_jax_script


def test_evaluate_mbm_tarball_matches_jax(monkeypatch, capsys, tmp_path):
    scenes.write_mbm_tarball(tmp_path / "res")
    point_caches(monkeypatch, tmp_path, resources=tmp_path / "res")
    args = ["--planner", "xla", "--batch_size", "4", "--max_problems", "4", "--table"]
    got = evaluate_mbm.main(args, device="cpu")
    assert got["summary"]["solved_problems"] == got["summary"]["valid_problems"] == 4
    assert got["suite"].names == [("bookshelf_small", 1), ("bookshelf_small", 2),
                                  ("bookshelf_small", 3), ("box", 1)]
    data = mbm.load_problems("panda")
    problems = data["problems"]["bookshelf_small"] + data["problems"]["box"][:1]
    assert paths_valid(problems, got["suite"].simplified)
    assert_same_run(got, run_jax_script(monkeypatch, capsys, "evaluate_mbm", args), table=True)
