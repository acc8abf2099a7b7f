"""The port's MBM command line against the JAX script on the CPU: the last
four problems of `cage_suite(8)` through --problems_pkl (the first four,
and how the two runs are compared: test_torch_evaluate_mbm.py)."""

from test_torch_evaluate_mbm import check_cages


def test_evaluate_mbm_more_cages_matches_jax(monkeypatch, capsys, tmp_path):
    check_cages(monkeypatch, capsys, tmp_path, 1, table=False)
