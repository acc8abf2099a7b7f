"""The port's MBM command line with --pointcloud against the JAX script on
the CPU: the first two problems of the synthetic MBM tarball
(`bench/scenes.py::write_mbm_tarball`), their cylinders and boxes sampled
at 500 points an object, filtered (SCDF) and built as each package builds
them on the CPU (batched MVT / CAPT; the lockstep planner and simplifier).
The summary, the four keys the pointcloud branch adds (its filter and
build medians are host timings: present and positive, not compared), and
the table are compared as test_torch_evaluate_mbm.py compares them."""

import pytest

from vamp_mvt_tpu_torch.bench import scenes
from vamp_mvt_tpu_torch.examples import evaluate_mbm

from test_torch_evaluate_mbm import assert_same_run, point_caches, run_jax_script


@pytest.mark.parametrize("pc_repr", ["capt"])
def test_evaluate_mbm_pointcloud_matches_jax(monkeypatch, capsys, tmp_path, pc_repr):
    scenes.write_mbm_tarball(tmp_path / "res")
    point_caches(monkeypatch, tmp_path, resources=tmp_path / "res")
    args = ["--pointcloud", "--pc_repr", pc_repr, "--max_problems", "2", "--batch_size", "2",
            "--samples_per_object", "500", "--table"]
    got = evaluate_mbm.main(args, device="cpu")
    out = got["summary"]
    assert out["solved_problems"] == out["valid_problems"] == 2
    assert (out["pc_repr"], out["filter_type"]) == (pc_repr, "scdf")
    assert out["filter_median_ms"] > 0 and out["build_median_ms"] > 0
    want = assert_same_run(got, run_jax_script(monkeypatch, capsys, "evaluate_mbm", args),
                           table=True)
    assert (want["pc_repr"], want["filter_type"]) == (pc_repr, "scdf")
