"""The port's MPNet demonstrations (`vamp_mvt_tpu_torch/examples/
prepare_mpnet_dataset.py`) against the JAX script
(`examples/prepare_mpnet_dataset.py`) on the CPU.

Both scripts read the synthetic MBM tarball (`bench/scenes.py::
write_mbm_tarball`, both packages' RESOURCES pointed at it) and, for the
first two "cage" problems, sample and filter the cloud (500 points an
object; the script's default is 2000), build MVT, plan with the user API's RRT-Connect and simplify.
They must write the same files: the clouds, starts and goals equal, the
paths of the same length within rtol 1e-5 (atol 1e-6), and print the same
JSON line but for the directory.
"""

import json

import numpy as np
import torch

from vamp_mvt_tpu_torch.bench import scenes
from vamp_mvt_tpu_torch.examples import prepare_mpnet_dataset

from test_torch_evaluate_mbm import point_caches, run_jax_script

torch.set_num_threads(2)


def test_prepare_mpnet_dataset_matches_jax(monkeypatch, capsys, tmp_path):
    scenes.write_mbm_tarball(tmp_path / "res")
    point_caches(monkeypatch, tmp_path, resources=tmp_path / "res")
    args = ["--problem", "cage", "--count", "2", "--samples_per_object", "500"]
    got = prepare_mpnet_dataset.main([*args, "--out", str(tmp_path / "port")], device="cpu")
    out = capsys.readouterr().out
    jout = run_jax_script(monkeypatch, capsys, "prepare_mpnet_dataset",
                          [*args, "--out", str(tmp_path / "jax")])
    want = json.loads(jout.strip().splitlines()[-1])
    assert json.loads(out.strip().splitlines()[-1]) == {"written": 2, "dir": str(tmp_path / "port")}
    assert got["written"] == want["written"] == 2
    names = sorted(p.name for p in (tmp_path / "jax").glob("*.npz"))
    assert names == sorted(p.name for p in (tmp_path / "port").glob("*.npz"))
    assert names == ["cage_0.npz", "cage_1.npz"]
    for name in names:
        a, b = np.load(tmp_path / "port" / name), np.load(tmp_path / "jax" / name)
        assert set(a.files) == set(b.files) == {"pointcloud", "path", "start", "goal"}
        for k in ("pointcloud", "start", "goal"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a["path"].shape == b["path"].shape and a["path"].shape[0] >= 2
        np.testing.assert_allclose(a["path"], b["path"], rtol=1e-5, atol=1e-6)
