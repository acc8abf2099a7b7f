"""The port's MPNet evaluation over MBM problems
(`vamp_mvt_tpu_torch/examples/evaluate_mbm_mpnet.py`) against the JAX script
(`examples/evaluate_mbm_mpnet.py`) on the CPU.

Both read the synthetic MBM tarball (`bench/scenes.py::write_mbm_tarball`)
and plan its first two "cage" problems with `plan_with_mpnet` on MVT clouds
(500 points an object), RRT-Connect behind it, at carried weights: the
checkpoints the port's trainer writes for its initial networks
(`tools/train_mpnet.py`: `init_mlp` from threefry key 7, bit-equal to
jax.random, PReLU alphas included), which both loaders read.  The JAX
script's answers are read through a wrapper around its `plan_with_mpnet`
(its printed lines give no vertex counts).  Methods and vertex counts must
be equal, vertices within 1e-4 (MPNet's rollouts, as test_torch_mpnet.py
holds them), the printed costs within their rounding (0.0005) + rtol 1e-5,
except where the JAX function returns as "mpnet" a rollout with a colliding
segment: the port checks every segment and falls back to RRT-Connect
(ROADMAP, settled faults), and the test checks that this is the reason.
Here the first problem is such a case, the second one is not.
"""

import re

import numpy as np
import torch

from vamp_mvt_tpu.planning import mpnet as jmpnet
from vamp_mvt_tpu_torch.bench import mbm, scenes
from vamp_mvt_tpu_torch.examples import evaluate_mbm_mpnet
from vamp_mvt_tpu_torch.planning import validate
from vamp_mvt_tpu_torch.pointcloud import pipeline
from vamp_mvt_tpu_torch.robots import registry
from vamp_mvt_tpu_torch.tools import train_mpnet

from test_torch_evaluate_mbm import point_caches, run_jax_script

torch.set_num_threads(2)


def test_evaluate_mbm_mpnet_matches_jax(monkeypatch, capsys, tmp_path):
    scenes.write_mbm_tarball(tmp_path / "res")
    point_caches(monkeypatch, tmp_path, resources=tmp_path / "res")
    enc, pla = train_mpnet.init_networks(7, "cpu")
    for name, net in (("encoder", enc), ("planner", pla)):
        torch.save(train_mpnet.state_dict(net), tmp_path / f"{name}.pt")
    args = ["--problem", "cage", "--max_problems", "2", "--samples_per_object", "500",
            "--encoder", str(tmp_path / "encoder.pt"), "--planner", str(tmp_path / "planner.pt")]
    got = evaluate_mbm_mpnet.main(args, device="cpu")
    out = capsys.readouterr().out

    answers = []
    plan = jmpnet.plan_with_mpnet

    def record(*a, **k):
        answers.append(plan(*a, **k))
        return answers[-1]

    monkeypatch.setattr(jmpnet, "plan_with_mpnet", record)
    jout = run_jax_script(monkeypatch, capsys, "evaluate_mbm_mpnet", args)
    rows = got["rows"]
    assert len(rows) == len(answers) == 2
    data = mbm.load_problems("panda")
    same = 0
    for r, (jpath, jmode), prob in zip(rows, answers, data["problems"]["cage"]):
        if r["method"] != jmode:
            # the JAX function returns an MPNet path without checking its
            # segments; the port checks them and falls back to RRTC (ROADMAP,
            # settled faults): the JAX path must hold a colliding segment
            assert (r["method"], jmode) == ("rrtc_fallback", "mpnet")
            assert not segments_valid(prob, jpath) and segments_valid(prob, r["path"])
            continue
        same += 1
        assert len(r["path"]) == len(jpath) >= 2
        np.testing.assert_allclose(np.stack(r["path"]), np.stack(jpath), atol=1e-4)
        printed = [l for l in out.splitlines() if l.startswith(f"cage[{r['index']}]:")]
        jprinted = [l for l in jout.splitlines() if l.startswith(f"cage[{r['index']}]:")]
        assert len(printed) == len(jprinted) == 1
        a, b = (re.sub(r"\d+\.\d+ ms", "", x) for x in (printed[0], jprinted[0]))
        assert re.sub(r"\d+\.\d+", "#", a) == re.sub(r"\d+\.\d+", "#", b)
        for x, y in zip(re.findall(r"\d+\.\d+", a), re.findall(r"\d+\.\d+", b)):
            assert abs(float(x) - float(y)) <= 0.0005 + 1e-5 * float(y), (a, b)
    assert same >= 1
    neural = sum(r["method"] == "mpnet" for r in rows)
    assert (got["solved"], got["neural"]) == (2, neural)
    assert f"2/2 solved ({neural} purely neural, {2 - neural} via RRTC fallback)" in out


def segments_valid(problem, path) -> bool:
    """Every segment of `path` collision-free in the problem's cloud, as the
    script builds it (the port's plain check)."""
    b = pipeline.problem_to_pointcloud_env("panda", problem, pc_repr="mvt",
                                           samples_per_object=500, kernel_pc=False)[0]
    spec = registry.load("panda")
    envs = b.build(device="cpu").map(lambda t: t[None])
    q = torch.as_tensor(np.stack(path).astype(np.float32))[None]
    num = validate.n_points_bound(spec, float(np.linalg.norm(spec.limits_high - spec.limits_low)))
    return bool(validate.validate_motion_batch(spec, envs, q[:, :-1], q[:, 1:], num).all())
