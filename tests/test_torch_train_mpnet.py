"""The port's MPNet trainer (`vamp_mvt_tpu_torch/tools/train_mpnet.py`)
against the JAX tool (`tools/train_mpnet.py`) on the CPU.

The dataset is three seeded npz files in `prepare_mpnet_dataset`'s layout:
one cloud above MAX_POINTCLOUD_SIZE points (subsampled with default_rng(0)),
two below (zero-padded), paths of 3-5 vertices.  `load_dataset` must give
the JAX function's arrays exactly.  Both tools then train at the published
widths for one epoch with --batch equal to the number of waypoint pairs, so
exactly one Adam step runs on the same batch from the same initial weights
(`init_mlp` from threefry key 7, bit-equal to jax.random).

Adam's first step moves a weight by lr * g / (|g| + eps), about +-lr
whatever |g| is, so a weight whose gradient lies within float rounding of 0
can move +lr in one package and -lr in the other; the zero-padded cloud
columns have g = 0 exactly in both and do not move.  Tolerances, from what
the packages measured here: every weight and bias within 2 lr + 1e-6; at
least 99.9% of them within 1e-5; the printed loss within its print's
rounding (5e-6) + rtol 1e-4.  No pre-activation of the batch is exactly 0
(where torch's own prelu and the JAX PReLU would differ in the gradient;
the port trains through `mlp_apply`, whose PReLU follows JAX's).

The port's checkpoint holds the trained PReLU alphas as `fc.{2i+1}.weight`,
and both packages' loaders read them back (the JAX tool's checkpoint has no
alpha keys, so its networks reload with every alpha at 0.25).  With fewer
pairs than --batch no step runs and the initial weights are saved.
"""

import re

import numpy as np
import torch
import jax

from vamp_mvt_tpu.planning import mpnet as jmpnet
from vamp_mvt_tpu_torch.planning import mpnet
from vamp_mvt_tpu_torch.tools import train_mpnet

from test_torch_evaluate_mbm import jax_script, run_jax_script

torch.set_num_threads(2)
LR = 3e-4
SIZES = ((13000, 5), (500, 3), (2000, 4))  # cloud points, path vertices


def write_dataset(path):
    rng = np.random.default_rng(11)
    path.mkdir()
    for i, (n, L) in enumerate(SIZES):
        pc = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
        p = np.cumsum(rng.normal(0, 0.3, (L, 7)), axis=0).astype(np.float32)
        np.savez(path / f"cage_{i}.npz", pointcloud=pc, path=p, start=p[0], goal=p[-1])
    return sum(2 * (L - 1) for _, L in SIZES)


def test_load_dataset_matches_jax(tmp_path):
    pairs = write_dataset(tmp_path / "d")
    got = train_mpnet.load_dataset(tmp_path / "d")
    want = jax_script("train_mpnet", "tools").load_dataset(tmp_path / "d", 7)
    assert len(got[1]) == pairs
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_one_training_step_matches_jax(monkeypatch, capsys, tmp_path, record_property):
    pairs = write_dataset(tmp_path / "d")
    argv = ["--data", str(tmp_path / "d"), "--epochs", "1", "--batch", str(pairs),
            "--lr", str(LR)]
    jout = run_jax_script(monkeypatch, capsys, "train_mpnet",
                          [*argv, "--out", str(tmp_path / "jax")], folder="tools")
    got = train_mpnet.main([*argv, "--out", str(tmp_path / "port")], device="cpu")
    out = capsys.readouterr().out
    assert got["pairs"] == pairs and got["steps"] == 1 and got["clouds"] == 3
    assert f"dataset: 3 clouds, {pairs} waypoint pairs" in jout.splitlines()[0]
    assert out.splitlines()[0] == jout.splitlines()[0]
    jloss = float(re.search(r"loss (\S+)", jout).group(1))
    assert abs(got["losses"][0] - jloss) <= 5e-6 + 1e-4 * abs(jloss)

    # no pre-activation of the batch is exactly 0
    enc0, pla0 = train_mpnet.init_networks(7, "cpu")
    pcs, pidx, cur, goal, _ = train_mpnet.load_dataset(tmp_path / "d")
    with torch.no_grad():
        x = torch.from_numpy(pcs[pidx])
        zeros = 0
        for net in (enc0, pla0):
            for i, (W, b, a) in enumerate(net.params()):
                x = x @ W + b
                zeros += int((x == 0).sum())
                x = mpnet._prelu(x, a) if i < len(net.linears) - 1 else x
            if net is enc0:
                x = torch.cat([x, torch.from_numpy(cur), torch.from_numpy(goal)], -1)
    assert zeros == 0

    flipped = total = 0
    worst = 0.0
    for name in ("encoder", "planner"):
        jsd = torch.load(tmp_path / "jax" / f"{name}.pt")
        psd = torch.load(tmp_path / "port" / f"{name}.pt")
        assert set(jsd) < set(psd)
        for k, want in jsd.items():
            diff = (psd[k] - want).abs()
            worst = max(worst, float(diff.max()))
            assert float(diff.max()) <= 2 * LR + 1e-6, k
            flipped += int((diff > 1e-5).sum())
            total += diff.numel()
    # the sign-flip band, reported in the JUnit XML (--junitxml)
    record_property("weights_past_1e-5", flipped)
    record_property("weights", total)
    record_property("max_weight_diff", worst)
    assert flipped <= 1e-3 * total, (flipped, total)

    # the trained alphas, through both loaders
    for name, net0 in (("encoder", enc0), ("planner", pla0)):
        f = tmp_path / "port" / f"{name}.pt"
        sd = torch.load(f)
        n = len(net0.linears)
        alphas = [float(sd[f"fc.{2 * i + 1}.weight"]) for i in range(n - 1)]
        assert all(abs(a - 0.25) > 0.5 * LR for a in alphas), alphas  # trained, not 0.25
        port = mpnet.load_torch_state_dict(f)
        jparams = jmpnet.load_torch_state_dict(str(f), None)
        for i, ((W, b, a), (jW, jb, ja)) in enumerate(zip(port.params(), jparams)):
            want_a = alphas[i] if i < n - 1 else 0.25
            assert a.item() == want_a and float(ja) == a.item()
            np.testing.assert_array_equal(W.detach().numpy(), np.asarray(jW))
            np.testing.assert_array_equal(b.detach().numpy(), np.asarray(jb))
            np.testing.assert_array_equal(W.detach().numpy(),
                                          sd[f"fc.{2 * i}.weight"].numpy().T)


def test_no_step_below_one_batch(tmp_path, capsys):
    pairs = write_dataset(tmp_path / "d")
    got = train_mpnet.main(["--data", str(tmp_path / "d"), "--epochs", "2", "--batch",
                            str(pairs + 1), "--out", str(tmp_path / "o")], device="cpu")
    assert got["steps"] == 0 and got["step_ms"] is None
    enc0, _ = train_mpnet.init_networks(7, "cpu")
    sd = torch.load(tmp_path / "o" / "encoder.pt")
    for i, (lin, act) in enumerate(zip(enc0.linears, enc0.prelus)):
        assert torch.equal(sd[f"fc.{2 * i}.weight"], lin.weight.detach())
        if i < len(enc0.linears) - 1:
            assert float(sd[f"fc.{2 * i + 1}.weight"]) == 0.25
