"""Train MPNet (encoder + planner MLPs) on demonstration paths.

Port of `tools/train_mpnet.py`.  Reads the npz dataset that
`examples/prepare_mpnet_dataset.py` writes, trains the networks of
`planning/mpnet.py` at their published widths jointly with Adam on the
next-waypoint MSE (forward and reversed paths, as the reference's
bidirectional planner consumes them), and saves torch state dicts that
`plan_with_mpnet(encoder_path=, planner_path=)` loads.

As the JAX tool: the same clouds (subsampled with `default_rng(0)` or
zero-padded to MAX_POINTCLOUD_SIZE points) and waypoint pairs in the same
order, the same initial weights (`init_mlp` from threefry key 7 split once,
bit-equal to `jax.random`), the same shuffle (`default_rng(1)`, an epoch's
remainder of fewer than --batch pairs dropped), every parameter (the PReLU
alphas too) trained by Adam at --lr on `mlp_apply`'s forward.  With fewer
pairs than --batch no step runs and the initial weights are saved.

Unlike the JAX tool, which saves only `fc.{2i}.weight/bias` (so that its
checkpoints reload with every alpha at 0.25), each checkpoint also holds
the trained alpha of the PReLU after layer i as `fc.{2i+1}.weight`, the
key both packages' `load_torch_state_dict` read.  Trains on the GPU unless
--device (or `device`) names another.

    python -m vamp_mvt_tpu_torch.tools.train_mpnet [--data DIR] [--out DIR]
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from vamp_mvt_tpu_torch.planning import mpnet


def load_dataset(data_dir, d=None):
    """(clouds (n, 3 MAX_POINTCLOUD_SIZE), cloud index, current, goal, next)
    of every waypoint pair, as the JAX tool's `load_dataset`."""
    pcs, samples = [], []
    rng = np.random.default_rng(0)
    files = sorted(Path(data_dir).glob("*.npz"))
    for pi, f in enumerate(files):
        z = np.load(f)
        pc = z["pointcloud"].reshape(-1, 3)
        if len(pc) > mpnet.MAX_POINTCLOUD_SIZE:
            pc = pc[rng.choice(len(pc), mpnet.MAX_POINTCLOUD_SIZE, replace=False)]
        elif len(pc) < mpnet.MAX_POINTCLOUD_SIZE:
            pc = np.vstack([pc, np.zeros((mpnet.MAX_POINTCLOUD_SIZE - len(pc), 3), np.float32)])
        pcs.append(pc.reshape(-1).astype(np.float32))
        path = z["path"].astype(np.float32)
        for p in (path, path[::-1]):
            goal = p[-1]
            for i in range(len(p) - 1):
                samples.append((pi, p[i], goal, p[i + 1]))
    pcs = np.stack(pcs)
    pidx = np.array([s[0] for s in samples], np.int32)
    cur = np.stack([s[1] for s in samples])
    goal = np.stack([s[2] for s in samples])
    nxt = np.stack([s[3] for s in samples])
    return pcs, pidx, cur, goal, nxt


def init_networks(d: int, device=None):
    """The JAX tool's initial encoder and planner: `init_mlp` from key 7
    split once, on `device`."""
    from vamp_mvt_tpu_torch.sampling import threefry

    k1, k2 = threefry.split(threefry.prng_key(7, device))
    enc = mpnet.init_mlp(k1, (mpnet.MAX_POINTCLOUD_SIZE * 3,) + mpnet.ENCODER_WIDTHS)
    pla = mpnet.init_mlp(k2, (mpnet.LATENT + 2 * d,) + mpnet.PLANNER_WIDTHS + (d,))
    return enc, pla


def state_dict(mlp: mpnet.MLP) -> dict:
    """An `nn.Sequential`-style state dict: layer i's Linear as
    `fc.{2i}.weight/bias`, the PReLU after it (every layer but the last) as
    `fc.{2i+1}.weight`."""
    sd = {}
    last = len(mlp.linears) - 1
    for i, (lin, act) in enumerate(zip(mlp.linears, mlp.prelus)):
        sd[f"fc.{2 * i}.weight"] = lin.weight.detach().cpu().clone()
        sd[f"fc.{2 * i}.bias"] = lin.bias.detach().cpu().clone()
        if i < last:
            sd[f"fc.{2 * i + 1}.weight"] = act.weight.detach().cpu().clone()
    return sd


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data", default="/tmp/mpnet_dataset")
    ap.add_argument("--out", default="/tmp/mpnet_ckpt")
    ap.add_argument("--robot", default="panda")
    ap.add_argument("--epochs", type=int, default=400)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--device", default=None, help="default: the GPU")
    return ap.parse_args(argv)


def main(argv=None, device=None) -> dict:
    """Prints what the JAX tool prints; returns {"clouds", "pairs", "epochs",
    "batch", "lr", "steps", "losses" ({epoch: mean loss} of the printed
    epochs), "step_ms" (the
    median host wall of a step, its loss read back), "train_s", "encoder",
    "planner" (the checkpoint paths)}."""
    from vamp_mvt_tpu_torch.device import resolve_device
    from vamp_mvt_tpu_torch.robots import registry

    args = parse_args(argv)
    dev = resolve_device(args.device if device is None else device)
    spec = registry.load(args.robot)
    pcs, pidx, cur, goal, nxt = load_dataset(args.data, spec.dimension)
    print(f"dataset: {len(pcs)} clouds, {len(cur)} waypoint pairs")

    enc, pla = init_networks(spec.dimension, dev)
    opt = torch.optim.Adam([*enc.parameters(), *pla.parameters()], lr=args.lr)
    t = lambda a: torch.as_tensor(a, device=dev)
    pcs_t, pidx_t, cur_t, goal_t, nxt_t = map(t, (pcs, pidx.astype(np.int64), cur, goal, nxt))

    def loss_fn(idx):
        lat = mpnet.mlp_apply(enc.params(), pcs_t[pidx_t[idx]])
        inp = torch.cat([lat, cur_t[idx], goal_t[idx]], dim=-1)
        pred = mpnet.mlp_apply(pla.params(), inp)
        return torch.mean((pred - nxt_t[idx]) ** 2)

    N = len(cur)
    rng = np.random.default_rng(1)
    losses, step_s = {}, []
    t_train = time.perf_counter()
    for ep in range(args.epochs):
        order = rng.permutation(N)
        tot = 0.0
        nb = 0
        for off in range(0, N - args.batch + 1, args.batch):
            t0 = time.perf_counter()
            idx = t(order[off : off + args.batch])
            opt.zero_grad(set_to_none=True)
            loss = loss_fn(idx)
            loss.backward()
            opt.step()
            tot += float(loss.detach())
            step_s.append(time.perf_counter() - t0)
            nb += 1
        if ep % 50 == 0 or ep == args.epochs - 1:
            losses[ep] = tot / max(nb, 1)
            print(f"epoch {ep:4d}  loss {losses[ep]:.5f}", flush=True)
    train_s = time.perf_counter() - t_train

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, net in (("encoder", enc), ("planner", pla)):
        paths[name] = str(out / f"{name}.pt")
        torch.save(state_dict(net), paths[name])
    print(f"saved to {out}")
    return {"clouds": len(pcs), "pairs": N, "epochs": args.epochs, "batch": args.batch,
            "lr": args.lr, "steps": len(step_s), "losses": losses,
            "step_ms": float(np.median(step_s)) * 1e3 if step_s else None,
            "train_s": train_s, "device": str(dev), **paths}


if __name__ == "__main__":
    main()
