"""The robot, written out plainly: forward kinematics to collision spheres.

A frozen copy of the Panda's table (`panda.json`: frames, collision spheres,
self-collision pairs, joint limits, motion resolution), read with the json
module alone.  `Robot.spheres(q)` poses every collision sphere with one 3 x 3
matrix product a frame, in the dtype of `q` (float64 for the reference,
bfloat16 for its control).
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

REVOLUTE, PRISMATIC = 1, 2
HERE = Path(__file__).resolve().parent


class Robot:
    def __init__(self, table: dict):
        self.name = table["name"]
        self.dimension = int(table["dimension"])
        self.resolution = int(table["resolution"])
        self.frames = table["frames"]
        self.sphere_frame = table["sphere_frame"]
        self.sphere_local = table["sphere_local"]
        self.sphere_radius = table["sphere_radius"]
        self.pairs = table["self_collision_pairs"]
        self.low = table["limits_low"]
        self.high = table["limits_high"]

    def tensors(self, dtype, device):
        """The constant tables as tensors of `dtype` on `device`."""
        t = lambda x: torch.tensor(x, dtype=dtype, device=device)
        pairs = torch.tensor(self.pairs, dtype=torch.long, device=device).reshape(-1, 2)
        return {
            "rot": [t(f["origin_rot"]).reshape(3, 3) for f in self.frames],
            "xyz": [t(f["origin_xyz"]) for f in self.frames],
            "axis": [t(f["axis"]) for f in self.frames],
            "local": t(self.sphere_local).reshape(-1, 3),
            "radius": t(self.sphere_radius),
            "frame": torch.tensor(self.sphere_frame, dtype=torch.long, device=device),
            "pairs": pairs,
        }

    def spheres(self, q: torch.Tensor, tabs: dict) -> torch.Tensor:
        """q (M, d) -> sphere centres (M, S, 3) in q's dtype."""
        M = q.shape[0]
        eye = torch.eye(3, dtype=q.dtype, device=q.device)
        Rs, ts = [], []
        for i, f in enumerate(self.frames):
            if f["parent"] < 0:
                R = tabs["rot"][i].expand(M, 3, 3)
                t = tabs["xyz"][i].expand(M, 3)
            else:
                Rp, tp = Rs[f["parent"]], ts[f["parent"]]
                R = Rp @ tabs["rot"][i]
                t = (Rp @ tabs["xyz"][i]) + tp
            if f["joint_type"] == REVOLUTE:
                x = q[:, f["q_index"]]
                k = tabs["axis"][i]
                K = torch.zeros(3, 3, dtype=q.dtype, device=q.device)
                K[0, 1], K[0, 2], K[1, 2] = -k[2], k[1], -k[0]
                K = K - K.T
                c, s = torch.cos(x)[:, None, None], torch.sin(x)[:, None, None]
                R = R @ (c * eye + s * K + (1 - c) * torch.outer(k, k))
            elif f["joint_type"] == PRISMATIC:
                t = t + (R @ tabs["axis"][i]) * q[:, f["q_index"], None]
            Rs.append(R)
            ts.append(t)
        R = torch.stack(Rs, 1)[:, tabs["frame"]]          # (M, S, 3, 3)
        t = torch.stack(ts, 1)[:, tabs["frame"]]          # (M, S, 3)
        return (R @ tabs["local"][..., None])[..., 0] + t

    def self_vmin(self, centers: torch.Tensor, tabs: dict) -> torch.Tensor:
        """(M, S, 3) -> (M,) min over the pair table of d^2 - (ri + rj)^2."""
        i, j = tabs["pairs"][:, 0], tabs["pairs"][:, 1]
        d = centers[:, i] - centers[:, j]
        rs = tabs["radius"][i] + tabs["radius"][j]
        return ((d * d).sum(-1) - rs * rs).amin(-1)


def load(name: str) -> Robot:
    with open(HERE / f"{name}.json") as f:
        return Robot(json.load(f))
