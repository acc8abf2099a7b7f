"""Obstacles, written out plainly, and the signed value of a configuration.

A problem is a MotionBenchMaker scene dict: spheres (position, radius),
cylinders (position, Euler XYZ, radius, length) and boxes (position, Euler
XYZ, half extents).  As VAMP's `problem_dict_to_vamp` does, a cylinder is a
capsule, except in the "box" scenario, where it is the cuboid around it.

Every value is a squared distance less a squared radius sum (m^2): negative
means contact.  `vmin` takes the least over every collision sphere against
every obstacle and over the self-collision pairs; a configuration is valid
where it is >= 0.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# elements of the largest (states, spheres, obstacles or points) intermediate
CHUNK_ELEMS = 1 << 26


def euler_xyz(e) -> np.ndarray:
    """Euler XYZ (rho, theta, phi) -> R = Rz(phi) Ry(theta) Rx(rho)."""
    rho, theta, phi = (float(v) for v in e)
    cx, sx = math.cos(rho), math.sin(rho)
    cy, sy = math.cos(theta), math.sin(theta)
    cz, sz = math.cos(phi), math.sin(phi)
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return rz @ ry @ rx


def obstacles(problem: dict, pad: float = 0.0, spheres: bool = True) -> dict:
    """One problem's obstacles as float64 rows: spheres (n, 4) centre and
    radius; capsules (n, 7) end a, end b, radius; boxes (n, 15) centre, the
    three axes, half extents.  `pad` grows every obstacle by that much;
    `spheres=False` leaves the spheres out (a cloud never samples them)."""
    sph, cap, box = [], [], []
    if spheres:
        for o in problem["sphere"]:
            sph.append([*o["position"], o["radius"] + pad])
    for o in problem["cylinder"]:
        R = euler_xyz(o["orientation_euler_xyz"])
        c = np.asarray(o["position"], float)
        if problem["problem"] == "box":
            h = [o["radius"] + pad, o["radius"] + pad, o["length"] / 2 + pad]
            box.append([*c, *R[:, 0], *R[:, 1], *R[:, 2], *h])
        else:
            half = R[:, 2] * (o["length"] / 2)
            cap.append([*(c + half), *(c - half), o["radius"] + pad])
    for o in problem["box"]:
        R = euler_xyz(o["orientation_euler_xyz"])
        h = [v + pad for v in o["half_extents"]]
        box.append([*o["position"], *R[:, 0], *R[:, 1], *R[:, 2], *h])
    as_rows = lambda rows, w: np.asarray(rows, np.float64).reshape(-1, w)
    return {"spheres": as_rows(sph, 4), "capsules": as_rows(cap, 7), "boxes": as_rows(box, 15)}


# Rows that touch nothing: far away and of radius (or extent) zero, in
# numbers that bfloat16 holds exactly (a capsule's ends stay apart).
_FAR = {"spheres": [64.0, 64.0, 64.0, 0.0],
        "capsules": [64.0, 64.0, 64.0, 64.0, 64.0, 65.0, 0.0],
        "boxes": [64.0, 64.0, 64.0, 1, 0, 0, 0, 1, 0, 0, 0, 1, 0.0, 0.0, 0.0]}


def stack(obs: list[dict], dtype, device) -> dict:
    """Per-problem obstacle rows -> tensors (B, n_max, w), padded with rows
    that touch nothing."""
    out = {}
    for kind, far in _FAR.items():
        n = max([len(o[kind]) for o in obs] + [1])
        arr = np.tile(np.asarray(far, np.float64), (len(obs), n, 1))
        for i, o in enumerate(obs):
            arr[i, :len(o[kind])] = o[kind]
        out[kind] = torch.as_tensor(arr, dtype=dtype, device=device)
    return out


def env_vmin(tabs: dict, c: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Sphere centres c (M, S, 3), radii r (S,), against the obstacle rows of
    each state's own problem, tabs[kind] (M, n, w) -> (M,)."""
    p = c[:, :, None, :]                                      # (M, S, 1, 3)
    rr = r[None, :, None]
    s = tabs["spheres"][:, None]                              # (M, 1, n, 4)
    d = p - s[..., :3]
    out = ((d * d).sum(-1) - (rr + s[..., 3]) ** 2).amin((-2, -1))
    k = tabs["capsules"][:, None]
    a, b = k[..., 0:3], k[..., 3:6]
    ab = b - a
    t = (((p - a) * ab).sum(-1) / (ab * ab).sum(-1)).clamp(0.0, 1.0)
    d = p - (a + t[..., None] * ab)
    out = torch.minimum(out, ((d * d).sum(-1) - (rr + k[..., 6]) ** 2).amin((-2, -1)))
    x = tabs["boxes"][:, None]
    rel = p - x[..., 0:3]
    e = torch.stack([(rel * x[..., 3 + 3 * i:6 + 3 * i]).sum(-1).abs() - x[..., 12 + i]
                     for i in range(3)], -1).clamp_min(0.0)
    return torch.minimum(out, ((e * e).sum(-1) - rr * rr).amin((-2, -1)))


def cloud_vmin(points: torch.Tensor, c: torch.Tensor, r: torch.Tensor,
               point_radius: float) -> torch.Tensor:
    """Sphere centres c (M, S, 3), radii r (S,), against one cloud's points
    (P, 3) of radius point_radius -> (M,)."""
    M, S = c.shape[:2]
    if points.shape[0] == 0:
        return torch.full((M,), float("inf"), dtype=c.dtype, device=c.device)
    rr = (r + point_radius) ** 2
    step = max(CHUNK_ELEMS // max(S * points.shape[0], 1), 1)
    parts = []
    for i in range(0, M, step):
        d = c[i:i + step, :, None, :] - points
        parts.append(((d * d).sum(-1).amin(-1) - rr).amin(-1))
    return torch.cat(parts)


def vmin(robot, rtabs: dict, q: torch.Tensor, env=None, env_rows=None, cloud=None,
         point_radius: float = 0.0) -> torch.Tensor:
    """q (M, d) -> (M,) least signed value over self-collision and either
    the obstacle rows `env` (tensors (B, n, w)) of problem env_rows[m]
    (M,) or one `cloud` (P, 3); computed in q's dtype, in chunks."""
    M = q.shape[0]
    n_obs = sum(t.shape[1] for t in env.values()) if env is not None else 1
    S = rtabs["radius"].shape[0]
    step = max(CHUNK_ELEMS // (max(S * n_obs, len(rtabs["pairs"])) * 3), 1)
    out = []
    for i in range(0, M, step):
        qi = q[i:i + step]
        c = robot.spheres(qi, rtabs)
        v = robot.self_vmin(c, rtabs)
        if env is not None:
            rows = env_rows[i:i + step]
            v = torch.minimum(v, env_vmin({k: t[rows] for k, t in env.items()}, c,
                                          rtabs["radius"]))
        if cloud is not None:
            v = torch.minimum(v, cloud_vmin(cloud, c, rtabs["radius"], point_radius))
        out.append(v)
    return torch.cat(out) if out else torch.zeros(0, dtype=q.dtype, device=q.device)
