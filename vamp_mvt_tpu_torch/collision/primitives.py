"""Signed collision values for sphere-vs-primitive tests, batched and dense.

Port of `vamp_mvt_tpu/collision/primitives.py`.  Each function returns a
signed squared-distance-like value; collision iff the value is strictly
negative.  Shape tables are (..., N, fields), query spheres are centers
(..., S, 3) with radii broadcastable to (..., S); outputs are (..., S, N).

Every sum is written out term by term in the order the fused CUDA kernel
(`csrc/fkcc.cu`) and the Pallas kernel use, so the plain version and the
kernel round alike.
"""

from __future__ import annotations

import torch


def _sq(x):
    return x * x


def sphere_sphere(spheres: torch.Tensor, p: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """(..., Ns, 4) x (..., S, 3) -> (..., S, Ns). Reference sphere_sphere.hh:10-23."""
    c = spheres[..., None, :, :]  # (..., 1, Ns, 4)
    px, py, pz = p[..., :, None, 0], p[..., :, None, 1], p[..., :, None, 2]
    d2 = _sq(px - c[..., 0]) + _sq(py - c[..., 1]) + _sq(pz - c[..., 2])
    rs = r[..., :, None] + c[..., 3]
    return d2 - rs * rs


def sphere_capsule(capsules: torch.Tensor, p: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """(..., Nc, 8) x (..., S, 3) -> (..., S, Nc). Reference sphere_capsule.hh:8-23."""
    c = capsules[..., None, :, :]
    px, py, pz = p[..., :, None, 0], p[..., :, None, 1], p[..., :, None, 2]
    dot = (px - c[..., 0]) * c[..., 3] + (py - c[..., 1]) * c[..., 4] + (
        pz - c[..., 2]
    ) * c[..., 5]
    t = torch.clamp(dot * c[..., 7], 0.0, 1.0)
    d2 = (
        _sq(px - (c[..., 0] + c[..., 3] * t))
        + _sq(py - (c[..., 1] + c[..., 4] * t))
        + _sq(pz - (c[..., 2] + c[..., 5] * t))
    )
    rs = r[..., :, None] + c[..., 6]
    return d2 - rs * rs


def sphere_z_capsule(capsules: torch.Tensor, p: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Z-aligned specialization (reference sphere_capsule.hh:31-47)."""
    c = capsules[..., None, :, :]
    px, py, pz = p[..., :, None, 0], p[..., :, None, 1], p[..., :, None, 2]
    t = torch.clamp((pz - c[..., 2]) * c[..., 5] * c[..., 7], 0.0, 1.0)
    d2 = _sq(px - c[..., 0]) + _sq(py - c[..., 1]) + _sq(pz - (c[..., 2] + c[..., 5] * t))
    rs = r[..., :, None] + c[..., 6]
    return d2 - rs * rs


def sphere_cuboid(cuboids: torch.Tensor, p: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """(..., Nb, 15) x (..., S, 3) -> (..., S, Nb). Reference sphere_cuboid.hh:8-27."""
    c = cuboids[..., None, :, :]
    xs = p[..., :, None, 0] - c[..., 0]
    ys = p[..., :, None, 1] - c[..., 1]
    zs = p[..., :, None, 2] - c[..., 2]
    a1 = torch.clamp_min(
        torch.abs(c[..., 3] * xs + c[..., 4] * ys + c[..., 5] * zs) - c[..., 12], 0.0
    )
    a2 = torch.clamp_min(
        torch.abs(c[..., 6] * xs + c[..., 7] * ys + c[..., 8] * zs) - c[..., 13], 0.0
    )
    a3 = torch.clamp_min(
        torch.abs(c[..., 9] * xs + c[..., 10] * ys + c[..., 11] * zs) - c[..., 14], 0.0
    )
    return a1 * a1 + a2 * a2 + a3 * a3 - _sq(r[..., :, None])


def sphere_z_cuboid(cuboids: torch.Tensor, p: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Z-aligned specialization (reference sphere_cuboid.hh:35-52)."""
    c = cuboids[..., None, :, :]
    xs = p[..., :, None, 0] - c[..., 0]
    ys = p[..., :, None, 1] - c[..., 1]
    zs = p[..., :, None, 2] - c[..., 2]
    a1 = torch.clamp_min(torch.abs(c[..., 3] * xs + c[..., 4] * ys) - c[..., 12], 0.0)
    a2 = torch.clamp_min(torch.abs(c[..., 6] * xs + c[..., 7] * ys) - c[..., 13], 0.0)
    a3 = torch.clamp_min(torch.abs(zs) - c[..., 14], 0.0)
    return a1 * a1 + a2 * a2 + a3 * a3 - _sq(r[..., :, None])
