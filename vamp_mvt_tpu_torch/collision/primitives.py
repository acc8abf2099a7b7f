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

import math

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


def sphere_heightfield(hf_meta: torch.Tensor, hf_data: torch.Tensor, p: torch.Tensor,
                       r: torch.Tensor) -> torch.Tensor:
    """(..., Nh, 10) + (..., Nh, C) x (..., S, 3) -> (..., S, Nh).
    Reference sphere_heightfield.hh:8-30: map world xy to a grid cell, gather
    its height, compare the sphere's bottom against it.

    The flat cell index clips to C - 1, C = hf_data.shape[-1] (the table's
    padded width), as the JAX package's XLA path does: a sphere past the
    footprint's far row reads the table's last cell.  The JAX Pallas kernel
    clips to its own 128-wide padded rows instead and reads a zero there;
    the port follows the XLA rule in its plain version and in its kernel."""
    m = hf_meta[..., None, :, :]  # (..., 1, Nh, 10)
    zh = _gather_heights(hf_data, heightfield_cells(hf_meta, hf_data.shape[-1], p))
    zhs = m[..., 5] * zh + m[..., 2]
    return p[..., :, None, 2] - r[..., :, None] - zhs


def heightfield_cells(hf_meta: torch.Tensor, C: int, p: torch.Tensor) -> torch.Tensor:
    """(..., Nh, 10) x (..., S, 3) -> (..., S, Nh) int32: the flat cell index
    under each sphere centre in each field of C cells (sphere_heightfield's
    index rule)."""
    m = hf_meta[..., None, :, :]  # (..., 1, Nh, 10)
    xo = m[..., 0] - p[..., :, None, 0]
    yo = m[..., 1] - p[..., :, None, 1]
    cx = torch.floor(torch.minimum(torch.clamp_min(m[..., 3] * xo + m[..., 8], 0.0), m[..., 6]))
    cy = torch.floor(torch.minimum(torch.clamp_min(m[..., 4] * yo + m[..., 9], 0.0), m[..., 7]))
    idx = (cy * m[..., 6] + cx).to(torch.int32)
    return torch.clamp(idx, 0, C - 1)


def heightfield_cell_band(hf_meta: torch.Tensor, p: torch.Tensor, band: float) -> torch.Tensor:
    """(..., Nh, 10) x (..., S, 3) -> (...) bool: some sphere centre lies
    within `band` of a cell edge of some field, in float64.  There `floor`
    of a value one ulp from an integer picks either cell, so a kernel and
    the plain version may read neighbouring heights."""
    m = hf_meta.double()[..., None, :, :]
    c = p.double()[..., :, None, :]
    u = m[..., 3] * (m[..., 0] - c[..., 0]) + m[..., 8]
    v = m[..., 4] * (m[..., 1] - c[..., 1]) + m[..., 9]
    near = ((u - u.round()).abs() < band) | ((v - v.round()).abs() < band)
    return near.flatten(-2).any(-1)


def _gather_heights(hf_data: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """hf_data (L..., Nh, C), idx (..., S, Nh) int -> (..., S, Nh): the height
    of cell idx of field n of the table row that serves each query, the
    table's leading dims aligned with (broadcast against) the query's."""
    nh, C = hf_data.shape[-2], hf_data.shape[-1]
    lead = tuple(hf_data.shape[:-2])
    row = torch.arange(math.prod(lead), device=idx.device).reshape(
        lead + (1,) * (idx.dim() - len(lead)))
    flat = (row * nh + torch.arange(nh, device=idx.device)) * C + idx.long()
    return hf_data.reshape(-1)[flat]
