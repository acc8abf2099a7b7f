"""MVT: Multi-level Voxel Table pointcloud collision structure.

Port of `vamp_mvt_tpu/collision/mvt.py`.  The build is host-side numpy (the
arrays are bit-identical to the JAX package's); the query is plain PyTorch.
A uniform voxel grid with cell ~= the max query radius, so a query sphere's
window is at most 3^3 voxels (reference mvt.hh:221-232, the grid query radius
clamped to one cell):

  grid (W^3,) int32: voxel slot or -1
  voxel_points (Nv, C, 3): per-voxel points, padded with +inf
  voxel_count (Nv,), voxel_aabb (Nv, 6): tight per-voxel AABBs
  meta (12,): ws_min(3), inv_scale, W, global_min(3), global_max(3), r_point

A query evaluates all 27 window voxels with masked gathers; a sphere hits
iff some point has d^2 <= (r + r_point)^2 (mvt.hh:205-276).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

MAX_GRID_WIDTH = 100  # reference mvt.hh MAX_GRID_WIDTH upper bound


class MVTData(NamedTuple):
    """Dense MVT arrays (numpy from the build, tensors in an Environment,
    with any leading batch dims)."""

    grid: object          # (W*W*W,) int32 voxel slot or -1
    voxel_points: object  # (Nv, C, 3) float32, padded with +inf
    voxel_count: object   # (Nv,) int32
    voxel_aabb: object    # (Nv, 6) float32: min xyz, max xyz
    meta: object          # (12,) float32


def build_mvt(points, min_radius: float, max_radius: float, workspace_min, workspace_max,
              point_radius: float, pad_voxels: int | None = None,
              pad_capacity: int | None = None) -> MVTData:
    """Host-side build (the reference builds on the CPU too, mvt.hh:147-171);
    pad_voxels / pad_capacity pad to common shapes for batching."""
    points = np.asarray(points, dtype=np.float32).reshape(-1, 3)
    wmin = np.asarray(workspace_min, dtype=np.float32)
    wmax = np.asarray(workspace_max, dtype=np.float32)

    ww = float(wmax[0] - wmin[0])  # x-width only, as the reference
    W = max(int(min(int(np.floor(ww / max_radius)), MAX_GRID_WIDTH)), 1)
    inv_scale = W / ww

    if len(points):
        v = np.clip(((points - wmin) * inv_scale).astype(np.int32), 0, W - 1)
        key = (v[:, 0] * W + v[:, 1]) * W + v[:, 2]
        order = np.argsort(key, kind="stable")
        spts = points[order]
        uniq, starts, counts = np.unique(key[order], return_index=True, return_counts=True)
        gmin = points.min(axis=0)
        gmax = points.max(axis=0)
    else:
        uniq = np.zeros(0, np.int64)
        starts = counts = np.zeros(0, np.int64)
        spts = points
        gmin = np.full(3, np.float32(np.finfo(np.float32).max))
        gmax = np.full(3, np.float32(np.finfo(np.float32).min))

    nv = len(uniq)
    C = int(counts.max()) if nv else 1
    if pad_capacity is not None:
        C = max(C, pad_capacity)
    NV = max(nv, 1)
    if pad_voxels is not None:
        NV = max(NV, pad_voxels)

    grid = np.full(W * W * W, -1, dtype=np.int32)
    grid[uniq] = np.arange(nv, dtype=np.int32)
    vp = np.full((NV, C, 3), np.float32(np.inf))
    vc = np.zeros(NV, np.int32)
    va = np.zeros((NV, 6), np.float32)
    va[:, :3] = np.float32(np.finfo(np.float32).max)
    va[:, 3:] = np.float32(np.finfo(np.float32).min)
    for i in range(nv):
        pts = spts[starts[i] : starts[i] + counts[i]]
        vp[i, : len(pts)] = pts
        vc[i] = len(pts)
        va[i, :3] = pts.min(axis=0)
        va[i, 3:] = pts.max(axis=0)

    meta = np.array([*wmin, inv_scale, float(W), *gmin, *gmax, point_radius], dtype=np.float32)
    return MVTData(grid=grid, voxel_points=vp, voxel_count=vc, voxel_aabb=va, meta=meta)


def empty_mvt() -> MVTData:
    """The MVT of an empty cloud."""
    return build_mvt(np.zeros((0, 3)), 0.01, 1.0, [0, 0, 0], [1, 1, 1], 0.0025)


def batch_index(lead: tuple, qshape: tuple, device) -> torch.Tensor:
    """(qshape) int64: the row of a structure's flattened leading dims `lead`
    that serves each query, `lead` aligned with the query's first dims."""
    idx = torch.arange(math.prod(lead), device=device)
    idx = idx.reshape(tuple(lead) + (1,) * (len(qshape) - len(lead)))
    return idx.expand(qshape)


def rows(t: torch.Tensor, core: int) -> torch.Tensor:
    """A structure field with its leading dims flattened into one."""
    k = t.dim() - core
    return t.reshape((math.prod(t.shape[:k]),) + tuple(t.shape[k:]))


def sum3(v: torch.Tensor) -> torch.Tensor:
    """x^2 + y^2 + z^2 of the last dim, summed left to right."""
    return (v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]) + v[..., 2] * v[..., 2]


def mvt_collides(mvt: MVTData, p: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Query spheres (..., 3) with radii (...) -> (...) bool collision.  The
    structure's leading dims broadcast against the query's first dims."""
    lead = tuple(mvt.meta.shape[:-1])
    bi = batch_index(lead, tuple(p.shape[:-1]), p.device)
    m = rows(mvt.meta, 1)[bi]                       # (..., 12)
    grid, vpts = rows(mvt.grid, 1), rows(mvt.voxel_points, 3)
    vcnt, vaabb = rows(mvt.voxel_count, 1), rows(mvt.voxel_aabb, 2)
    G, C = grid.shape[1], vpts.shape[2]
    ws_min, inv_scale, W = m[..., 0:3], m[..., 3], m[..., 4].to(torch.int32)
    gmin, gmax = m[..., 5:8], m[..., 8:11]
    qr = r + m[..., 11]

    inside = ((p + qr[..., None] >= gmin).all(-1) & (p - qr[..., None] <= gmax).all(-1))
    gqr = torch.clamp_max(qr * inv_scale, 1.0)
    gc = (p - ws_min) * inv_scale[..., None]
    wf = (W - 1).to(torch.float32)
    lo = torch.clamp_min(gc - gqr[..., None], 0.0).to(torch.int32)
    hi = torch.minimum(wf[..., None], gc + gqr[..., None]).to(torch.int32)

    qr2 = qr * qr
    hit = torch.zeros(p.shape[:-1], dtype=torch.bool, device=p.device)
    kk = torch.arange(C, device=p.device)
    for dx in range(3):
        for dy in range(3):
            for dz in range(3):
                vx, vy, vz = lo[..., 0] + dx, lo[..., 1] + dy, lo[..., 2] + dz
                in_win = (vx <= hi[..., 0]) & (vy <= hi[..., 1]) & (vz <= hi[..., 2])
                cell = torch.clamp((vx * W + vy) * W + vz, 0, G - 1).long()
                slot = grid[bi, cell]
                occupied = slot >= 0
                slot = torch.clamp_min(slot, 0).long()
                aabb = vaabb[bi, slot]                                  # (..., 6)
                near = ((p + qr[..., None] >= aabb[..., :3]).all(-1)
                        & (p - qr[..., None] <= aabb[..., 3:]).all(-1))
                # only live queries not yet hit read the voxel's points
                sel = (in_win & occupied & near & inside & ~hit).nonzero(as_tuple=True)
                pts = vpts[bi[sel], slot[sel]]                          # (n, C, 3)
                cnt = vcnt[bi[sel], slot[sel]]
                d2 = sum3(pts - p[sel][:, None, :])
                kmask = kk < cnt[:, None]
                hit[sel] = (kmask & (d2 <= qr2[sel][:, None])).any(-1)
    return hit
