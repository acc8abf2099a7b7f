"""Kernel-resident pointcloud structure: radius-class bitmaps + point chunks.

Port of `vamp_mvt_tpu/collision/pc_kernel.py` (host-side numpy build; the
arrays are bit-identical to the JAX package's).  The form the fused FK +
collision kernels read (`csrc/fkcc_device.cuh`, pointcloud branch):

1. Certain-free and certain-hit bitmaps, one word table per robot
   sphere-radius class (robots have 4-12 distinct radii).  Voxel grid of
   W <= 31 cells a side over the workspace; word (vx * W + vy), bit vz.
   A free-half bit is 1 ("maybe") iff some point lies within class_radius +
   point_radius + cell_half_diagonal of the voxel centre, so a sphere of that
   class centred anywhere in a 0-bit voxel cannot collide; a hit-half bit is
   1 iff some point lies within class_radius + point_radius -
   cell_half_diagonal, so every centre in the voxel collides.
2. The points sorted by voxel key, in chunks of CS = 32 with bounding
   spheres; a chunk row is x[32], y[32], z[32].  Spheres the bitmap cannot
   decide scan the chunks whose bound reaches them.
3. meta: workspace min xyz, 1 / cell, W, point radius, live chunks.

The JAX package's `supers` (a dead one-row dummy) and `radii` fields are
left out: no kernel reads them; `radius_classes` recomputes the classes.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from vamp_mvt_tpu_torch import native

MAX_CLASSES = 12     # radius classes (>= max distinct radii of shipped robots)
W_MAX = 31           # z bits must fit an int32 word
CS = 32              # points per chunk


class PCKernelData(NamedTuple):
    """Dense arrays of one problem's cloud (numpy from the build, tensors in
    an Environment, with any leading batch dims)."""

    bitmap: object   # (2 * MAX_CLASSES * RROWS, 128) int32: free half, then hit half
    chunks: object   # (NCH, 8) float32: bound centre xyz, radius, pad
    points: object   # (NCH, 3 * CS) float32: x[CS], y[CS], z[CS]; padding 1e8
    meta: object     # (1, 8) float32: wsx, wsy, wsz, inv_scale, W, r_point, live chunks, 0


def radius_classes(sphere_radii: np.ndarray) -> np.ndarray:
    """Upper radius per class; sphere k's class is the index of the smallest
    class radius >= its radius."""
    uniq = np.unique(np.asarray(sphere_radii, np.float32))
    if len(uniq) > MAX_CLASSES:
        # bucket: keep the largest MAX_CLASSES quantile edges (conservative)
        idx = np.linspace(0, len(uniq) - 1, MAX_CLASSES).round().astype(int)
        uniq = np.maximum.reduceat(uniq, np.r_[0, idx[1:]])
        uniq = np.unique(uniq)
    out = np.full(MAX_CLASSES, uniq[-1], np.float32)
    out[: len(uniq)] = uniq
    return out


def sphere_class(radius: float, class_radii: np.ndarray) -> int:
    return int(np.argmax(np.asarray(class_radii) >= radius - 1e-7))


def sphere_table(sphere_radii: np.ndarray) -> np.ndarray:
    """(S, 4) float32 per robot sphere: radius, class, chit_ok, gate_ok.

    chit_ok = 1 iff the radius reaches its class radius (the class's
    certain-hit bits were built with the class radius, so a smaller sphere
    may not hit where they say); gate_ok = 1 iff the radius is at most the
    largest class radius (otherwise the certain-free bits prove nothing and
    the sphere always takes the exact scan).  Port of
    `fkcc_pallas._sphere_table`."""
    radii = np.asarray(sphere_radii, np.float32)
    cls_radii = radius_classes(radii)
    tab = np.zeros((len(radii), 4), np.float32)
    for k, r in enumerate(radii):
        r = float(r)
        c = sphere_class(r, cls_radii)
        tab[k] = (r, c, 1.0 if r >= float(cls_radii[c]) - 1e-6 else 0.0,
                  1.0 if r <= float(cls_radii[-1]) + 1e-7 else 0.0)
    return tab


def attachment_table(radii, robot_radii: np.ndarray):
    """(..., A) payload radii (a float32 tensor) -> (..., A, 4) float32 rows
    of the same form as `sphere_table`, for the pointcloud branch's spheres
    S..S+A-1: the robot's radius classes, the class index argmax(cr >= r -
    1e-7), chit_ok = r >= cr[class] - 1e-6 and gate_ok = r <= cr[-1] + 1e-7,
    all in float32 as fkcc_pallas.py:692-706 computes them.  A payload above
    every class radius takes class 0 with gate_ok = 0: it always takes the
    exact scan."""
    cr = torch.as_tensor(radius_classes(robot_radii), device=radii.device)
    cls = torch.argmax((cr >= radii[..., None] - 1e-7).to(torch.int32), dim=-1)
    chit = (radii >= cr[cls] - 1e-6).to(torch.float32)
    gate = (radii <= cr[-1] + 1e-7).to(torch.float32)
    return torch.stack([radii, cls.to(torch.float32), chit, gate], dim=-1)


def _voxel_distances(points, wmin, cell, W, win, use_native):
    """(W, W, W) distance from each voxel centre to the nearest point, exact
    up to win * cell and +inf (native) or exact (scipy) beyond."""
    if use_native:
        return np.sqrt(native.voxel_mindist2(points, wmin, cell, W, win), dtype=np.float32)
    from scipy.spatial import cKDTree

    axes = [wmin[i] + (np.arange(W, dtype=np.float64) + 0.5) * cell for i in range(3)]
    centers = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, 3)
    return cKDTree(points).query(centers, workers=-1)[0].reshape(W, W, W)


def build_pc_kernel(points, class_radii, workspace_min, workspace_max,
                    point_radius: float, max_radius: float, pad_chunks: int | None = None,
                    use_native: bool = True) -> PCKernelData:
    """Build the structure of one cloud (pc_kernel.build_pc_kernel)."""
    points = np.asarray(points, dtype=np.float32).reshape(-1, 3)
    wmin = np.asarray(workspace_min, dtype=np.float32)
    wmax = np.asarray(workspace_max, dtype=np.float32)
    ww = float(wmax[0] - wmin[0])
    W = max(min(int(np.floor(ww / max(max_radius, 1e-6))), W_MAX), 1)
    cell = ww / W
    inv_scale = W / ww
    half_diag = cell * np.sqrt(3.0) / 2.0

    RROWS = (W * W + 127) // 128
    words = np.zeros((2 * MAX_CLASSES, RROWS * 128), np.uint32)

    if len(points):
        # the largest radius ever thresholded; the native windowed scan is
        # exact up to win * cell > Rmax
        Rmax = float(np.max(class_radii)) + point_radius + half_diag
        win = int(np.floor(Rmax / cell)) + 1
        dist = _voxel_distances(points, wmin, cell, W, win, use_native)
        zshift = np.arange(W, dtype=np.uint32)
        for c, rho in enumerate(np.asarray(class_radii, np.float32)):
            marked = dist <= rho + point_radius + half_diag
            words[c, : W * W] = np.bitwise_or.reduce(
                marked.astype(np.uint32) << zshift[None, None, :], axis=2).reshape(-1)
            hit = dist <= rho + point_radius - half_diag
            words[MAX_CLASSES + c, : W * W] = np.bitwise_or.reduce(
                hit.astype(np.uint32) << zshift[None, None, :], axis=2).reshape(-1)

    # point chunks: sort by voxel key, group CS, bounding spheres
    if len(points):
        vox = np.clip(np.floor((points - wmin[None]) * inv_scale).astype(np.int64), 0, W - 1)
        key = (vox[:, 0] * W + vox[:, 1]) * W + vox[:, 2]
        spts = points[np.argsort(key, kind="stable")]
    else:
        spts = points
    n = len(spts)
    nch = max((n + CS - 1) // CS, 1)
    if pad_chunks is not None:
        nch = max(nch, pad_chunks)
    FAR = np.float32(1e8)
    pts_pad = np.full((nch * CS, 3), FAR, np.float32)
    pts_pad[:n] = spts
    grp = pts_pad.reshape(nch, CS, 3)
    # bound over real points only; empty / padded chunks get a far bound
    realmask = (np.arange(nch * CS) < n).reshape(nch, CS)
    any_real = realmask.any(axis=1)
    rm3 = realmask[..., None]
    lo = np.where(rm3, grp, np.inf).min(axis=1)
    hi = np.where(rm3, grp, -np.inf).max(axis=1)
    with np.errstate(invalid="ignore"):  # inf + -inf in empty chunks, replaced below
        cc = 0.5 * (lo + hi)
    rr = np.sqrt(np.where(realmask, ((grp - cc[:, None]) ** 2).sum(-1), 0.0).max(axis=1))
    chunks = np.zeros((nch, 8), np.float32)
    chunks[:, :3] = np.where(any_real[:, None], cc, FAR)
    chunks[:, 3] = np.where(any_real, rr, 0.0)

    meta = np.zeros((1, 8), np.float32)
    meta[0, :3] = wmin
    meta[0, 3] = inv_scale
    meta[0, 4] = W
    meta[0, 5] = point_radius
    meta[0, 6] = (n + CS - 1) // CS
    return PCKernelData(
        bitmap=words.astype(np.int32).reshape(2 * MAX_CLASSES * RROWS, 128),
        chunks=chunks,
        points=np.concatenate([grp[:, :, 0], grp[:, :, 1], grp[:, :, 2]], axis=1),
        meta=meta,
    )
